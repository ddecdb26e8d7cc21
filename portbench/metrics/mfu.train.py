"""The whole training step's share of the card's bf16 peak: the model
FLOPs of a step (forward and backward of the VQGAN, LPIPS and the
discriminator with no recompute, counted on the frozen reference,
portbench/work.py) times the steps the measured window ran, over its
seconds and 989 TFLOP/s. Moves train_images_per_s."""


def read(ctx):
    return ctx.mfu_pct()
