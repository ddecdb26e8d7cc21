"""The hand attention backward's (csrc/flash_attention_dq.cu with
flash_attention_dkv.cu) share of its roofline over a traced session of
training steps: the calls' summed bound, each the larger of 8 B S^2 C
FLOPs (no recompute) over 989 TFLOP/s and its bytes over 3.35 TB/s, over
the summed device time of both kernels. Moves train_images_per_s."""


def read(ctx):
    return ctx.roofline("flash_bwd")
