"""Device ms a training step of the VQGAN (sgam_neurips22_tpu_torch/
models/vqgan/, forward, and backward through the frames of the forward op
that recorded each backward node), over a traced session. Moves
train_images_per_s."""

LAYER = (r"sgam_neurips22_tpu_torch/models/vqgan/",)


def read(ctx):
    return ctx.layer_ms_per_unit(LAYER)
