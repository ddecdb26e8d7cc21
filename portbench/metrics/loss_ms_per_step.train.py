"""Device ms a training step of the losses and updates
(sgam_neurips22_tpu_torch/training/losses.py, lpips.py, discriminator.py,
and the two Adam updates under train_step.py's _update), forward and
backward, by the Python frames behind each launch. Moves
train_images_per_s."""

LAYER = (r"sgam_neurips22_tpu_torch/training/(losses|lpips|discriminator)\.py",
         r"sgam_neurips22_tpu_torch/training/train_step\.py\(\d+\): _update")


def read(ctx):
    return ctx.layer_ms_per_unit(LAYER)
