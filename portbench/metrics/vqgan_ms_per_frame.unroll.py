"""Device ms a frame of the VQGAN (sgam_neurips22_tpu_torch/models/vqgan/:
convolutions, GroupNorm, attention, the codeword search), by the Python
frames behind each launch, over a traced session. Moves frames_per_s."""

LAYER = (r"sgam_neurips22_tpu_torch/models/vqgan/",)


def read(ctx):
    return ctx.layer_ms_per_unit(LAYER)
