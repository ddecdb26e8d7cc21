"""Device ms a frame of the map (sgam_neurips22_tpu_torch/mapping/tsdf.py:
integrate with its grid accumulation, the pool splat render; and
geometry/warp.py's warp of the sources through the rendered depth), by the
Python frames behind each launch. Moves frames_per_s."""

LAYER = (r"sgam_neurips22_tpu_torch/mapping/tsdf\.py", r"sgam_neurips22_tpu_torch/geometry/warp\.py")


def read(ctx):
    return ctx.layer_ms_per_unit(LAYER)
