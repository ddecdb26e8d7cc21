"""Device ms a frame of the splat conditioning (sgam_neurips22_tpu_torch/
models/conditioning.py over geometry/splat.py and its z-buffer merge), by
the Python frames behind each launch. Moves frames_per_s. Under map
re-query the conditioning only joins the map's render: there it reads the
concatenation alone, and the map's own metric carries the work."""

LAYER = (r"sgam_neurips22_tpu_torch/geometry/splat\.py",)


def read(ctx):
    return ctx.layer_ms_per_unit(LAYER)
