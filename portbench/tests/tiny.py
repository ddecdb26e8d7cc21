"""Tiny versions of the cells for CPU tests: the configurations at a width
and image size a test run can hold, the traffic cut to 2 scenes or 2 images."""
import torch

from portbench import run

TINY = dict(ch=32, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[16], resolution=32, z_channels=32,
            embed_dim=32, n_embed=64, image_resolution=[32, 32])
CELLS = ("clevr.unroll_splat.b8", "clevr.train.b16", "google_earth.unroll_map.b8")
SEED = 2**31 + 11  # past 32 signed bits, as a check's seeds may be


def spec(workload: str, dtype: str = "float32") -> dict:
    s = run.load_spec(workload)
    s["config"].update(TINY, compute_dtype=dtype)
    if "map" in workload:  # a coarser map: the 0.01 voxel sizes a volume of GBs
        s["config"].update(voxel_size=0.05, sdf_trunc=0.15)
    if s["traffic"]["kind"] == "unroll":
        s["traffic"].update(scenes=2, grid=[3, 3] if "splat" in workload else [4, 1])
    else:
        s["traffic"].update(batch=2)
    return s


def cpu_run(workload: str, fault=None, dtype: str = "float32", seconds: float = 0.2) -> dict:
    torch.set_num_threads(2)
    return run.run(spec(workload, dtype), SEED, seconds, False, torch.device("cpu"), fault)
