"""The benchmark's one traffic generator: every input a run feeds the
program, made on the device from the run's seed and the request's or
step's index, so that one seed gives one sequence of inputs and every seed
the same sizes.

Frozen copies, adapted to draw on the device: the seed frames of
sgam_neurips22_tpu_torch/studies/cases.py `seed_frames` (one random frame
at grid (0, 0), RGB uniform in [-1, 1], depth uniform in the configuration's
seed range) and the conditional training batch of `train_batch` (n_src
sources, identity poses, so that each source lands on its own pixels and
every pixel takes a 2-way collision; depths uniform in (8, 14)), both at
commit e4e59b7.
"""
from __future__ import annotations

import torch

_K = ((355.5555, 0.0, 128.0), (0.0, 355.5555, 128.0), (0.0, 0.0, 1.0))  # train_batch's intrinsics at 256^2


def generator(seed: int, index: int, device) -> torch.Generator:
    """A device generator for input `index` of the run seeded `seed`."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + int(index)) % (1 << 63))


def request_seeds(cfg: dict, traffic: dict, seed: int, index: int, device) -> list:
    """One unroll request: `scenes` seed lists [((0, 0), rgb [H, W, 3], depth [H, W])]."""
    h, w = cfg["image_resolution"]
    lo, hi = cfg["seed_depth_range"]
    u = torch.rand((traffic["scenes"], h, w, 4), generator=generator(seed, index, device), device=device)
    return [[((0, 0), u[s, ..., :3] * 2 - 1, lo + (hi - lo) * u[s, ..., 3])] for s in range(traffic["scenes"])]


def train_batch(cfg: dict, traffic: dict, seed: int, index: int, device) -> dict:
    """Training batch `index`: the conditional phase's inputs at batch `batch`."""
    b, n = traffic["batch"], traffic["n_src"]
    h, w = cfg["image_resolution"]
    g = generator(seed, index, device)
    u = torch.rand((b, n + 1, h, w, 4), generator=g, device=device)
    img, depth = u[..., :3] * 2 - 1, 8.0 + 6.0 * u[..., 3]
    k = torch.tensor(_K, device=device)
    return {
        "dst_img": img[:, 0].contiguous(), "dst_depth": depth[:, 0].contiguous(),
        "src_imgs": img[:, 1:].contiguous(), "src_depths": depth[:, 1:].contiguous(),
        "Ks": k.expand(b, n, 3, 3).contiguous(), "R_rels": torch.eye(3, device=device).expand(b, n, 3, 3).contiguous(),
        "t_rels": torch.zeros((b, n, 3), device=device), "src_masks": torch.ones((b, n), device=device),
    }
