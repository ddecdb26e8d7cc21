# Frozen copy of sgam_neurips22_tpu_torch/geometry/codec.py at commit e4e59b7, kept as the
# benchmark's plain reference: imports point into portbench.reference, and
# the hand kernels are replaced by the plain PyTorch versions of plain_ops.
"""Per-dataset depth <-> scaled-inverse-disparity codecs — port of
`sgam_neurips22_tpu/geometry/codec.py`. Masked pixels encode to -2."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from portbench.reference.dtypes import div_scalar


@dataclass(frozen=True)
class DepthCodec:
    """disparity = 2 * ((1/(d + shift) - inv_hi) / (inv_lo - inv_hi)) - 1"""

    name: str
    shift: float
    inv_lo: float  # 1/(near+shift): disparity=+1 end
    inv_hi: float  # 1/(far+shift): disparity=-1 end
    depth_range: tuple[float, float]
    clip_eps: float | None = None  # clamp depth from below before inverting

    def encode(self, depth: torch.Tensor) -> torch.Tensor:
        d = depth
        if self.clip_eps is not None:
            d = torch.clamp(d, min=self.clip_eps)
        inv = 1.0 / (d + self.shift)
        return 2.0 * div_scalar(inv - self.inv_hi, self.inv_lo - self.inv_hi) - 1.0

    def encode_masked(self, depth: torch.Tensor, extrapolation_mask: torch.Tensor) -> torch.Tensor:
        return torch.where(extrapolation_mask, -2.0, self.encode(depth))

    def decode(self, disparity: torch.Tensor) -> torch.Tensor:
        unit = (disparity + 1.0) / 2.0
        inv = unit * (self.inv_lo - self.inv_hi) + self.inv_hi
        return 1.0 / inv - self.shift


CODECS = {
    "clevr-infinite": DepthCodec(
        name="clevr-infinite", shift=0.0, inv_lo=1.0 / 7.0, inv_hi=1.0 / 16.0,
        depth_range=(7.0, 16.0), clip_eps=1e-7,
    ),
    "google_earth": DepthCodec(
        name="google_earth", shift=10.0, inv_lo=1.0 / 10.099975586,
        inv_hi=1.0 / 14.765625, depth_range=(0.099975586, 4.765625),
    ),
    "kitti360": DepthCodec(
        name="kitti360", shift=0.0, inv_lo=1.0 / 3.0, inv_hi=1.0 / 75.0,
        depth_range=(3.0, 75.0),
    ),
}

CLEVR_CODEC, GOOGLE_EARTH_CODEC, KITTI360_CODEC = CODECS["clevr-infinite"], CODECS["google_earth"], CODECS["kitti360"]


def get_codec(dataset: str) -> DepthCodec:
    if dataset not in CODECS:
        raise KeyError(f"no depth codec for dataset {dataset!r}")
    return CODECS[dataset]
