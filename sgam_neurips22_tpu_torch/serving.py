"""The flagship model configurations — port of `flagship_config` in
`sgam_neurips22_tpu/serving.py`."""
from __future__ import annotations

from dataclasses import replace

from sgam_neurips22_tpu_torch.models.vqgan.autoencoder import DDConfig
from sgam_neurips22_tpu_torch.models.vqgan.model import VQModelConfig


def flagship_config(dataset: str = "clevr-infinite", compute_dtype: str = "float32") -> VQModelConfig:
    """Full-size conditional-generation config for either dataset
    (reference configs/conditional_generation/{clevr-infinite,
    google_earth_vqgan}.yaml): ch 128, ch_mult (1,1,2,2,4), attention at
    tracked resolution 16, embed_dim 256; clevr-infinite's codebook of
    16384 and depth range (7, 16), google_earth's codebook of 4096 and
    depth range (0.099975586, 4.765625); activations in `compute_dtype`."""
    dd = DDConfig(
        ch=128, out_ch=4, ch_mult=(1, 1, 2, 2, 4), num_res_blocks=2,
        attn_resolutions=(16,), resolution=64, z_channels=256, in_channels=4,
        compute_dtype=compute_dtype,
    )
    cfg = VQModelConfig(
        ddconfig=dd, n_embed=16384, embed_dim=256,
        phase="conditional_generation", dataset="clevr-infinite", depth_range=(7.0, 16.0),
    )
    if dataset == "google_earth":
        return replace(cfg, n_embed=4096, dataset="google_earth", depth_range=(0.099975586, 4.765625))
    if dataset != "clevr-infinite":
        raise ValueError(f"unknown dataset {dataset!r}")
    return cfg
