"""The system under test, built from a configuration file: the port's
public classes, with the benchmark's weights loaded into them. The only
module of the benchmark that imports the port; the model configuration
is filled the same way for the port's classes and for the reference's
copies of them, whose fields are the same.
"""
from __future__ import annotations

import contextlib

import torch


def vq_config(cfg: dict, autoencoder, model, compute_dtype: str, flash):
    """`model.VQModelConfig` of the configuration, with `autoencoder.DDConfig`."""
    dd = autoencoder.DDConfig(
        ch=cfg["ch"], out_ch=cfg["out_ch"], ch_mult=tuple(cfg["ch_mult"]), num_res_blocks=cfg["num_res_blocks"],
        attn_resolutions=tuple(cfg["attn_resolutions"]), in_channels=cfg["in_channels"],
        resolution=cfg["resolution"], z_channels=cfg["z_channels"], compute_dtype=compute_dtype,
        flash_attention=flash)
    return model.VQModelConfig(ddconfig=dd, n_embed=cfg["n_embed"], embed_dim=cfg["embed_dim"], phase=cfg["phase"],
                               use_extrapolation_mask=cfg["use_extrapolation_mask"],
                               vq_step_threshold=cfg["vq_step_threshold"], dataset=cfg["dataset"],
                               depth_range=tuple(cfg["depth_range"]))


def loss_config(cfg: dict, losses):
    return losses.LossConfig(disc_start=cfg["disc_start"], disc_weight=cfg["disc_weight"],
                             codebook_weight=cfg["codebook_weight"], perceptual_weight=cfg["perceptual_weight"],
                             disc_in_channels=cfg["disc_in_channels"],
                             use_discriminative_loss=cfg["use_discriminative_loss"])


def vq_model(cfg: dict, state: dict, device):
    """The port's VQModel in the configuration's compute dtype, holding `state`."""
    from sgam_neurips22_tpu_torch.models.vqgan import autoencoder, model

    with torch.device("meta"):
        m = model.VQModel(vq_config(cfg, autoencoder, model, cfg["compute_dtype"], cfg["flash_attention"]))
    m = m.to_empty(device=device)
    m.load_state_dict(state)
    return m.eval()


def generator(cfg: dict, traffic: dict, model, seeds: list, device):
    """The port's InfiniteSceneGeneration for the traffic's trajectory and conditioning."""
    from sgam_neurips22_tpu_torch.pipeline.scene_generation import InfiniteSceneGeneration, SceneGenConfig

    h, w = cfg["image_resolution"]
    gcfg = SceneGenConfig(dataset=cfg["dataset"], output_dim=tuple(traffic["grid"]), num_src=cfg["num_src"],
                          topk=traffic["topk"], order=traffic["order"], image_resolution=(h, w),
                          collision=traffic.get("collision", "nearest"), splat_stride=traffic.get("splat_stride", 1),
                          use_rgbd_integration=traffic["conditioning"] == "map",
                          requery_method=traffic.get("requery_method", "splat"), tsdf_voxel_size=cfg["voxel_size"],
                          tsdf_pool_capacity=cfg.get("pool_capacity"))
    return InfiniteSceneGeneration(model, gcfg, seeds=seeds, device=device)


def train_state(cfg: dict, vq: dict, disc: dict, lpips: dict, device):
    """(the port's TrainState holding the given weights, its LPIPS, its TrainConfig)."""
    from sgam_neurips22_tpu_torch.models.vqgan import autoencoder, model
    from sgam_neurips22_tpu_torch.training import losses
    from sgam_neurips22_tpu_torch.training.lpips import LPIPS
    from sgam_neurips22_tpu_torch.training.train_step import TrainConfig, create_train_state

    tcfg = TrainConfig(model=vq_config(cfg, autoencoder, model, cfg["compute_dtype"], cfg["flash_attention"]),
                       loss=loss_config(cfg, losses), learning_rate=cfg["learning_rate"])
    state = create_train_state(tcfg, device=device)
    with torch.no_grad():
        state.model.load_state_dict(vq)
        state.disc.load_state_dict(disc)
    with torch.device("meta"):
        lp = LPIPS()
    lp = lp.to_empty(device=device)
    lp.load_state_dict(lpips)
    return state, lp.requires_grad_(False), tcfg


def train_step(state, batch: dict, lpips, tcfg) -> dict:
    from sgam_neurips22_tpu_torch.training.train_step import train_step as step

    return step(state, batch, lpips, tcfg)[1]


@contextlib.contextmanager
def generator_loss_wrapped(wrap):
    """Planted faults only: the port's training step calls `wrap` of its
    autoencoder loss in its place while the context is open."""
    from sgam_neurips22_tpu_torch.training import train_step as ts

    original = ts.generator_loss
    ts.generator_loss = wrap(original)
    try:
        yield
    finally:
        ts.generator_loss = original
