"""Shared pieces of the PyTorch-port tests: the TINY model on both sides and
the weight carry-over from a JAX parameter tree into the port."""
import jax
import numpy as np
import torch

from sgam_neurips22_tpu.models import DDConfig, VQModelConfig, init_vqmodel
from sgam_neurips22_tpu_torch.core.state_dict import from_jax_params, load_into
from sgam_neurips22_tpu_torch.models.vqgan import autoencoder as t_ae
from sgam_neurips22_tpu_torch.models.vqgan import model as t_model

# the TINY model of tests/test_pipeline.py
TINY = VQModelConfig(
    ddconfig=DDConfig(
        ch=32, out_ch=4, ch_mult=(1, 2), num_res_blocks=1,
        attn_resolutions=(8,), resolution=16, z_channels=32, in_channels=4,
    ),
    n_embed=32,
    embed_dim=16,
    phase="conditional_generation",
    dataset="clevr-infinite",
    depth_range=(7.0, 16.0),
)
H = W = 32
TINY_K = np.array([[20.0, 0, (W - 1) / 2], [0, 20.0, (H - 1) / 2], [0, 0, 1]])


def port_config(cfg: VQModelConfig) -> t_model.VQModelConfig:
    dd = cfg.ddconfig
    return t_model.VQModelConfig(
        ddconfig=t_ae.DDConfig(
            ch=dd.ch, out_ch=dd.out_ch, ch_mult=tuple(dd.ch_mult),
            num_res_blocks=dd.num_res_blocks,
            attn_resolutions=tuple(dd.attn_resolutions),
            in_channels=dd.in_channels, resolution=dd.resolution,
            z_channels=dd.z_channels, remat=dd.remat, compute_dtype=dd.compute_dtype,
        ),
        n_embed=cfg.n_embed, embed_dim=cfg.embed_dim, phase=cfg.phase, beta=cfg.beta,
        dataset=cfg.dataset, depth_range=cfg.depth_range,
    )


def to_numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_model(params, cfg: VQModelConfig) -> t_model.VQModel:
    """The port's VQModel (CPU, eval) carrying the JAX parameters."""
    model = t_model.VQModel(port_config(cfg))
    load_into(model, from_jax_params(to_numpy_tree(params)))
    return model.eval()


def tiny_jax_params():
    return init_vqmodel(jax.random.PRNGKey(0), TINY)


def make_seed():
    """The seed frame of tests/test_pipeline.py."""
    rng = np.random.default_rng(5)
    rgb = rng.uniform(-1, 1, (H, W, 3)).astype(np.float32)
    depth = rng.uniform(8, 14, (H, W)).astype(np.float32)
    return rgb, depth


def t(x):
    """numpy / JAX array -> CPU torch tensor."""
    return torch.as_tensor(np.asarray(x))


def port_train_config(cfg):
    """The port's TrainConfig for a JAX TrainConfig (no k-means, no
    accumulation, constant LR)."""
    import dataclasses

    from sgam_neurips22_tpu_torch.training.losses import LossConfig
    from sgam_neurips22_tpu_torch.training.train_step import TrainConfig

    return TrainConfig(
        model=port_config(cfg.model), loss=LossConfig(**dataclasses.asdict(cfg.loss)),
        learning_rate=cfg.learning_rate,
    )


def port_training(jstate, cfg, lpips_params=None):
    """(TrainState on the CPU, LPIPS or None) carrying a JAX train state's
    params, disc_params and disc_state and an init_lpips tree."""
    from sgam_neurips22_tpu_torch.core.state_dict import load_jax_training
    from sgam_neurips22_tpu_torch.training.lpips import LPIPS
    from sgam_neurips22_tpu_torch.training.train_step import create_train_state

    state = create_train_state(port_train_config(cfg), seed=0, device="cpu")
    lp = None if lpips_params is None else LPIPS()
    load_jax_training(
        state.model, state.disc, to_numpy_tree(jstate["params"]), to_numpy_tree(jstate["disc_params"]),
        to_numpy_tree(jstate["disc_state"]), lp, None if lpips_params is None else to_numpy_tree(lpips_params),
    )
    return state, lp


def batch_to_torch(batch):
    return {k: t(v) for k, v in batch.items()}
