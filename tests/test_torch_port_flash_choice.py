"""The port chooses its attention path as the JAX package does: by
`DDConfig.flash_attention` or the caller's override, never by the tensor's
batch. On the TINY configs, against JAX (its flash path: the Pallas kernel
in interpret mode):

- `DDConfig.from_dict` keeps the field; every training YAML asks for flash;
- the forward at batch 2 with the field unset takes the plain path and
  matches JAX's plain path; with it true, JAX's flash path;
- at batch 1 with flash on, the forward and the autoencoder loss's
  gradients match JAX's with `flash_attention=True`;
- the callers: a batch-1 training step under a flash config launches the
  flash forward and backward in every attention block; the batch-1 unroll,
  the one-scene batched unroll and the inference step run plain whatever
  the model's config says; the batched unroll at S >= 2 runs flash.
"""
import dataclasses
import functools
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgam_neurips22_tpu.models import forward as j_forward
from sgam_neurips22_tpu.training.lpips import init_lpips
from sgam_neurips22_tpu.training.train_step import TrainConfig, _ae_loss_fn, create_train_state, split_params
from sgam_neurips22_tpu_torch import serving as t_serving
from sgam_neurips22_tpu_torch.core.config import load_configs
from sgam_neurips22_tpu_torch.core.state_dict import from_jax_params
from sgam_neurips22_tpu_torch.models.vqgan.autoencoder import DDConfig
from sgam_neurips22_tpu_torch.models.vqgan.model import VQModelConfig
from sgam_neurips22_tpu_torch.ops import attention
from sgam_neurips22_tpu_torch.pipeline.scene_generation import InfiniteSceneGeneration, SceneGenConfig
from sgam_neurips22_tpu_torch.training import train_step as t_train
from test_training import TINY_LOSS, TINY_MODEL, make_cond_batch, make_image_batch
from torch_port_common import (
    TINY,
    TINY_K,
    H,
    W,
    batch_to_torch,
    make_seed,
    port_config,
    port_model,
    port_train_config,
    port_training,
    t,
    tiny_jax_params,
    to_numpy_tree,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATTN_BLOCKS = 5  # TINY: one in the encoder's 8x8 level, two mid blocks, two in the decoder's 8x8 level


def _flash(cfg, on):
    return dataclasses.replace(cfg, ddconfig=dataclasses.replace(cfg.ddconfig, flash_attention=on))


@pytest.fixture()
def calls(monkeypatch):
    """Counts of the port's flash forward and backward calls."""
    counts = {"fwd": 0, "bwd": 0}
    fwd, bwd = attention.flash_attention, attention.flash_attention_bwd

    def count_fwd(*a):
        counts["fwd"] += 1
        return fwd(*a)

    def count_bwd(*a):
        counts["bwd"] += 1
        return bwd(*a)

    monkeypatch.setattr(attention, "flash_attention", count_fwd)
    monkeypatch.setattr(attention, "flash_attention_bwd", count_bwd)
    return counts


def test_from_dict_keeps_flash_attention():
    dd = {"ch": 32, "ch_mult": [1, 2], "attn_resolutions": [8]}
    assert DDConfig.from_dict(dd).flash_attention is None
    assert DDConfig.from_dict({**dd, "flash_attention": True}).flash_attention is True
    assert DDConfig.from_dict({**dd, "flash_attention": False}).flash_attention is False
    paths = sorted(glob.glob(os.path.join(REPO, "configs", "*", "*.yaml")))
    assert paths
    for path in paths:
        cfg = load_configs([path])
        model = VQModelConfig.from_config(cfg.model.params.to_plain(), cfg.data.params.to_plain())
        assert model.ddconfig.flash_attention is True, path


@torch.inference_mode()
@pytest.mark.parametrize("flash", [None, True])
def test_forward_at_batch_two_follows_the_config(flash, calls):
    """Batch 2, the field unset (plain on both sides) or true (flash on both
    sides): indices equal, rgb at atol 1e-5."""
    params = tiny_jax_params()
    cfg = _flash(TINY, flash)
    rng = np.random.default_rng(12)
    x = rng.uniform(-1, 1, (2, H, W, 4)).astype(np.float32)
    mask = rng.random((2, H, W, 1)) < 0.3
    res = port_model(params, cfg)(t(x), extrapolation_mask=t(mask), topk=1)
    assert calls["fwd"] == (ATTN_BLOCKS if flash else 0)
    ref = j_forward(params, cfg, jnp.asarray(x), extrapolation_mask=jnp.asarray(mask), topk=1,
                    rng=jax.random.PRNGKey(0))
    np.testing.assert_array_equal(res.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_allclose(res.xrec.numpy(), np.asarray(ref.xrec), atol=1e-5, rtol=0)


def test_batch_one_with_flash_matches_jax(calls):
    """Batch 1 with flash on: the forward (indices equal, rgb at atol 1e-5)
    and the autoencoder loss and each parameter's gradient (within 1e-4 of
    the gradient's largest; a gradient that is f32 noise, < 1e-6, stays
    that small), against JAX with flash_attention=True in interpret mode;
    every attention block runs the flash forward and backward."""
    model_cfg = _flash(TINY_MODEL, True)
    cfg = TrainConfig(model=model_cfg, loss=TINY_LOSS, learning_rate=1e-3)
    j_state = create_train_state(jax.random.PRNGKey(0), cfg)
    lpips_params = init_lpips(jax.random.PRNGKey(42))
    state, lp = port_training(j_state, cfg, lpips_params)
    x = make_image_batch(b=1)["image"]
    with torch.inference_mode():
        res = state.model(t(x))
    ref = j_forward(j_state["params"], model_cfg, x, rng=jax.random.PRNGKey(0))
    np.testing.assert_array_equal(res.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_allclose(res.xrec.numpy(), np.asarray(ref.xrec), atol=1e-5, rtol=0)
    assert calls["fwd"] == ATTN_BLOCKS
    trainable, frozen = split_params(j_state["params"], cfg.phase)
    fn = jax.jit(jax.value_and_grad(functools.partial(_ae_loss_fn, cfg=cfg), has_aux=True))
    (j_loss, _), j_grads = fn(trainable, frozen, j_state["disc_params"], j_state["disc_state"], lpips_params,
                              x, x, None, jnp.asarray(0))
    want = from_jax_params(to_numpy_tree(j_grads))
    tcfg = port_train_config(cfg)
    xt = t(x)
    calls["fwd"] = 0
    loss, _, _, _ = t_train._ae_loss(state.model, state.disc, lp, xt, xt, None, 0, tcfg)
    names, tensors = zip(*t_train.split_params(state.model, tcfg.phase)[0])
    grads = torch.autograd.grad(loss, tensors)
    assert calls == {"fwd": ATTN_BLOCKS, "bwd": ATTN_BLOCKS}
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        scale = np.abs(want[name]).max()
        if scale < 1e-6:
            assert float(g.abs().max()) < 1e-6, name
            continue
        np.testing.assert_allclose(g.numpy(), want[name], atol=1e-4 * scale, rtol=0, err_msg=name)


@pytest.mark.parametrize("flash", [None, True])
def test_train_step_at_batch_one_follows_the_config(flash, calls):
    """The conditional step at local batch 1 launches flash in every block,
    forward and backward, exactly when the config asks for it."""
    cfg = TrainConfig(model=_flash(dataclasses.replace(TINY_MODEL, phase="conditional_generation"), flash),
                      loss=TINY_LOSS, learning_rate=1e-3)
    state = t_train.create_train_state(port_train_config(cfg), seed=0, device="cpu")
    batch = batch_to_torch(make_cond_batch(b=1))
    t_train.train_step(state, batch, None, port_train_config(cfg))
    want = ATTN_BLOCKS if flash else 0
    assert calls == {"fwd": want, "bwd": want}


def test_generation_and_serving_choose_by_scene_count(calls):
    """A model whose config asks for flash: the batch-1 unroll and a
    one-scene batched unroll run plain, as JAX strips the field; two scenes
    run flash in every block of every step; the inference step runs
    plain."""
    params = tiny_jax_params()
    cfg = SceneGenConfig(dataset="clevr-infinite", output_dim=(2, 1), num_src=2, topk=1, image_resolution=(H, W))
    rgb, depth = make_seed()
    seeds = [((0, 0), rgb, depth)]
    gen = InfiniteSceneGeneration(port_model(params, _flash(TINY, True)), cfg, seeds, intrinsics=TINY_K,
                                  device="cpu")
    gen.scene_expansion()
    gen.scene_expansion_batched([seeds])
    assert calls["fwd"] == 0
    gen.scene_expansion_batched([seeds, seeds])
    assert calls["fwd"] == ATTN_BLOCKS * len(gen.build_plan()["tgt"])
    calls["fwd"] = 0
    fn, args = t_serving.build_inference_step(port_config(_flash(TINY, True)), num_src=2, image_size=H, device="cpu")
    assert args[0].cfg.ddconfig.flash_attention is None
    fn(*args)
    assert calls["fwd"] == 0
