"""The PyTorch port's training losses on the CPU against the JAX package:
the PatchGAN discriminator, LPIPS, `generator_loss` / `discriminator_loss`,
the autoencoder gradients of one step and `eval_step`, on the JAX training
tests' TINY configuration (tests/test_training.py, flash attention on),
weights carried across by the bridge."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgam_neurips22_tpu.training.discriminator import apply_discriminator, init_discriminator
from sgam_neurips22_tpu.training.losses import discriminator_loss as j_discriminator_loss
from sgam_neurips22_tpu.training.losses import generator_loss as j_generator_loss
from sgam_neurips22_tpu.training.lpips import init_lpips, lpips
from sgam_neurips22_tpu.training.train_step import (
    TrainConfig,
    _ae_loss_fn,
    create_train_state,
    eval_step,
    split_params,
)
from sgam_neurips22_tpu_torch.core.state_dict import from_jax_params, load_into
from sgam_neurips22_tpu_torch.training import losses as t_losses
from sgam_neurips22_tpu_torch.training import train_step as t_train
from sgam_neurips22_tpu_torch.training.discriminator import NLayerDiscriminator
from sgam_neurips22_tpu_torch.training.lpips import LPIPS, random_lpips
from test_training import TINY_LOSS, TINY_MODEL, make_image_batch
from torch_port_common import batch_to_torch, port_train_config, port_training, t, to_numpy_tree

FLASH_MODEL = dataclasses.replace(TINY_MODEL, ddconfig=dataclasses.replace(TINY_MODEL.ddconfig, flash_attention=True))
CFG = TrainConfig(model=FLASH_MODEL, loss=TINY_LOSS, learning_rate=1e-3)


@pytest.fixture(scope="module")
def lpips_params():
    return init_lpips(jax.random.PRNGKey(42))


def _disc(cfg):
    params, state = init_discriminator(jax.random.PRNGKey(3), cfg.disc_config)
    disc = NLayerDiscriminator(t_losses.LossConfig(**dataclasses.asdict(cfg)).disc_config)
    load_into(disc, {**from_jax_params(to_numpy_tree(params)), **from_jax_params(to_numpy_tree(state))})
    return params, state, disc.train()


def _stats(disc):
    return {k: v.clone() for k, v in disc.named_buffers()}


def _assert_stats(disc, j_state, atol=1e-6):
    ref = from_jax_params(to_numpy_tree(j_state))
    assert set(ref) == set(_stats(disc))
    for k, v in disc.named_buffers():
        np.testing.assert_allclose(v.numpy(), ref[k], atol=atol, rtol=0, err_msg=k)


def _lpips(params):
    lp = LPIPS()
    load_into(lp, from_jax_params(to_numpy_tree(params)))
    return lp


def test_discriminator_matches_jax():
    """Patch logits in train mode (batch statistics) and the running
    statistics that call leaves, then eval-mode logits (running
    statistics), at atol 1e-5."""
    params, state, disc = _disc(TINY_LOSS)
    x = np.random.default_rng(20).uniform(-1, 1, (2, 32, 32, 4)).astype(np.float32)
    j_logits, j_state = apply_discriminator(params, state, jnp.asarray(x), TINY_LOSS.disc_config, train=True)
    with torch.no_grad():
        logits = disc(t(x))
    assert logits.shape == j_logits.shape == (2, 6, 6, 1)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), atol=1e-5, rtol=0)
    _assert_stats(disc, j_state)
    j_eval, _ = apply_discriminator(params, j_state, jnp.asarray(x), TINY_LOSS.disc_config, train=False)
    with torch.no_grad():
        np.testing.assert_allclose(disc.eval()(t(x)).numpy(), np.asarray(j_eval), atol=1e-5, rtol=0)


def test_lpips_matches_jax(lpips_params):
    """Distance per image, [B, 1, 1, 1], at rtol 1e-4; the port's seeded
    random init has the JAX init_lpips shapes."""
    rng = np.random.default_rng(21)
    x, y = (rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    with torch.no_grad():
        d = _lpips(lpips_params)(t(x), t(y))
    ref = np.asarray(lpips(lpips_params, jnp.asarray(x), jnp.asarray(y)))
    assert d.shape == ref.shape == (2, 1, 1, 1)
    np.testing.assert_allclose(d.numpy(), ref, rtol=1e-4, atol=0)
    ref_shapes = {k: v.shape for k, v in from_jax_params(to_numpy_tree(lpips_params)).items()}
    assert {k: tuple(v.shape) for k, v in random_lpips(0).state_dict().items()} == ref_shapes


@pytest.mark.parametrize("disc_loss", ["hinge", "vanilla"])
def test_generator_and_discriminator_loss_match_jax(disc_loss, lpips_params):
    """Every log value of both losses at rtol 1e-4, atol 1e-5
    (tests/test_training.py's), xrec at atol 1e-5; the generator side
    leaves the running statistics as they were, the discriminator side
    moves them as the JAX returned state (real, then fake)."""
    cfg = dataclasses.replace(TINY_LOSS, disc_loss=disc_loss)
    tcfg = t_losses.LossConfig(**dataclasses.asdict(cfg))
    params, state, disc = _disc(cfg)
    rng = np.random.default_rng(22)
    x_dst = rng.uniform(-1, 1, (2, 32, 32, 4)).astype(np.float32)
    h_pre = rng.normal(size=(2, 32, 32, 32)).astype(np.float32)
    w = (0.05 * rng.normal(size=(3, 3, 32, 4))).astype(np.float32)  # HWIO
    b = (0.05 * rng.normal(size=4)).astype(np.float32)
    qloss = np.float32(0.0625)
    j_loss, j_xrec, j_log = jax.jit(j_generator_loss, static_argnames="cfg")(
        jnp.asarray(x_dst), jnp.asarray(h_pre), {"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
        jnp.asarray(qloss), jnp.asarray(0), params, state, lpips_params, cfg=cfg)
    before = _stats(disc)
    loss, xrec, log = t_losses.generator_loss(
        t(x_dst), t(h_pre), t(w.transpose(3, 2, 0, 1)), t(b), t(qloss), 0, disc, _lpips(lpips_params), tcfg)
    assert all(torch.equal(v, before[k]) for k, v in disc.named_buffers())
    np.testing.assert_allclose(xrec.detach().numpy(), np.asarray(j_xrec), atol=1e-5, rtol=0)
    assert set(log) == set(j_log)
    for k in j_log:
        np.testing.assert_allclose(float(log[k]), float(j_log[k]), rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-4, atol=1e-5)

    j_d, j_state, j_dlog = j_discriminator_loss(jnp.asarray(x_dst), j_xrec, jnp.asarray(0), params, state, cfg)
    d_loss, dlog = t_losses.discriminator_loss(t(x_dst), xrec, 0, disc, tcfg)
    np.testing.assert_allclose(float(d_loss), float(j_d), rtol=1e-4, atol=1e-5)
    for k in j_dlog:
        np.testing.assert_allclose(float(dlog[k]), float(j_dlog[k]), rtol=1e-4, atol=1e-5, err_msg=k)
    _assert_stats(disc, j_state, atol=1e-5)


def test_adopt_weight_gates_gan_terms():
    assert float(t_losses.adopt_weight(0.8, 9, 10)) == 0.0
    assert float(t_losses.adopt_weight(0.8, 10, 10)) == pytest.approx(0.8)


def test_ae_gradients_match_jax(lpips_params):
    """Codebook phase (every model parameter trains): the loss and each
    parameter's gradient from the port's autograd against jax.grad of the
    JAX `_ae_loss_fn`, each within 1e-4 of that gradient's largest magnitude
    (tensors whose gradient is zero up to f32 noise, < 1e-6, only need to
    stay that small)."""
    j_state = create_train_state(jax.random.PRNGKey(0), CFG)
    state, lp = port_training(j_state, CFG, lpips_params)
    batch = make_image_batch()
    x = batch["image"]
    trainable, frozen = split_params(j_state["params"], CFG.phase)
    fn = jax.jit(jax.value_and_grad(functools.partial(_ae_loss_fn, cfg=CFG), has_aux=True))
    (j_loss, _), j_grads = fn(trainable, frozen, j_state["disc_params"], j_state["disc_state"], lpips_params,
                              x, x, None, jnp.asarray(0))
    ref = from_jax_params(to_numpy_tree(j_grads))
    tcfg = port_train_config(CFG)
    xt = t(x)
    loss, _, _, _ = t_train._ae_loss(state.model, state.disc, lp, xt, xt, None, 0, tcfg)
    names, params = zip(*t_train.split_params(state.model, tcfg.phase)[0])
    grads = torch.autograd.grad(loss, params)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    assert set(names) == set(ref)
    for name, g in zip(names, grads):
        scale = np.abs(ref[name]).max()
        if scale < 1e-6:
            assert float(g.abs().max()) < 1e-6, name
            continue
        np.testing.assert_allclose(g.numpy(), ref[name], atol=1e-4 * scale, rtol=0, err_msg=name)


def test_eval_step_matches_jax(lpips_params):
    """Every val/ log at rtol 1e-4, atol 1e-5, indices equal; the state
    (weights and running statistics) unchanged."""
    j_state = create_train_state(jax.random.PRNGKey(1), CFG)
    state, lp = port_training(j_state, CFG, lpips_params)
    before = {k: v.clone() for k, v in [*state.model.state_dict().items(), *state.disc.state_dict().items()]}
    batch = make_image_batch()
    j_logs = eval_step(j_state, batch, lpips_params, CFG)
    logs = t_train.eval_step(state, batch_to_torch(batch), lp, port_train_config(CFG))
    assert set(logs) == set(j_logs)
    np.testing.assert_array_equal(logs.pop("val/indices").numpy(), np.asarray(j_logs.pop("val/indices")))
    for k in j_logs:
        np.testing.assert_allclose(float(logs[k]), float(j_logs[k]), rtol=1e-4, atol=1e-5, err_msg=k)
    after = [*state.model.state_dict().items(), *state.disc.state_dict().items()]
    assert all(torch.equal(v, before[k]) for k, v in after)
    assert state.step == 0


@pytest.mark.parametrize("option", [
    {"online_kmeans": t_train.OnlineKMeansConfig(do_online_kmeans_clustering=True)}, {"accumulate_grad_batches": 2},
    {"lr_scheduler": t_train.SchedulerConfig()},
])
def test_unported_options_raise(option):
    """The three options that raised until the trainer slice ported them
    (online k-means, gradient accumulation, the LR scheduler) now build
    their state; tests/test_torch_port_trainer.py holds each against JAX.
    A phase that is neither of the two still raises."""
    cfg = dataclasses.replace(port_train_config(CFG), **option)
    state = t_train.create_train_state(cfg, device="cpu")
    assert (state.kmeans is not None) == ("online_kmeans" in option)
    assert (state.accumulators is not None) == ("accumulate_grad_batches" in option)
    bad = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, phase="decoding"))
    with pytest.raises(ValueError, match="phase"):
        t_train.create_train_state(bad, device="cpu")
