"""The PyTorch port's GAN training step on the CPU (plain versions of every
kernel) against the JAX `train_step`, on the JAX training tests' TINY
configuration with flash attention on (tests/test_training.py, the
flash-attention step test: its Pallas kernels run in interpret mode),
weights carried across by the bridge: one and two steps of both phases.
Also the port's rematerialisation against the plain run."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

from sgam_neurips22_tpu.training.lpips import init_lpips
from sgam_neurips22_tpu.training.train_step import TrainConfig, create_train_state, train_step
from sgam_neurips22_tpu_torch.core.state_dict import from_jax_params, load_jax_training
from sgam_neurips22_tpu_torch.models.vqgan import autoencoder as t_ae
from sgam_neurips22_tpu_torch.ops import attention
from sgam_neurips22_tpu_torch.training import train_step as t_train
from test_training import TINY_LOSS, TINY_MODEL, make_cond_batch, make_image_batch
from torch_port_common import batch_to_torch, port_train_config, port_training, to_numpy_tree

FLASH_MODEL = dataclasses.replace(TINY_MODEL, ddconfig=dataclasses.replace(TINY_MODEL.ddconfig, flash_attention=True))
LR = 1e-3


def _cfg(phase):
    return TrainConfig(model=dataclasses.replace(FLASH_MODEL, phase=phase), loss=TINY_LOSS, learning_rate=LR)


def _batch(phase):
    return make_image_batch() if phase == "codebook" else make_cond_batch()


@pytest.fixture(scope="module")
def lpips_params():
    return init_lpips(jax.random.PRNGKey(42))


def _compare_logs(logs, j_logs):
    assert set(logs) == set(j_logs)
    for k in j_logs:
        np.testing.assert_allclose(float(logs[k]), float(j_logs[k]), rtol=1e-4, atol=1e-5, err_msg=k)


NOISE = 1e-6  # a first moment below this everywhere is a gradient that is zero up to f32 noise
# Adam moments, relative to each tensor's largest. Measured worst: 1.0e-5 in
# the codebook phase; 1.3e-3 (conv_in.bias) in the conditional phase, where
# the LPIPS backward amplifies rounding: with perceptual_weight 0 that phase
# agrees within 1.3e-5 too.
MOMENT_TOL = {"codebook": 1e-4, "conditional_generation": 3e-3}


def _adam_moments(opt, params, j_opt_state):
    """{name: (port exp_avg, port exp_avg_sq, JAX mu, JAX nu)}."""
    adam = j_opt_state[0]
    mu, nu = from_jax_params(to_numpy_tree(adam.mu)), from_jax_params(to_numpy_tree(adam.nu))
    return {n: (opt.state[p]["exp_avg"].numpy(), opt.state[p]["exp_avg_sq"].numpy(), mu[n], nu[n]) for n, p in params}


def _compare_params(params, ref, moments, step, tol):
    """Adam moments within `tol` of each tensor's largest magnitude: they are
    running means of the step's gradients, so this holds every gradient to
    the JAX one. Parameters: Adam moves a weight by LR * m / (sqrt(v) +
    1e-8), which f32 noise in m tips wherever m is small, so the elements
    whose |m| is at least 1e-3 of the tensor's largest are held to atol 2e-4
    (a fifth of the LR) and the rest to Adam's own bound, 2 * LR per step.
    A tensor whose gradient is zero up to f32 noise on both sides (all
    |m| < NOISE: a bias that GroupNorm or the softmax cancels, |grad|
    ~1e-8) is held to that bound alone."""
    for name, p in params:
        m, v, j_m, j_v = moments[name]
        if np.abs(j_m).max() < NOISE:
            assert np.abs(m).max() < NOISE, name
            np.testing.assert_allclose(p.detach().numpy(), ref[name], atol=2 * LR * step, rtol=0, err_msg=name)
            continue
        np.testing.assert_allclose(m, j_m, atol=tol * np.abs(j_m).max(), rtol=0, err_msg=name)
        np.testing.assert_allclose(v, j_v, atol=tol * np.abs(j_v).max(), rtol=0, err_msg=name)
        big = np.abs(j_m) >= 1e-3 * np.abs(j_m).max()
        np.testing.assert_allclose(p.detach().numpy()[big], ref[name][big], atol=2e-4, rtol=0, err_msg=name)
        np.testing.assert_allclose(p.detach().numpy(), ref[name], atol=2 * LR * step, rtol=0, err_msg=name)


def _compare_state(state, j_state, phase, before, step):
    """Trainable and discriminator parameters as `_compare_params` states,
    running statistics at atol 1e-5, frozen parameters bit-unchanged."""
    trainable, frozen = t_train.split_params(state.model, phase)
    _compare_params(trainable, from_jax_params(to_numpy_tree(j_state["params"])),
                    _adam_moments(state.opt_ae, trainable, j_state["opt_ae"]), step, MOMENT_TOL[phase])
    for name, p in frozen:
        assert torch.equal(p, before[name]), name
    disc = list(state.disc.named_parameters())
    _compare_params(disc, from_jax_params(to_numpy_tree(j_state["disc_params"])),
                    _adam_moments(state.opt_disc, disc, j_state["opt_disc"]), step, MOMENT_TOL[phase])
    stats = from_jax_params(to_numpy_tree(j_state["disc_state"]))
    assert set(stats) == {n for n, _ in state.disc.named_buffers()}
    for name, b in state.disc.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[name], atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("phase", ["codebook", "conditional_generation"])
def test_two_train_steps_match_jax(phase, lpips_params):
    """Logs of each step at rtol 1e-4, atol 1e-5 (tests/test_training.py's
    flash-vs-naive tolerance), the state after each step as
    `_compare_state` states, and the step counter. The second step starts
    from the JAX weights after the first (copied into the port's
    parameters; its Adam moments stay its own): Adam's normalisation turns
    f32 noise in near-zero gradients into weight differences of up to 2 LR,
    which would otherwise move the second step's gradients by more than
    their rounding."""
    cfg = _cfg(phase)
    j_state = create_train_state(jax.random.PRNGKey(0), cfg)
    state, lp = port_training(j_state, cfg, lpips_params)
    j_state = jax.tree_util.tree_map(lambda x: x.copy(), j_state)  # train_step donates its state
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    batch = _batch(phase)
    tcfg = port_train_config(cfg)
    for step in (1, 2):
        j_state, j_logs = train_step(j_state, batch, lpips_params, cfg)
        state, logs = t_train.train_step(state, batch_to_torch(batch), lp, tcfg)
        _compare_logs(logs, j_logs)
        _compare_state(state, j_state, phase, before, step)
        assert state.step == int(j_state["step"]) == step
        load_jax_training(state.model, state.disc, *(to_numpy_tree(j_state[k]) for k in
                                                     ("params", "disc_params", "disc_state")))
    trainable = [p for _, p in t_train.split_params(state.model, phase)[0]]
    assert all(p.grad is not None for p in trainable)
    assert all(p.grad is None and not p.requires_grad for _, p in t_train.split_params(state.model, phase)[1])


def test_remat_gives_the_same_gradients(monkeypatch):
    """DDConfig.remat: the same loss and gradients as the plain run (the
    same ops, recomputed), with the level attention forwards run twice (5
    attention blocks in TINY, 3 of them inside rematerialised levels) and
    the checkpoint policy saving convolution outputs."""
    calls = {"fwd": 0, "saved_convs": 0}
    fwd, policy = attention.flash_attention_fwd, t_ae._save_convolutions

    def counted_fwd(*a):
        calls["fwd"] += 1
        return fwd(*a)

    def counted_policy(ctx, op, *a, **k):
        decision = policy(ctx, op, *a, **k)
        calls["saved_convs"] += decision == CheckpointPolicy.MUST_SAVE
        return decision

    monkeypatch.setattr(attention, "flash_attention_fwd", counted_fwd)
    monkeypatch.setattr(t_ae, "_save_convolutions", counted_policy)
    batch = batch_to_torch(make_image_batch())
    results = {}
    for remat in (False, True):
        model = dataclasses.replace(FLASH_MODEL, ddconfig=dataclasses.replace(FLASH_MODEL.ddconfig, remat=remat))
        cfg = port_train_config(TrainConfig(model=model, loss=TINY_LOSS, learning_rate=LR))
        state = t_train.create_train_state(cfg, seed=3, device="cpu")
        params = [p for _, p in t_train.split_params(state.model, cfg.phase)[0]]
        calls.update(fwd=0, saved_convs=0)
        x, x_dst, mask = t_train.model_inputs(batch, cfg)
        loss, _, _, _ = t_train._ae_loss(state.model, state.disc, None, x, x_dst, mask, 0, cfg)
        forward_calls = calls["fwd"]
        grads = torch.autograd.grad(loss, params)
        results[remat] = (loss, grads, forward_calls, dict(calls))
    plain, remat = results[False], results[True]
    assert torch.equal(plain[0], remat[0])
    for a, b in zip(plain[1], remat[1]):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-7)
    assert plain[2] == remat[2] == plain[3]["fwd"] == 5
    assert remat[3]["fwd"] == 5 + 3
    assert plain[3]["saved_convs"] == 0 and remat[3]["saved_convs"] > 0
