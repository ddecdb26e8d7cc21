"""The PyTorch port's bf16 compute mode (`DDConfig.compute_dtype="bfloat16"`)
on the CPU, held against the JAX package in bf16 at the same inputs and
weights: the attention block (plain path at batch 1, flash path at batch
2), the encoder, the decoder, `VQModel.forward`, `flash_attention` with
bf16 inputs (JAX's Pallas kernels in interpret mode), one conditional
training step, and one unroll step at batch 1 and at 2 scenes.

XLA and PyTorch round bf16 at different points of the same f32
computation, so the two bf16 results are two independent roundings of it.
The gates:
- smooth outputs of JAX functions run op by op (`assert_bf16_close`): the
  port's bf16 output within twice the distance of JAX's bf16 output from
  JAX's f32 output at the same inputs, in the mean and in the max
  (measured: 0.9-1.3 times it);
- outputs past the codeword choice, where a near-tied latent picks another
  codeword: the JAX package's own bf16 test (tests/test_vqgan.py), mean
  |d| < 0.05, max < 0.5, codeword index agreement > 0.9;
- the training step (`test_train_step_bf16_matches_jax`) and the unroll
  run jitted in JAX, where XLA keeps f32 between fused bf16 operations, so
  JAX's bf16-vs-f32 distance there understates a bf16 rounding: their
  gates are stated with them. The training step runs at a codebook where
  no latent changes codeword, and a planted fault must fail its gate."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgam_neurips22_tpu.models import forward as j_forward
from sgam_neurips22_tpu.models.vqgan.autoencoder import apply_decoder, apply_encoder
from sgam_neurips22_tpu.models.vqgan.nn import attn_block as j_attn_block
from sgam_neurips22_tpu.ops.attention_pallas import flash_attention as j_flash_attention
from sgam_neurips22_tpu.pipeline.scene_generation import (
    InfiniteSceneGeneration as JGen,
    SceneGenConfig as JCfg,
)
from sgam_neurips22_tpu.training.lpips import init_lpips
from sgam_neurips22_tpu.training.train_step import TrainConfig, create_train_state, train_step
from sgam_neurips22_tpu_torch.core.state_dict import from_jax_params, load_into
from sgam_neurips22_tpu_torch.geometry.codec import get_codec
from sgam_neurips22_tpu_torch.models.vqgan.nn import AttnBlock
from sgam_neurips22_tpu_torch.ops import attention
from sgam_neurips22_tpu_torch.ops.attention import flash_attention
from sgam_neurips22_tpu_torch.pipeline.scene_generation import (
    InfiniteSceneGeneration,
    SceneGenConfig,
)
from sgam_neurips22_tpu_torch.training import train_step as t_train
from test_training import TINY_LOSS, TINY_MODEL, make_cond_batch
from torch_port_common import (
    H,
    TINY,
    TINY_K,
    W,
    batch_to_torch,
    port_model,
    port_train_config,
    port_training,
    t,
    tiny_jax_params,
    to_numpy_tree,
)


def bf16(cfg):
    return dataclasses.replace(cfg, ddconfig=dataclasses.replace(cfg.ddconfig, compute_dtype="bfloat16"))


TINY_BF16 = bf16(TINY)


@pytest.fixture(scope="module")
def jax_params():
    return tiny_jax_params()


def assert_bf16_close(port, jax_bf16, jax_f32, name, factor=2.0):
    """The first gate of the module docstring, on float arrays of one shape."""
    port, jax_bf16, jax_f32 = (np.asarray(a, np.float64) for a in (port, jax_bf16, jax_f32))
    ours, theirs = np.abs(port - jax_bf16), np.abs(jax_bf16 - jax_f32)
    assert theirs.max() > 0, f"{name}: JAX's bf16 run equals its f32 run"
    assert ours.mean() <= factor * theirs.mean(), f"{name}: mean {ours.mean()} > {factor} x {theirs.mean()}"
    assert ours.max() <= factor * theirs.max(), f"{name}: max {ours.max()} > {factor} x {theirs.max()}"


def assert_xrec_close(xrec, jax_xrec, idx, jax_idx):
    """tests/test_vqgan.py::test_bfloat16_compute_mode_close_to_f32's gate."""
    d = np.abs(np.asarray(xrec, np.float64) - np.asarray(jax_xrec, np.float64))
    assert d.mean() < 0.05 and d.max() < 0.5, (d.mean(), d.max())
    assert np.mean(np.asarray(idx) == np.asarray(jax_idx)) > 0.9


def _nchw(x):
    return t(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("batch,flash", [(1, False), (2, True)])
def test_attn_block_bf16_matches_jax(jax_params, batch, flash):
    """The port's AttnBlock takes the plain path at batch 1 and the flash
    path at batch 2, as JAX's attn_block(flash=False / True). In bf16 both
    stay bf16 from input to output."""
    p = jax_params["encoder"]["down"][1]["attn"][0]
    block = AttnBlock(64)
    load_into(block, from_jax_params(to_numpy_tree(p)))
    h = np.random.default_rng(3).normal(size=(batch, 8, 8, 64)).astype(np.float32)
    with torch.inference_mode():
        got = block(_nchw(h).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    j16 = j_attn_block(jnp.asarray(h, jnp.bfloat16), p, flash=flash)
    assert j16.dtype == jnp.bfloat16
    j32 = j_attn_block(jnp.asarray(h), p, flash=flash)
    assert_bf16_close(got.float().permute(0, 2, 3, 1).numpy(), j16.astype(jnp.float32), j32, "attn_block")


@torch.inference_mode()
def test_encoder_decoder_bf16_match_jax(jax_params):
    """Both take f32, run bf16 inside and return f32 (the latent leaves the
    encoder in f32; the decoder goes back to f32 before conv_out)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 32, 32, 4)).astype(np.float32)
    z = rng.normal(size=(2, 16, 16, 32)).astype(np.float32)
    model = port_model(jax_params, TINY_BF16)
    enc = model.encoder(_nchw(x))
    dec = model.decoder(_nchw(z))
    feats = model.decoder.features(_nchw(z))
    assert enc.dtype == dec.dtype == feats.dtype == torch.float32
    for name, got, fn, arg in (("encoder", enc, apply_encoder, x), ("decoder", dec, apply_decoder, z)):
        p = jax_params[name]
        assert_bf16_close(got.permute(0, 2, 3, 1).numpy(), fn(p, TINY_BF16.ddconfig, arg),
                          fn(p, TINY.ddconfig, arg), name)


@torch.inference_mode()
def test_forward_bf16_matches_jax(jax_params):
    """VQModel.forward at bf16: pre-quant latents by the bf16 gate, xrec and
    the codeword indices by the JAX bf16 test's gate, xrec in f32."""
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (2, 32, 32, 4)).astype(np.float32)
    mask = rng.random((2, 32, 32, 1)) < 0.3
    res = port_model(jax_params, TINY_BF16)(t(x), t(mask))
    j16 = j_forward(jax_params, TINY_BF16, jnp.asarray(x), jnp.asarray(mask))
    j32 = j_forward(jax_params, TINY, jnp.asarray(x), jnp.asarray(mask))
    assert res.xrec.dtype == torch.float32 and res.pre_quant.dtype == torch.float32
    assert_bf16_close(res.pre_quant.numpy(), j16.pre_quant, j32.pre_quant, "pre_quant")
    assert_xrec_close(res.xrec.numpy(), j16.xrec, res.indices.numpy(), j16.indices)


def test_flash_attention_bf16_matches_jax():
    """flash_attention on bf16 [2, 40, 64] inputs (the plain version on the
    CPU) against JAX's flash_attention in interpret mode: out in bf16,
    each element within one bf16 ulp (2^-7 relative) of JAX's, as both
    compute in f32 and round once; the gradients, in bf16 like their
    inputs, by the bf16 gate against JAX's f32 run."""
    rng = np.random.default_rng(4)
    q, k, v, g = (rng.normal(size=(2, 40, 64)).astype(np.float32) for _ in range(4))
    tq, tk, tv = (t(a).to(torch.bfloat16).requires_grad_() for a in (q, k, v))
    out = flash_attention(tq, tk, tv)
    grads = torch.autograd.grad(out, (tq, tk, tv), t(g).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16 and all(x.dtype == torch.bfloat16 for x in grads)

    def run(dtype):
        def f(q, k, v):
            return j_flash_attention(q, k, v, block_q=16, block_k=16, interpret=True)

        args = tuple(jnp.asarray(a, dtype) for a in (q, k, v))
        o, vjp = jax.vjp(f, *args)
        return o, vjp(jnp.asarray(g, dtype))

    (j16, jg16), (j32, jg32) = run(jnp.bfloat16), run(jnp.float32)
    assert j16.dtype == jnp.bfloat16 and all(x.dtype == jnp.bfloat16 for x in jg16)
    np.testing.assert_allclose(out.float().detach().numpy(), np.asarray(j16, np.float32), rtol=2**-7, atol=1e-6)
    for name, got, a16, a32 in zip(("dq", "dk", "dv"), grads, jg16, jg32):
        assert_bf16_close(got.float().numpy(), a16.astype(jnp.float32), a32, name)


GRAD_REL_L2_MAX = 0.75  # a gradient zeroed, or off by its own size, reads 1.0


def bf16_grad_failures(port, g16, g32):
    """The trainable tensors whose port gradient fails the bf16 gate of
    test_train_step_bf16_matches_jax, and the median ratio over the others:
    {name: (ratio, distance, norm ratio)}, median."""
    top = max(np.abs(g).max() for g in g32.values())
    norm = np.linalg.norm
    rel = {n: norm(port[n] - g16[n]) / norm(g16[n]) for n in port if np.abs(g32[n]).max() >= 1e-6 * top}
    ratio = {n: d / (norm(g16[n] - g32[n]) / norm(g32[n])) for n, d in rel.items()}
    size = {n: norm(port[n]) / norm(g16[n]) for n in rel}
    bad = {n: (ratio[n], rel[n], size[n]) for n in rel
           if ratio[n] > 2.0 or rel[n] > GRAD_REL_L2_MAX or not 0.5 < size[n] < 2.0}
    bad.update({n: (np.inf, np.abs(g).max() / top) for n, g in port.items()
                if n not in rel and np.abs(g).max() >= 1e-3 * top})
    return bad, float(np.median(list(ratio.values())))


def test_train_step_bf16_matches_jax():
    """One conditional training step with a bf16 model (remat and flash
    attention, as bench.py's train_conditional_bf16), the JAX step jitted
    with its Pallas kernels in interpret mode, from the same state, at
    inputs where bf16 rounding moves no latent to another codeword: the
    codebook (n_embed 512 = the batch's 2 x 16 x 16 latents) is the batch's
    f32 latents, so each latent is its own nearest codeword at distance 0
    and bf16 moves it by about 1% of its length, while the nearest other
    latent lies a third of it away (checked: the port's indices before the
    step are its own rows).

    Logs: |port - JAX bf16| <= 2 |JAX bf16 - JAX f32| + 2^-8 |JAX f32| +
    1e-5, one bf16 rounding of the value beyond twice JAX's own move
    (measured: at most 0.36 of the gate). Gradients (JAX's from its first
    Adam moment, mu = (1 - 0.5) g), per trainable tensor, as the L2
    distance over the L2 norm: bf16 rounding alone moves this step's
    gradients by 13-36% (a median of 22%) between JAX's own bf16 and f32
    steps, and by as much between the port's and JAX's bf16 steps, two
    roundings of one computation. Each tensor's distance from JAX's bf16
    step is held within 2 times JAX's own move and within GRAD_REL_L2_MAX,
    the median of the ratios within 1.5 (measured: at most 1.63, a
    median of 1.12, distances up to 0.40), and its L2 norm within (0.5, 2)
    times that of JAX's bf16 gradient, as chip_smoke.py holds the card's
    (rounding noise adds to a norm; a dropped gradient reads 0). Gradients below 1e-6 of the
    step's largest in JAX's f32 step (the key biases, which the softmax
    cancels) are left out; the port's are held to 1e-3 of the step's
    largest there. A control, the port's step with dV of the
    flash-attention backward zeroed, must fail the gate on each attention
    block's v projection."""
    model = dataclasses.replace(TINY_MODEL, phase="conditional_generation", n_embed=512, ddconfig=dataclasses.replace(
        TINY_MODEL.ddconfig, remat=True, flash_attention=True))
    lp = init_lpips(jax.random.PRNGKey(42))
    batch, tbatch = make_cond_batch(), batch_to_torch(make_cond_batch())
    cfg32 = TrainConfig(model=model, loss=TINY_LOSS, learning_rate=1e-3)
    tcfg32 = port_train_config(cfg32)
    with torch.no_grad():
        x, _, mask = t_train.model_inputs(tbatch, tcfg32)
        latents = port_training(create_train_state(jax.random.PRNGKey(0), cfg32), cfg32)[0].model.encode_prequant(
            x, mask).reshape(-1, model.embed_dim).numpy()
    assert latents.shape[0] == model.n_embed
    runs = {}
    for name, m in (("f32", model), ("bf16", bf16(model))):
        cfg = TrainConfig(model=m, loss=TINY_LOSS, learning_rate=1e-3)
        state = create_train_state(jax.random.PRNGKey(0), cfg)
        state["params"]["quantize"]["embedding"] = jnp.asarray(latents)
        if name == "bf16":
            port_states = [port_training(state, cfg, lp) for _ in range(2)]
            state = jax.tree_util.tree_map(lambda x: x.copy(), state)  # train_step donates its state
        new, logs = train_step(state, batch, lp, cfg)
        mu = from_jax_params(to_numpy_tree(new["opt_ae"][0].mu))
        runs[name] = ({k: float(v) for k, v in logs.items()}, {k: v / 0.5 for k, v in mu.items()})
    tcfg = port_train_config(TrainConfig(model=bf16(model), loss=TINY_LOSS, learning_rate=1e-3))
    assert tcfg.model.ddconfig.compute_dtype == "bfloat16"
    grads = []
    for (port_state, port_lp), fault in zip(port_states, (None, "dv")):
        with torch.no_grad():
            x, _, mask = t_train.model_inputs(tbatch, tcfg)
            idx = t_train.quantize(port_state.model.codebook, port_state.model.encode_prequant(x, mask)).indices
        np.testing.assert_array_equal(idx.reshape(-1).numpy(), np.arange(model.n_embed))
        bwd = attention.flash_attention_bwd
        if fault:
            attention.flash_attention_bwd = lambda *a: (lambda dq, dk, dv: (dq, dk, torch.zeros_like(dv)))(*bwd(*a))
        try:
            _, logs = t_train.train_step(port_state, tbatch, port_lp, tcfg)
        finally:
            attention.flash_attention_bwd = bwd
        grads.append({n: p.grad.numpy() for n, p in t_train.split_params(port_state.model, tcfg.phase)[0]})
        if not fault:
            port_logs = logs
    (l16, g16), (l32, g32) = runs["bf16"], runs["f32"]
    assert set(port_logs) == set(l16)
    for k in l16:
        gate = 2 * abs(l16[k] - l32[k]) + 2**-8 * abs(l32[k]) + 1e-5
        assert abs(float(port_logs[k]) - l16[k]) <= gate, (k, float(port_logs[k]), l16[k], l32[k])
    bad, median = bf16_grad_failures(grads[0], g16, g32)
    assert not bad and median <= 1.5, (bad, median)
    bad, _ = bf16_grad_failures(grads[1], g16, g32)
    v_proj = {n for n in g16 if ".attn" in n and ".v." in n}
    assert len(v_proj) == 4 and v_proj <= set(bad), sorted(bad)


def _unroll_step(jax_params, n_scenes, model_cfg):
    """(port, JAX) frame 1 of a 2x1 grid (one step, 2 source slots) for
    n_scenes scenes: [S, H, W, 3] rgb and [S, H, W] depth."""
    rng = np.random.default_rng(7)
    seeds_batch = [[((0, 0), rng.uniform(-1, 1, (H, W, 3)).astype(np.float32),
                     rng.uniform(8, 14, (H, W)).astype(np.float32))] for _ in range(n_scenes)]
    kw = dict(dataset="clevr-infinite", output_dim=(2, 1), num_src=2, topk=1, image_resolution=(H, W))
    gen = InfiniteSceneGeneration(port_model(jax_params, model_cfg), SceneGenConfig(**kw), seeds_batch[0],
                                  intrinsics=TINY_K, device="cpu")
    jgen = JGen(jax_params, model_cfg, JCfg(**kw), seeds=seeds_batch[0], intrinsics=TINY_K)
    if n_scenes == 1:
        port, ref = gen.scene_expansion(), jgen.scene_expansion(jax.random.PRNGKey(0))
        port, ref = [x[None] for x in port], [np.asarray(x)[None] for x in ref]
    else:
        port = gen.scene_expansion_batched(seeds_batch)
        ref = [np.asarray(x) for x in jgen.scene_expansion_batched(seeds_batch, jax.random.PRNGKey(0))]
    return [x[:, 1].numpy() for x in port], [x[:, 1] for x in ref]


@pytest.mark.parametrize("n_scenes", [1, 2])
def test_unroll_step_bf16_matches_jax(jax_params, n_scenes):
    """One bf16 unroll step (plain attention at batch 1, flash at 2 scenes;
    JAX takes its naive attention off the TPU at both): the frame's rgb
    and disparity (in [-1, 1]) by the JAX bf16 test's gate on xrec, and
    both are bf16 results: they differ from the f32 step's."""
    (rgb, depth), (j_rgb, j_depth) = _unroll_step(jax_params, n_scenes, TINY_BF16)
    (f_rgb, f_depth), _ = _unroll_step(jax_params, n_scenes, TINY)
    disparity = [get_codec("clevr-infinite").encode(torch.as_tensor(d)).numpy() for d in (depth, j_depth, f_depth)]
    for got, want, f32 in ((rgb, j_rgb, f_rgb), disparity):
        d = np.abs(got - want)
        assert d.mean() < 0.05 and d.max() < 0.5, (d.mean(), d.max())
        assert not np.array_equal(got, f32)
