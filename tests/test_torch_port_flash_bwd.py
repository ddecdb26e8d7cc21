"""The PyTorch port's flash-attention backward on the CPU, where
`flash_attention_bwd` runs its plain version: against `jax.vjp` of the JAX
`flash_attention` (its custom VJP, Pallas kernels in interpret mode) and
against torch autograd of the plain forward, through the `FlashAttention`
autograd function, and through the port's AttnBlock at batch 2 (flash path)
against the same images one at a time (plain path)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgam_neurips22_tpu.models.vqgan.nn import init_attn_block
from sgam_neurips22_tpu.ops.attention_pallas import flash_attention as j_flash_attention
from sgam_neurips22_tpu_torch.core.state_dict import from_jax_params, load_into
from sgam_neurips22_tpu_torch.models.vqgan.nn import AttnBlock
from sgam_neurips22_tpu_torch.ops.attention import (
    FlashAttention,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_dkv,
    flash_attention_dkv_plain,
    flash_attention_dq,
    flash_attention_dq_plain,
    flash_attention_fwd,
    flash_attention_plain,
)
from torch_port_common import t, to_numpy_tree

SHAPES = [(1, 64, 32), (2, 300, 128), (2, 256, 512)]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(4)]  # q, k, v, dout


def _jax_grads(q, k, v, g):
    fn = lambda a, b, c: j_flash_attention(a, b, c, block_q=128, block_k=128, interpret=True)  # noqa: E731
    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_matches_jax_custom_vjp(shape):
    """flash_attention_bwd_plain on the port's forward residuals, and the
    gradients torch autograd takes through FlashAttention, against the JAX
    custom VJP (the Pallas dQ and dK/dV kernels in interpret mode) at atol
    3e-5, tests/test_ops.py's tolerance for those kernels."""
    q, k, v, g = _inputs(shape, sum(shape) + 1)
    ref = _jax_grads(q, k, v, g)
    out, lse = flash_attention_fwd(t(q), t(k), t(v))
    plain = flash_attention_bwd_plain(t(q), t(k), t(v), out, lse, t(g))
    qt, kt, vt = (t(x).requires_grad_() for x in (q, k, v))
    auto = torch.autograd.grad(flash_attention(qt, kt, vt), (qt, kt, vt), t(g))
    for name, p, a, r in zip(("dq", "dk", "dv"), plain, auto, ref):
        np.testing.assert_allclose(p.numpy(), r, atol=3e-5, rtol=0, err_msg=name)
        np.testing.assert_allclose(a.numpy(), r, atol=3e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_matches_autograd_of_plain_forward(shape):
    """FlashAttention's gradients against torch autograd through the plain
    forward (softmax of the [B, S, S] logits) at atol 3e-5."""
    q, k, v, g = _inputs(shape, sum(shape) + 2)
    grads = []
    for fn in (flash_attention, lambda a, b, c: flash_attention_plain(a, b, c)[0]):
        qt, kt, vt = (t(x).requires_grad_() for x in (q, k, v))
        grads.append(torch.autograd.grad(fn(qt, kt, vt), (qt, kt, vt), t(g)))
    for name, a, r in zip(("dq", "dk", "dv"), *grads):
        np.testing.assert_allclose(a.numpy(), r.numpy(), atol=3e-5, rtol=0, err_msg=name)


def test_kernel_plain_versions_compose_the_backward():
    """flash_attention_dq_plain and flash_attention_dkv_plain, the plain
    versions of the two kernels, give flash_attention_bwd_plain's three
    gradients; on the CPU flash_attention_bwd is that plain version."""
    q, k, v, g = (t(x) for x in _inputs((2, 40, 64), 7))
    out, lse = flash_attention_fwd(q, k, v)
    dd = (g * out).sum(dim=-1)
    dq, dk, dv = flash_attention_bwd_plain(q, k, v, out, lse, g)
    torch.testing.assert_close(flash_attention_dq_plain(q, k, v, g, lse, dd), dq, rtol=0, atol=0)
    torch.testing.assert_close(flash_attention_dkv_plain(q, k, v, g, lse, dd), (dk, dv), rtol=0, atol=0)
    for a, b in zip(flash_attention_bwd(q, k, v, out, lse, g), (dq, dk, dv)):
        assert torch.equal(a, b)


def test_bwd_wrappers_launch_only_on_cuda():
    """The kernel wrappers take no CPU tensor (no plain fallback inside
    them) and count nothing; flash_attention_bwd checks its shapes."""
    q, k, v, g = (t(x) for x in _inputs((2, 40, 64), 8))
    out, lse = flash_attention_fwd(q, k, v)
    dd = (g * out).sum(dim=-1)
    before = (flash_attention_dq.launches, flash_attention_dkv.launches)
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention_dq(q, k, v, g, lse, dd)
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention_dkv(q, k, v, g, lse, dd)
    with pytest.raises(ValueError, match="row tensor"):
        flash_attention_bwd(q, k, v, out, lse[:, :39], g)
    with pytest.raises(ValueError, match="shape"):
        flash_attention_bwd(q, k, v, out[:, :39], lse, g)
    assert (flash_attention_dq.launches, flash_attention_dkv.launches) == before == (0, 0)


def test_flash_attention_output_has_grad_fn():
    q, k, v, _ = (t(x).requires_grad_() for x in _inputs((2, 40, 64), 9))
    out = flash_attention(q, k, v)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert isinstance(out.grad_fn, FlashAttention._backward_cls)


def test_attn_block_batch2_gradients_match_two_batch1_calls():
    """AttnBlock at batch 2 (FlashAttention) gives its q, k, v and proj_out
    conv weights, its GroupNorm and its input the same gradients as the two
    images through the batch-1 plain path, at atol 1e-5: the attention term
    reaches them through the flash path."""
    c = 64
    rng = np.random.default_rng(13)
    p = to_numpy_tree(init_attn_block(jax.random.PRNGKey(2), c))
    p["norm"] = {"weight": rng.uniform(0.5, 1.5, c).astype(np.float32), "bias": rng.normal(size=c).astype(np.float32)}
    block = AttnBlock(c)
    load_into(block, from_jax_params(p))
    x = t(rng.normal(size=(2, c, 8, 8)).astype(np.float32))
    g = t(rng.normal(size=(2, c, 8, 8)).astype(np.float32))
    params = [block.q.weight, block.k.weight, block.v.weight, block.proj_out.weight, block.norm.weight]

    def grads(xs, gs):
        xs = xs.clone().requires_grad_()
        return torch.autograd.grad(block(xs), [xs, *params], gs)

    flash = grads(x, g)
    single = [grads(x[i:i + 1], g[i:i + 1]) for i in range(2)]
    np.testing.assert_allclose(flash[0].numpy(), torch.cat([s[0] for s in single]).numpy(), atol=1e-5, rtol=0)
    for i, name in enumerate(("q", "k", "v", "proj_out", "norm"), start=1):
        np.testing.assert_allclose(flash[i].numpy(), (single[0][i] + single[1][i]).numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)
    assert float(flash[1].abs().max()) > 1e-3  # the attention term reaches q
