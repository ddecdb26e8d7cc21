"""The PyTorch port's flash attention on the CPU, where the wrapper runs its
plain version: against the JAX Pallas kernel (interpret mode) for the output
and the row logsumexp, through the port's AttnBlock (which takes the flash
path where its config or its caller asks for it) against the JAX
`attn_block(..., flash=True)`, and through the TINY VQModel at batch 2
against the JAX forward with `DDConfig.flash_attention=True`."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgam_neurips22_tpu.models import forward as j_forward
from sgam_neurips22_tpu.models.vqgan.nn import attn_block as j_attn_block
from sgam_neurips22_tpu.models.vqgan.nn import init_attn_block
from sgam_neurips22_tpu.ops.attention_pallas import _flash_fwd_impl
from sgam_neurips22_tpu.ops.attention_pallas import flash_attention as j_flash_attention
from sgam_neurips22_tpu_torch.core.state_dict import from_jax_params, load_into
from sgam_neurips22_tpu_torch.models.vqgan.nn import AttnBlock
from sgam_neurips22_tpu_torch.ops import attention
from sgam_neurips22_tpu_torch.ops.attention import (
    flash_attention,
    flash_attention_fwd,
    flash_attention_plain,
)
from torch_port_common import TINY, port_model, t, tiny_jax_params, to_numpy_tree


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", [(1, 64, 32), (2, 300, 128), (2, 256, 512)])
def test_plain_matches_jax_flash_kernel(shape):
    """out at atol 2e-5 (tests/test_ops.py's tolerance for the kernel),
    lse at atol 1e-5: the same sums taken in another order."""
    q, k, v = _qkv(shape, sum(shape))
    out, lse = flash_attention_plain(t(q), t(k), t(v))
    j_out = j_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128, block_k=128, interpret=True)
    _, j_lse = _flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 128, 128, True)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=2e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=1e-5, rtol=0)


def test_wrapper_runs_plain_on_cpu_without_launching():
    q, k, v = (t(x) for x in _qkv((2, 40, 64), 3))
    before = flash_attention_fwd.launches
    out, lse = flash_attention_fwd(q, k, v)
    ref_out, ref_lse = flash_attention_plain(q, k, v)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    assert torch.equal(flash_attention(q, k, v), ref_out)
    assert flash_attention_fwd.launches == before == 0


def test_wrapper_rejects_bad_inputs():
    q, k, v = (t(x) for x in _qkv((2, 40, 64), 4))
    with pytest.raises(ValueError, match="shape"):
        flash_attention_fwd(q, k[:, :39], v)
    with pytest.raises(ValueError, match="shape"):
        flash_attention_fwd(q[0], k[0], v[0])
    with pytest.raises(TypeError, match="float32"):
        flash_attention_fwd(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="meta"):
        flash_attention_fwd(q, k.to("meta"), v)
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention_fwd(q.to("meta"), k.to("meta"), v.to("meta"))


@torch.inference_mode()
def test_attn_block_flash_matches_plain_and_jax(monkeypatch):
    """The flash path of the port's AttnBlock (built with flash on, batch 2)
    and its plain path (the call's flash=False override, each image alone
    at batch 1) agree at atol 1e-5, and the flash path matches the JAX
    attn_block(flash=True) (Pallas in interpret mode) at atol 2e-5, on
    weights carried across by the bridge. A block built without flash
    takes the plain path at batch 2 too."""
    c = 64
    rng = np.random.default_rng(11)
    p = to_numpy_tree(init_attn_block(jax.random.PRNGKey(1), c))
    p["norm"] = {"weight": rng.uniform(0.5, 1.5, c).astype(np.float32), "bias": rng.normal(size=c).astype(np.float32)}
    block = AttnBlock(c, flash=True)
    load_into(block, from_jax_params(p))
    x = rng.normal(size=(2, 8, 8, c)).astype(np.float32)  # NHWC, 64 tokens
    x_nchw = t(x).permute(0, 3, 1, 2)
    calls = []
    monkeypatch.setattr(attention, "flash_attention", lambda *a: calls.append(a[0].shape) or flash_attention(*a))
    flash = block(x_nchw).permute(0, 2, 3, 1).numpy()
    assert calls == [(2, 64, c)]
    plain = np.concatenate([block(x_nchw[i:i + 1], flash=False).permute(0, 2, 3, 1).numpy() for i in range(2)])
    assert len(calls) == 1
    off = AttnBlock(c)
    load_into(off, from_jax_params(p))
    np.testing.assert_allclose(off(x_nchw).permute(0, 2, 3, 1).numpy(), plain, atol=1e-5, rtol=0)
    assert len(calls) == 1
    ref = np.asarray(j_attn_block(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, p), flash=True))
    np.testing.assert_allclose(flash, plain, atol=1e-5, rtol=0)
    np.testing.assert_allclose(flash, ref, atol=2e-5, rtol=0)


@torch.inference_mode()
def test_tiny_forward_with_flash_matches_jax():
    """TINY VQModel at batch 2, where the port takes the flash path, against
    the JAX forward with flash attention on: indices identical, rgb at atol
    1e-5."""
    params = tiny_jax_params()
    jcfg = dataclasses.replace(TINY, ddconfig=dataclasses.replace(TINY.ddconfig, flash_attention=True))
    rng = np.random.default_rng(12)
    x = rng.uniform(-1, 1, (2, 32, 32, 4)).astype(np.float32)
    mask = rng.random((2, 32, 32, 1)) < 0.3
    res = port_model(params, jcfg)(t(x), extrapolation_mask=t(mask), topk=1)
    ref = j_forward(params, jcfg, jnp.asarray(x), extrapolation_mask=jnp.asarray(mask), topk=1,
                    rng=jax.random.PRNGKey(0))
    np.testing.assert_array_equal(res.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_allclose(res.xrec[..., :3].numpy(), np.asarray(ref.xrec)[..., :3], atol=1e-5, rtol=0)

