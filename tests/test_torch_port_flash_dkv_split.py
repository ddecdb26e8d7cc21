"""The accuracy argument of the tensor-core attention kernels, dK/dV
(`csrc/flash_attention_dkv.cu`), dQ (`csrc/flash_attention_dq.cu`) and the
forward (`csrc/flash_attention_fwd.cu`), on the CPU: a torch emulation of
their 3xTF32 arithmetic against the JAX custom VJP and the JAX forward
(Pallas kernels in interpret mode), at the tolerances that chip_smoke.py
holds the kernels to on the card. The forward's emulation also follows its
loop: 64-key tiles with an online max and sum, a fresh P V product each
tile folded in as acc * alpha + part.

Each kernel computes every f32 product a*b on the tensor cores as
big(a)*big(b) + big(a)*small(b) + small(a)*big(b), summed in f32, with
big = x rounded to TF32 to nearest, ties away (`csrc/mma_tf32.cuh` adds
0x1000 to the bits and clears the low 13, the bits `cvt.rna.tf32.f32`
gives) and small = x - big, of which the tensor core reads the top 19
bits (clear the low 13). The emulation here is for
these tests only; nothing in the port calls it. A 1xTF32 emulation
(big*big alone) must fail the same gates, which shows that they would
catch a dropped correction term."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgam_neurips22_tpu.ops.attention_pallas import _flash_fwd_impl
from sgam_neurips22_tpu.ops.attention_pallas import flash_attention as j_flash_attention
from sgam_neurips22_tpu_torch.ops.attention import (
    flash_attention_dkv_plain,
    flash_attention_dq_plain,
    flash_attention_fwd,
    flash_attention_plain,
)
from torch_port_common import t

SHAPES = [(2, 300, 128), (1, 256, 512)]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as the kernels round it (cvt.rna.tf32.f32's bits)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_truncated(x: torch.Tensor) -> torch.Tensor:
    """The TF32 value a tensor core reads from an f32 register."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a_big, b_big = tf32(a), tf32(b)
    a_small, b_small = tf32_truncated(a - a_big), tf32_truncated(b - b_big)
    return a_big @ b_big + a_big @ b_small + a_small @ b_big


def mm_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32(a) @ tf32(b)


def dkv_emulated(q, k, v, dout, lse, dd, mm):
    """(dk, dv) as the kernel computes them, each product through mm:
    logits^T = scale * (K Q^T), P^T = exp(logits^T - lse[q]),
    dS^T = P^T * (V dO^T - D[q]), dv = P^T dO, dk = scale * dS^T Q."""
    scale = 1.0 / q.shape[-1] ** 0.5
    p_t = torch.exp(scale * mm(k, q.transpose(1, 2)) - lse[:, None, :])
    ds_t = p_t * (mm(v, dout.transpose(1, 2)) - dd[:, None, :])
    return scale * mm(ds_t, q), mm(p_t, dout)


def dq_emulated(q, k, v, dout, lse, dd, mm):
    """(dq,) as the kernel computes it, each product through mm:
    logits = scale * (Q K^T), P = exp(logits - lse),
    dS = P * (dO V^T - D), dq = scale * dS K."""
    scale = 1.0 / q.shape[-1] ** 0.5
    p = torch.exp(scale * mm(q, k.transpose(1, 2)) - lse[..., None])
    ds = p * (mm(dout, v.transpose(1, 2)) - dd[..., None])
    return (scale * mm(ds, k),)


def fwd_emulated(q, k, v, mm, block_k=64):
    """(out, lse) as the forward kernel computes them, each product through
    mm: qs = q * scale (staged once), then for each key tile logits = qs
    K_tile^T, m_new = max(m, rowmax), alpha = exp(m - m_new), P =
    exp(logits - m_new), l = l * alpha + rowsum(P), acc = acc * alpha +
    P V_tile; out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30))."""
    qs = q * (1.0 / q.shape[-1] ** 0.5)
    m = torch.full(q.shape[:2], -torch.inf)
    l = torch.zeros(q.shape[:2])
    acc = torch.zeros_like(q)
    for k0 in range(0, q.shape[1], block_k):
        logits = mm(qs, k[:, k0:k0 + block_k].transpose(1, 2))
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + mm(p, v[:, k0:k0 + block_k])
        m = m_new
    l = l.clamp(min=1e-30)
    return acc / l[..., None], m + torch.log(l)


# kernel -> (its emulation, its plain version, the JAX VJP's outputs it is
# held to; None: the JAX forward's (out, lse))
KERNELS = {
    "dkv": (dkv_emulated, flash_attention_dkv_plain, slice(1, 3)),
    "dq": (dq_emulated, lambda *a: (flash_attention_dq_plain(*a),), slice(0, 1)),
    "fwd": (fwd_emulated, flash_attention_plain, None),
}


def _case(shape, grad):
    """The kernel's inputs and the JAX reference with its Pallas kernels in
    interpret mode: for "fwd", (q, k, v) and the JAX forward's (out, lse);
    for a gradient, (q, k, v, dout, lse, dd) on the port's forward and the
    JAX custom VJP's gradients of kernel `grad`."""
    rng = np.random.default_rng(sum(shape) + 5)
    q, k, v, g = (rng.normal(size=shape).astype(np.float32) for _ in range(4))
    if grad == "fwd":
        ref = _flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 128, 128, True)
        return (t(q), t(k), t(v)), [np.asarray(x) for x in ref]
    fn = lambda a, b, c: j_flash_attention(a, b, c, block_q=128, block_k=128, interpret=True)  # noqa: E731
    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = [np.asarray(x) for x in vjp(jnp.asarray(g))[KERNELS[grad][2]]]
    out, lse = flash_attention_fwd(t(q), t(k), t(v))
    dd = (t(g) * out).sum(dim=-1)
    return (t(q), t(k), t(v), t(g), lse, dd), ref


def _tolerance(shape, ref):
    """chip_smoke.py's backward gate: 3e-5 absolute at S=300, else 1e-4 of
    the gradient's largest magnitude."""
    return 3e-5 if shape[1] == 300 else 1e-4 * float(np.abs(ref).max())


def _gate_shares(grad, shape, outs, ref):
    """Each output's error against the JAX reference as a share of its gate
    in chip_smoke.py: the backward's for a gradient; for the forward, out
    within 2e-5 absolute at S=300 and 1e-4 elsewhere, lse within 1e-5
    relative."""
    shares = []
    for i, (got, r) in enumerate(zip(outs, ref)):
        err = np.abs(got.numpy() - r)
        if grad != "fwd":
            shares.append(float(err.max()) / _tolerance(shape, r))
        elif i == 0:
            shares.append(float(err.max()) / (2e-5 if shape[1] == 300 else 1e-4))
        else:
            shares.append(float((err / np.abs(r)).max()) / 1e-5)
    return shares


@pytest.mark.parametrize("grad", KERNELS)
@pytest.mark.parametrize("shape", SHAPES)
def test_3xtf32_split_meets_the_kernel_gate(shape, grad):
    args, ref = _case(shape, grad)
    shares = _gate_shares(grad, shape, KERNELS[grad][0](*args, mm_3xtf32), ref)
    assert max(shares) <= 1.0, f"{grad}: 3xTF32 error / tolerance {shares}"


@pytest.mark.parametrize("grad", KERNELS)
@pytest.mark.parametrize("shape", SHAPES)
def test_1xtf32_fails_the_kernel_gate(shape, grad):
    """The negative control: with the two correction products dropped the
    error exceeds the gate in one of the kernel's outputs."""
    args, ref = _case(shape, grad)
    ratios = _gate_shares(grad, shape, KERNELS[grad][0](*args, mm_1xtf32), ref)
    assert max(ratios) > 1.0, f"1xTF32 error / tolerance {ratios}: the gate would not catch it"


@pytest.mark.parametrize("grad", KERNELS)
@pytest.mark.parametrize("shape", SHAPES)
def test_emulation_in_f32_is_the_plain_version(shape, grad):
    """With exact f32 products the emulation is the kernel's plain version,
    so the tests above measure the split alone. The backward emulations
    take the plain version's sums and equal it bit for bit; the forward's
    sums over key tiles, as the kernel does, so it may differ from the
    plain version's one softmax in the last bits: out by 2e-6 and lse by
    1e-6 relative, a tenth of the gate."""
    args, _ = _case(shape, grad)
    emulated, plain, _ = KERNELS[grad]
    tols = [(0, 2e-6), (1e-6, 0)] if grad == "fwd" else [(0, 0)] * 2  # (rtol, atol) of each output
    for got, want, (rtol, atol) in zip(emulated(*args, torch.matmul), plain(*args), tols):
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


def test_tf32_rounds_to_nearest_ties_away():
    """tf32 keeps 10 mantissa bits; a tie (bit 12 set, lower bits clear)
    rounds away from zero in magnitude, as cvt.rna does."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2.0 ** -23, 3.0], dtype=torch.float32)
    assert tf32(x).tolist() == [one + ulp, -(one + ulp), one, 3.0]
    assert tf32_truncated(x).tolist() == [one, -one, one, 3.0]
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    big = tf32(y)
    assert bool(((big.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((y - big).abs() / y.abs()).max()) <= 2.0 ** -11
