"""The accuracy argument of the tensor-core backward kernels, dK/dV
(`csrc/flash_attention_dkv.cu`) and dQ (`csrc/flash_attention_dq.cu`), on
the CPU: a torch emulation of their 3xTF32 arithmetic against the JAX
custom VJP (Pallas kernels in interpret mode), at the tolerances that
chip_smoke.py holds the kernels to on the card.

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

from sgam_neurips22_tpu.ops.attention_pallas import flash_attention as j_flash_attention
from sgam_neurips22_tpu_torch.ops.attention import (
    flash_attention_dkv_plain,
    flash_attention_dq_plain,
    flash_attention_fwd,
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


# gradient -> (its emulation, its plain version, the JAX VJP's outputs it is held to)
KERNELS = {
    "dkv": (dkv_emulated, flash_attention_dkv_plain, slice(1, 3)),
    "dq": (dq_emulated, lambda *a: (flash_attention_dq_plain(*a),), slice(0, 1)),
}


def _case(shape, grad):
    """(q, k, v, dout, lse, dd) on the port's forward, and the JAX custom
    VJP's gradients of kernel `grad` with its Pallas kernels in interpret
    mode."""
    rng = np.random.default_rng(sum(shape) + 5)
    q, k, v, g = (rng.normal(size=shape).astype(np.float32) for _ in range(4))
    fn = lambda a, b, c: j_flash_attention(a, b, c, block_q=128, block_k=128, interpret=True)  # noqa: E731
    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = [np.asarray(x) for x in vjp(jnp.asarray(g))[KERNELS[grad][2]]]
    out, lse = flash_attention_fwd(t(q), t(k), t(v))
    dd = (t(g) * out).sum(dim=-1)
    return (t(q), t(k), t(v), t(g), lse, dd), ref


def _tolerance(shape, ref):
    """chip_smoke.py's gate: 3e-5 absolute at S=300, else 1e-4 of the
    gradient's largest magnitude."""
    return 3e-5 if shape[1] == 300 else 1e-4 * float(np.abs(ref).max())


@pytest.mark.parametrize("grad", KERNELS)
@pytest.mark.parametrize("shape", SHAPES)
def test_3xtf32_split_meets_the_kernel_gate(shape, grad):
    args, ref = _case(shape, grad)
    for i, (got, r) in enumerate(zip(KERNELS[grad][0](*args, mm_3xtf32), ref)):
        err = float(np.abs(got.numpy() - r).max())
        assert err <= _tolerance(shape, r), f"{grad}[{i}]: 3xTF32 error {err} over {_tolerance(shape, r)}"


@pytest.mark.parametrize("grad", KERNELS)
@pytest.mark.parametrize("shape", SHAPES)
def test_1xtf32_fails_the_kernel_gate(shape, grad):
    """The negative control: with the two correction products dropped the
    error exceeds the gate in one of the kernel's gradients."""
    args, ref = _case(shape, grad)
    ratios = [float(np.abs(got.numpy() - r).max()) / _tolerance(shape, r)
              for got, r in zip(KERNELS[grad][0](*args, mm_1xtf32), ref)]
    assert max(ratios) > 1.0, f"1xTF32 error / tolerance {ratios}: the gate would not catch it"


@pytest.mark.parametrize("grad", KERNELS)
@pytest.mark.parametrize("shape", SHAPES)
def test_emulation_in_f32_is_the_plain_version(shape, grad):
    """With exact f32 products the emulation is the kernel's plain version,
    so the tests above measure the split alone."""
    args, _ = _case(shape, grad)
    emulated, plain, _ = KERNELS[grad]
    for got, want in zip(emulated(*args, torch.matmul), plain(*args)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


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
