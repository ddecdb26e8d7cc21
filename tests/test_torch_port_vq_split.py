"""The accuracy argument of the tensor-core codeword search
(`csrc/nearest_codeword.cu`) on the CPU: a torch emulation of its 3xTF32
arithmetic against the JAX Pallas kernel (`vq_pallas.nearest_codeword` in
interpret mode) and float64, at the gates chip_smoke.py holds the kernel to
on the card.

The kernel ranks codewords by s = ||e||^2 - 2 acc, acc = z.e, and adds
||z||^2 to the winner only. Each product is big(z) big(e) + big(z) small(e)
+ small(z) big(e), with big = x rounded to TF32 to nearest, ties away (the
bits `csrc/mma_tf32.cuh` gives) and small = x - big, which the tensor core
reads truncated to TF32. acc is a two-level sum: each 32-deep slice of the
depth summed on its own, the slices added in order in f32; ||e||^2 too,
each slice an f32 fused multiply-add chain in depth order. The emulation
is for these tests only; nothing in the port calls it. It models the
split, not the tensor core's own accumulation.

Gates: indices equal to the reference except at f32 near-ties (the two
codewords' float64 scores within 1e-6 of 2 sum |z e| + ||e||^2), and every
winning distance within 1e-6 (||z||^2 + ||e||^2 + 2 sum |z e|) of the
float64 ||z - e||^2. On a clustered codebook, e ~ N(0, 1) and z = e_j +
0.05 N(0, 1) as a trained codebook sits near its latents, the distance is a
small difference of large terms, and a 1xTF32 product (big z big e alone)
misses the distance gate; on the uniform(-1/K, 1/K) init codebook it does
not, which is why chip_smoke.py runs the clustered case."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgam_neurips22_tpu.ops.vq_pallas import nearest_codeword as j_nearest
from torch_port_common import t

P, K, D = 64, 1024, 256
SLICE = 32  # the kernel's depth slice


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as the kernel rounds it (cvt.rna.tf32.f32's bits)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_truncated(x: torch.Tensor) -> torch.Tensor:
    """The TF32 value a tensor core reads from an f32 register."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def mm_3xtf32(z: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    z_big, e_big = tf32(z), tf32(e)
    z_small, e_small = tf32_truncated(z - z_big), tf32_truncated(e - e_big)
    return z_small @ e_big.T + z_big @ e_small.T + z_big @ e_big.T


def mm_1xtf32(z: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    return tf32(z) @ tf32(e).T


def fma_sumsq(x: torch.Tensor) -> torch.Tensor:
    """sum of x^2 over the last axis as an f32 fmaf chain in order (x^2 is
    exact in float64, so one rounding a step but for a rare double rounding)."""
    s = torch.zeros(x.shape[0], dtype=torch.float64)
    for c in range(x.shape[1]):
        s = (s + x[:, c].double() ** 2).float().double()
    return s.float()


def sumsq_emulated(e: torch.Tensor) -> torch.Tensor:
    """||e||^2 as the kernel sums it: each slice an fmaf chain from zero,
    the slices added in order in f32."""
    e2 = torch.zeros(e.shape[0])
    for d0 in range(0, e.shape[1], SLICE):
        e2 = e2 + fma_sumsq(e[:, d0:d0 + SLICE])
    return e2


def search_emulated(z: torch.Tensor, e: torch.Tensor, mm):
    """(idx, dist) as the kernel computes them, each slice's products through mm."""
    acc = torch.zeros(z.shape[0], e.shape[0])
    for d0 in range(0, z.shape[1], SLICE):
        acc = acc + mm(z[:, d0:d0 + SLICE], e[:, d0:d0 + SLICE])
    s = (sumsq_emulated(e)[None, :] - 2.0 * acc) + 0.0
    idx = torch.argmin(s, dim=1)  # first occurrence on ties
    return idx, s.gather(1, idx[:, None])[:, 0] + (z * z).sum(dim=1)


def _case(codebook):
    rng = np.random.default_rng(8 + len(codebook))
    if codebook == "clustered":
        e = rng.normal(size=(K, D)).astype(np.float32)
        z = (e[rng.integers(0, K, P)] + 0.05 * rng.normal(size=(P, D))).astype(np.float32)
    else:
        e = ((rng.random((K, D)) * 2 - 1) / K).astype(np.float32)
        z = rng.normal(size=(P, D)).astype(np.float32)
    return z, e


def _reference(z, e):
    """The JAX Pallas kernel in interpret mode: (idx, dist)."""
    idx, dist = j_nearest(jnp.asarray(z), jnp.asarray(e), tile_k=512, interpret=True)
    return np.asarray(idx), np.asarray(dist)


def _near_ties_ok(z, e, idx, ref_idx) -> bool:
    """Every row whose index differs is an f32 near-tie in float64."""
    z64, e64 = z.astype(np.float64), e.astype(np.float64)
    for r in np.flatnonzero(idx != ref_idx):
        a, b = e64[idx[r]], e64[ref_idx[r]]
        score = [x @ x - 2 * z64[r] @ x for x in (a, b)]
        scale = max(x @ x + 2 * np.abs(z64[r] * x).sum() for x in (a, b))
        if abs(score[0] - score[1]) > 1e-6 * scale:
            return False
    return True


def _gate_share(z, e, idx, dist) -> float:
    """The largest winning-distance error against float64 as a share of
    1e-6 (||z||^2 + ||e||^2 + 2 sum |z e|)."""
    z64, e64 = z.astype(np.float64), e.astype(np.float64)[idx]
    ref = ((z64 - e64) ** 2).sum(1)
    scale = (z64 * z64).sum(1) + (e64 * e64).sum(1) + 2 * np.abs(z64 * e64).sum(1)
    return float((np.abs(dist.astype(np.float64) - ref) / (1e-6 * scale)).max())


@pytest.mark.parametrize("codebook", ["clustered", "uniform"])
def test_3xtf32_split_meets_the_kernel_gate(codebook):
    z, e = _case(codebook)
    ref_idx, ref_dist = _reference(z, e)
    idx, dist = (x.numpy() for x in search_emulated(t(z), t(e), mm_3xtf32))
    assert _near_ties_ok(z, e, idx, ref_idx)
    assert _gate_share(z, e, ref_idx, ref_dist) <= 1.0, "the JAX reference misses its own gate"
    share = _gate_share(z, e, idx, dist)
    assert share <= 1.0, f"3xTF32 winning-distance error / gate {share}"


def test_1xtf32_fails_the_distance_gate_on_a_clustered_codebook():
    """The negative control: with both correction products dropped the
    winning distance misses its gate on the clustered codebook."""
    z, e = _case("clustered")
    idx, dist = (x.numpy() for x in search_emulated(t(z), t(e), mm_1xtf32))
    share = _gate_share(z, e, idx, dist)
    assert share > 1.0, f"1xTF32 error / gate {share}: the gate would not catch it"


def test_1xtf32_passes_on_the_init_codebook():
    """On the uniform init codebook ||z||^2 dominates the distance, so a
    dropped correction term shows in neither the indices nor the distance
    gate: the reason the card's check needs the clustered case."""
    z, e = _case("uniform")
    ref_idx, _ = _reference(z, e)
    idx, dist = (x.numpy() for x in search_emulated(t(z), t(e), mm_1xtf32))
    assert _near_ties_ok(z, e, idx, ref_idx)
    assert _gate_share(z, e, idx, dist) <= 1.0
