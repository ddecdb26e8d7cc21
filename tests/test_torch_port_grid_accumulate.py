"""The map's grid accumulation on the card (`ops/grid_accumulate`,
`csrc/grid_accumulate.cu`), emulated here step by step in numpy, against
the CPU's index_add_ (`grid_accumulate_plain`) and JAX's scatter-add
(`jnp.asarray(grid).at[idx].add(vals)`, as the JAX package's
`mapping/tsdf.integrate` adds), bit for bit: compared as uint32 words, so
that -0.0 and +0.0 differ.

The emulation does what the kernels do: the zero addends are dropped and a
+0.0 addend turns a -0.0 grid value into +0.0 (ga_prep); the rest are
sorted by key with the kernels' digit plan (`digit_plan`), each pass
cutting its samples into G chunks and placing a sample at its digit's
global base plus the counts of that digit in the chunks before its own
(ga_count, ga_spine) plus its rank in its chunk (ga_scatter, which ranks
a chunk tile by tile: the tile does not move a sample); the positions must
form a permutation; then each key's run is added onto the grid in order
(ga_walk). It runs with the route's default digit width and the other
ones the kernel takes, with the kernels' G (`_chunks`) and with others:
any G gives the same order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgam_neurips22_tpu_torch.mapping import tsdf
from sgam_neurips22_tpu_torch.ops import grid_accumulate as acc

POS0, NEG0 = np.float32(0.0), np.float32(-0.0)
# (widest digit, chunks): None is the kernels' own G
ROUTES = [(acc.MAX_DIGIT_BITS, None), (acc.MAX_DIGIT_BITS, 1), (acc.MAX_DIGIT_BITS, 7), (8, None), (10, 264)]
# the tiny map of tests/test_torch_port_mapping.py
MH = MW = 48
MK = np.array([[40.0, 0, 23.5], [0, 40.0, 23.5], [0, 0, 1]], np.float32)
MAP = dict(dims=(64, 64, 64), voxel_size=0.1, sdf_trunc=0.4, origin=(-3.2, -3.2, 0.0), pool_capacity=1 << 12,
           pool_cells=3, render_chunk=1 << 10)


def emulate(grid, idx, vals, max_bits, chunks):
    """The CUDA route's result, kernel by kernel."""
    grid = grid.copy()
    words = grid.view(np.uint32)
    kw, vw = idx.view(np.uint32), vals.view(np.uint32)
    inside = kw < grid.size
    # ga_prep: drop the zeros and the keys outside [0, V); +0.0 turns a -0.0 grid value into +0.0
    plus0 = kw[inside & (vw == 0)]
    grid[plus0[words[plus0] == 0x80000000]] = POS0
    keep = inside & ((vw & 0x7FFFFFFF) != 0)
    keys, values = kw, vals
    chunks = chunks or max(1, acc._chunks(idx.size))
    for shift, bits in acc.digit_plan(grid.size, max_bits):
        nb, sel = 1 << bits, np.flatnonzero(keep)
        ch, d = sel // max(1, -(-keys.size // chunks)), ((keys[sel] >> shift) & (nb - 1)).astype(np.int64)
        counts = np.zeros((chunks, nb), np.int64)  # ga_count
        np.add.at(counts, (ch, d), 1)
        base = np.cumsum(counts.sum(0)) - counts.sum(0)  # ga_spine: the digit's base, the chunks before
        before = np.cumsum(counts, 0) - counts
        order = np.lexsort((sel, d, ch))  # ga_scatter: the rank in the chunk
        group = (ch * nb + d)[order]
        first = np.r_[0, np.flatnonzero(group[1:] != group[:-1]) + 1] if sel.size else np.zeros(0, np.int64)
        rank = np.empty(sel.size, np.int64)
        rank[order] = np.arange(sel.size) - np.repeat(first, np.diff(np.r_[first, sel.size]))
        pos = base[d] + before[ch, d] + rank
        np.testing.assert_array_equal(np.sort(pos), np.arange(sel.size))
        out_k, out_v = np.empty(sel.size, np.uint32), np.empty(sel.size, np.float32)
        out_k[pos], out_v[pos] = keys[sel], values[sel]
        keys, values, keep = out_k, out_v, np.ones(sel.size, bool)
    if keys.size:  # ga_walk: each run onto its key, in order
        starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
        lens = np.diff(np.r_[starts, keys.size])
        total = grid[keys[starts]]
        for r in range(lens.max()):
            live = lens > r
            total[live] = total[live] + values[starts[live] + r]
        grid[keys[starts]] = total
    return grid


def integrate_inputs():
    """(grid, idx, vals) of the port's integrate at its second frame on the
    tiny map: band-major, with holes in the depth and samples outside the
    volume (masked: +-0.0 at voxel 0)."""
    cfg, rng, keep = tsdf.TSDFConfig(**MAP), np.random.default_rng(4), {}
    vol, orig = tsdf.create_volume(cfg, device="cpu"), tsdf.grid_accumulate

    def spy(grid, idx, vals):
        keep.update(grid=grid.numpy().copy(), idx=idx.numpy().copy(), vals=vals.numpy().copy())
        return orig(grid, idx, vals)

    tsdf.grid_accumulate = spy
    try:
        for f in range(2):
            d = rng.uniform(2.0, 4.0, (MH, MW)).astype(np.float32)
            d[::7, ::5] = 0.0
            d[:4] = 40.0  # beyond the truncation depth
            e = np.eye(4, dtype=np.float32)
            e[0, 3] = 0.2 * f - 2.9  # the left of the frame outside the volume
            tsdf.integrate(vol, cfg, torch.as_tensor(d), None, torch.as_tensor(MK), torch.as_tensor(e))
    finally:
        tsdf.grid_accumulate = orig
    return keep["grid"], keep["idx"], keep["vals"]


def case(name):
    rng = np.random.default_rng(20)
    g = rng.normal(0, 1, 96).astype(np.float32)
    if name == "key0_zeros":  # a 100k-long run of +0.0 at voxel 0 among real voxel-0 and other samples
        idx = np.r_[np.zeros(100_000), np.zeros(500), rng.integers(0, 96, 5000)].astype(np.int32)
        vals = np.r_[np.zeros(100_000), rng.choice([0.25, -0.5, 0.125], 5500)].astype(np.float32)
        perm = rng.permutation(idx.size)
        return g, idx[perm], vals[perm]
    if name == "neg_zero_grid":
        # -0.0 at voxels hit by +0.0 only, -0.0 only, both, a sum that cancels, and a +0.0 after it;
        # the other samples keep off them
        g[1:9] = NEG0
        idx = np.int32([1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 6, 7, 7, 7, 8, 8, 8, 3, 4])
        vals = np.float32([POS0, NEG0, NEG0, NEG0, POS0, POS0, NEG0, 0.5, -0.5, 0.75, POS0, -0.75,
                           NEG0, 0.25, -0.25, POS0, 1.0, -1.0, NEG0, POS0])
        perm = rng.permutation(idx.size)
        idx, vals = np.r_[idx[perm], rng.integers(9, 96, 3000)].astype(np.int32), np.r_[
            vals[perm], rng.choice(np.float32([0.25, -0.25, 0.0, -0.0]), 3000)].astype(np.float32)
        return g, idx, vals
    if name == "top_keys":  # V just above a power of two, keys up to V - 1
        v, n = (1 << 20) + 1, 4000
        idx = np.r_[np.full(10, v - 1), rng.integers(v - 64, v, n), rng.integers(0, v, n)].astype(np.int32)
        return rng.normal(0, 1, v).astype(np.float32), idx, rng.normal(0, 1, idx.size).astype(np.float32)
    if name == "empty":
        return g, np.zeros(0, np.int32), np.zeros(0, np.float32)
    if name == "one_sample":
        return g, np.int32([95]), np.float32([1.5])
    if name == "ragged":  # N a multiple of no tile
        n = 3 * 4096 + 77
        return g, rng.integers(0, 96, n).astype(np.int32), rng.normal(0, 1, n).astype(np.float32)
    if name == "one_key":
        return g, np.full(9000, 7, np.int32), rng.normal(0, 1, 9000).astype(np.float32)
    assert name == "integrate_band_major"
    return integrate_inputs()


@pytest.mark.parametrize("name", ["key0_zeros", "neg_zero_grid", "top_keys", "empty", "one_sample", "ragged",
                                  "one_key", "integrate_band_major"])
def test_route_emulation_bit_exact(name):
    grid, idx, vals = case(name)
    plain = acc.grid_accumulate_plain(torch.as_tensor(grid.copy()), torch.as_tensor(idx),
                                      torch.as_tensor(vals)).numpy()
    want = np.asarray(jnp.asarray(grid).at[jnp.asarray(idx)].add(jnp.asarray(vals)))
    np.testing.assert_array_equal(plain.view(np.uint32), want.view(np.uint32))
    if name == "neg_zero_grid":  # +0.0 turned voxels 1, 3 and 4 from -0.0 into +0.0; 2 stays -0.0
        assert want[[1, 3, 4]].view(np.uint32).tolist() == [0, 0, 0] and want[2].view(np.uint32) == 0x80000000
    for max_bits, chunks in ROUTES:
        got = emulate(grid, idx, vals, max_bits, chunks)
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32), err_msg=f"{max_bits}/{chunks}")
    if name == "integrate_band_major":  # the map's own inputs hold masked zeros of both signs
        assert (vals.view(np.uint32) == 0).any() and (vals.view(np.uint32) == 0x80000000).any()
        assert (vals == 0).sum() > 100 and len(acc.digit_plan(grid.size)) == 2


def test_digit_plan():
    assert acc.digit_plan(29_924_160) == [(0, 9), (9, 8), (17, 8)]  # CLEVR: 25 key bits
    assert acc.digit_plan(238_693_828) == [(0, 7), (7, 7), (14, 7), (21, 7)]  # google_earth, the 8-scene map: 28
    assert acc.digit_plan(238_693_828, 10) == [(0, 10), (10, 9), (19, 9)]
    assert acc.digit_plan((1 << 20) + 1) == [(0, 7), (7, 7), (14, 7)]
    assert acc.digit_plan(1) == [(0, 1)] and acc.digit_plan(2) == [(0, 1)] and acc.digit_plan(3) == [(0, 2)]
    assert acc.digit_plan(1 << 31, 8) == [(0, 8), (8, 8), (16, 8), (24, 7)]
