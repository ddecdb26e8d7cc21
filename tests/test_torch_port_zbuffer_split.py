"""The work split of the z-buffer kernels (`csrc/zbuffer_min.cu`) on the CPU:
a torch emulation of how each route divides the points among blocks, held
bit-exact to the JAX Pallas kernel (`splat_pallas.zbuffer_min` in interpret
mode) and XLA's scatter-min on small analogues of every case chip_smoke.py
runs on the card.

tile route: grid (parts, B); block (j, b) takes part j of each of the
`segments` equal point ranges of image b and keeps a window of `tile_rows`
target rows, centred on its part's place in the range, in shared memory.
Points in the window merge there, points outside it merge straight into
the output, then the window's entries merge into the output. l2 route:
block (j, b) takes part j of image b's points and merges each into the
output. Both merge into an output filled with INT32_MAX. A block reads its
range with 16-byte loads where pix and key share their offset from 16-byte
alignment, one int at a time for the head and tail. The emulation is for
these tests only; nothing in the port calls it. The route and launch shape
come from the port's own `zbuffer_plan`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgam_neurips22_tpu.ops.splat_pallas import zbuffer_min as j_zbuffer_min
from sgam_neurips22_tpu_torch.ops.zbuffer import IMAX, ROUTES, TILE_BYTES, ZbufferPlan, zbuffer_min_plain, zbuffer_plan
from torch_port_common import t


def _parts(length: int, parts: int):
    return [(length * j // parts, length * (j + 1) // parts) for j in range(parts)]


def tile_route(pix, key, h, w, plan: ZbufferPlan):
    """(winners [B, h*w], how often each point was read [B, P]) as the tile
    kernel's blocks compute them."""
    b, p = pix.shape
    n, rows = h * w, plan.tile_rows
    seg_len = p // plan.segments
    assert seg_len * plan.segments == p and 1 <= rows <= h
    out = torch.full((b, n), IMAX, dtype=torch.int32)
    seen = torch.zeros((b, p), dtype=torch.int64)
    for bi in range(b):
        for lo, hi in _parts(seg_len, plan.parts):
            center = (lo + hi) // 2 * h // seg_len
            row0 = max(0, min(center - rows // 2, h - rows))
            t0, tn = row0 * w, rows * w
            idx = torch.cat([torch.arange(s * seg_len + lo, s * seg_len + hi) for s in range(plan.segments)])
            seen[bi, idx] += 1
            pp, kk = pix[bi, idx], key[bi, idx]
            ok = (kk != IMAX) & (pp >= 0) & (pp < n)
            inside = ok & (pp >= t0) & (pp < t0 + tn)
            window = torch.full((tn,), IMAX, dtype=torch.int32)
            window.scatter_reduce_(0, (pp[inside] - t0).long(), kk[inside], "amin")
            out[bi].scatter_reduce_(0, pp[ok & ~inside].long(), kk[ok & ~inside], "amin")
            out[bi, t0:t0 + tn] = torch.minimum(out[bi, t0:t0 + tn], window)
    return out, seen


L2_THREADS = 256  # the l2 kernel's block size


def l2_route(pix, key, h, w, plan: ZbufferPlan, offset: int = 0):
    """(winners, how often each point was read) as the l2 kernel's blocks
    compute them: the plan.parts * L2_THREADS threads of an image take its
    points in turn, one int each for the head (the ints before the first
    16-byte boundary, pix and key `offset` ints past one) and the tail, one
    int4 each between."""
    b, p = pix.shape
    threads = plan.parts * L2_THREADS
    out = torch.full((b, h * w), IMAX, dtype=torch.int32)
    seen = torch.zeros((b, p), dtype=torch.int64)
    head = min(p, (4 - offset) % 4)
    nv = (p - head) // 4
    e = torch.arange(p)
    thread = torch.where(e < head, e, torch.where(e < head + 4 * nv, (e - head) // 4, e - head - 4 * nv)) % threads
    block = thread // L2_THREADS
    for bi in range(b):
        for j in range(plan.parts):
            idx = torch.nonzero(block == j).flatten()
            seen[bi, idx] += 1
            pp, kk = pix[bi, idx], key[bi, idx]
            ok = (kk != IMAX) & (pp >= 0) & (pp < h * w)
            out[bi].scatter_reduce_(0, pp[ok].long(), kk[ok], "amin")
    return out, seen


def _splat(rng, b, n_src, h, w, shift_rows, spread=0):
    """n_src sources of h x w points in scanline order, each landing `shift`
    rows below its own pixel (plus up to `spread` rows of noise), 15%
    invalid: the point order of a splat. Keys: 12-bit z over a point index."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pix, valid = [], []
    for s in range(n_src):
        dy = shift_rows * s + rng.integers(-spread, spread + 1, (b, h, w))
        ty = ys[None] + dy
        pix.append(ty * w + xs[None])
        valid.append((ty >= 0) & (ty < h))
    pix = np.stack(pix, 1).reshape(b, -1)
    ok = np.stack(valid, 1).reshape(b, -1) & (rng.random(pix.shape) > 0.15)
    key = (rng.integers(0, 4096, pix.shape) << 19) | np.arange(pix.shape[1])
    return np.where(ok, pix, 0).astype(np.int32), np.where(ok, key, IMAX).astype(np.int32)


def _pool(rng, b, p, h, w, recycled):
    """Pool-splat keys: uint32 zq << 20 | slot with zq on both sides of 2048,
    xor 0x80000000 into int32; slots in scanline order, or in shuffled runs
    of 16 as ring recycling leaves them; 30% invalid."""
    pix = (np.arange(p) % (h * w))[None].repeat(b, 0)
    if recycled:
        runs = np.argsort(rng.random((b, p // 16)), axis=1)
        pix = np.take_along_axis(pix.reshape(b, -1, 16), runs[..., None], axis=1).reshape(b, p)
    zq = rng.integers(0, 4096, (b, p)).astype(np.uint32)
    key = (((zq << np.uint32(20)) | np.arange(p, dtype=np.uint32)) ^ np.uint32(0x80000000)).view(np.int32)
    ok = rng.random((b, p)) > 0.3
    return np.where(ok, pix, 0).astype(np.int32), np.where(ok, key, IMAX).astype(np.int32)


def _case(name):
    """(pix, key, h, w, tile plan): a small analogue of a chip_smoke case,
    with a window smaller than the image so that points fall outside it."""
    rng = np.random.default_rng(sum(map(ord, name)))
    h, w = 12, 20
    if name == "flythrough":  # 5 sources, forward-moving rows
        pix, key = _splat(rng, 1, 5, h, w, shift_rows=1)
    elif name == "scenes":
        pix, key = _splat(rng, 3, 5, h, w, shift_rows=1, spread=1)
    elif name == "train":  # identity poses: exact 2-way collisions on every pixel
        pix, key = _splat(rng, 4, 2, h, w, shift_rows=0)
    elif name == "google_earth":  # rows spread far from the source row
        pix, key = _splat(rng, 1, 3, h, w, shift_rows=2, spread=5)
    elif name in ("pool_coherent", "pool_recycled"):
        pix, key = _pool(rng, 4, 4 * h * w, h, w, name == "pool_recycled")
    elif name == "collisions_50way":
        pix, key = _splat(rng, 2, 2, h, w, shift_rows=0)
        pix[:, 30:80] = 77
        key[:, 30:80] = rng.integers(-2**31, IMAX, (2, 50))
    elif name == "all_invalid":
        pix, key = np.zeros((2, 3 * h * w), np.int32), np.full((2, 3 * h * w), IMAX, np.int32)
    elif name == "out_of_range":
        pix, key = _splat(rng, 2, 3, h, w, shift_rows=1)
        pix[:, ::7] = rng.integers(-500, h * w + 500, pix[:, ::7].shape)
    elif name == "ragged":  # P not a multiple of 4 nor of h*w: one segment
        pix, key = _splat(rng, 2, 3, h, w, shift_rows=1)
        pix, key = pix[:, :-5], key[:, :-5]
    elif name == "odd_image":  # h*w indivisible by the window or by 4
        h, w = 11, 13
        pix, key = _splat(rng, 2, 3, h, w, shift_rows=1, spread=2)
    p = pix.shape[1]
    segments = p // (h * w) if p % (h * w) == 0 else 1
    return pix, key, h, w, ZbufferPlan("tile", 3, segments, 5)


CASES = ["flythrough", "scenes", "train", "google_earth", "pool_coherent", "pool_recycled", "collisions_50way",
         "all_invalid", "out_of_range", "ragged", "odd_image"]


def _reference(pix, key, h, w):
    """The JAX Pallas kernel in interpret mode, checked against XLA's
    scatter-min with mode="drop". The Pallas kernel's contract takes ids in
    [0, h*w) only, so it gets each out-of-range point as an invalid one
    (pixel 0, key INT32_MAX): what dropping it means. `.at[]` reads a
    negative id from the end, as numpy does, so XLA gets each negative id
    as h*w, which mode="drop" drops."""
    bad = (pix < 0) | (pix >= h * w)
    pix_in, key_in = np.where(bad, 0, pix), np.where(bad, IMAX, key)
    pallas = np.asarray(j_zbuffer_min(jnp.asarray(pix_in), jnp.asarray(key_in), h, w, chunk=128, group=4,
                                      interpret=True))
    xla = np.stack([np.asarray(jnp.full((h * w,), IMAX, jnp.int32).at[p].min(k, mode="drop"))
                    for p, k in zip(np.where(pix < 0, h * w, pix), key)])
    np.testing.assert_array_equal(pallas, xla)
    return pallas


@pytest.mark.parametrize("name", CASES)
def test_tile_route_split_bit_exact_vs_pallas(name):
    pix, key, h, w, plan = _case(name)
    out, seen = tile_route(t(pix), t(key), h, w, plan)
    assert bool((seen == 1).all()), "every point is read by exactly one block"
    np.testing.assert_array_equal(out.numpy(), _reference(pix, key, h, w))


@pytest.mark.parametrize("name,offset", [("flythrough", 0), ("google_earth", 1), ("pool_recycled", 2),
                                         ("out_of_range", 3), ("odd_image", 1)])
def test_l2_route_split_bit_exact_vs_pallas(name, offset):
    pix, key, h, w, _ = _case(name)
    out, seen = l2_route(t(pix), t(key), h, w, ZbufferPlan("l2", 2, 1, 0), offset)
    assert bool((seen == 1).all())
    np.testing.assert_array_equal(out.numpy(), _reference(pix, key, h, w))


@pytest.mark.parametrize("b,p,h,w,route,parts,segments,rows", [
    (1, 327680, 256, 256, "l2", 528, 1, 0),  # flythrough
    (8, 327680, 256, 256, "tile", 16, 5, 200),  # scenes_8
    (16, 131072, 256, 256, "tile", 8, 2, 200),  # train
    (1, 196608, 256, 256, "l2", 528, 1, 0),  # google_earth
    (1, 81920, 256, 256, "l2", 528, 1, 0),  # flythrough at splat_stride 2: (h/2)(w/2) points a source
    (8, 81920, 256, 256, "l2", 66, 1, 0),  # 8 scenes at splat_stride 2: too few points a block for the window
    (1, 49152, 256, 256, "l2", 528, 1, 0),  # google_earth at splat_stride 2
    (16, 262144, 256, 256, "tile", 8, 4, 200),  # pool_coherent / pool_recycled
    (1, 1 << 20, 1024, 1024, "l2", 528, 1, 0),  # large
    (8, 327679, 256, 256, "tile", 16, 1, 200),  # ragged P: one segment
    (8, 5 * 255 * 253, 255, 253, "tile", 16, 5, 202),  # odd image
    (2, 1 << 20, 2, 60000, "l2", 264, 1, 0),  # a row wider than the window
])
def test_plan_at_chip_smoke_shapes(b, p, h, w, route, parts, segments, rows):
    plan = zbuffer_plan(b, p, h, w)
    assert plan == ZbufferPlan(route, parts, segments, rows)
    assert plan.route in ROUTES
    if plan.route == "tile":
        assert 1 <= plan.tile_rows <= h and plan.tile_rows * w * 4 <= TILE_BYTES
        assert p % plan.segments == 0 and 4 * (p // plan.parts) >= plan.tile_rows * w


@pytest.mark.parametrize("name", ["scenes", "pool_recycled", "odd_image"])
def test_window_of_the_whole_image(name):
    """Where TILE_BYTES holds the whole image (these small ones), the plan's
    window has h rows and every point merges in shared memory; the tile
    route at the plan's block count still gives the plain version's
    winners, and so does the route the plan picks."""
    pix, key, h, w, _ = _case(name)
    plan = zbuffer_plan(*pix.shape, h, w)
    p = pix.shape[1]
    whole = ZbufferPlan("tile", plan.parts, p // (h * w) if p % (h * w) == 0 else 1, min(h, TILE_BYTES // (4 * w)))
    assert whole.tile_rows == h
    ref = zbuffer_min_plain(t(pix), t(key), h, w).numpy()
    np.testing.assert_array_equal(tile_route(t(pix), t(key), h, w, whole)[0].numpy(), ref)
    route = tile_route if plan.route == "tile" else l2_route
    np.testing.assert_array_equal(route(t(pix), t(key), h, w, plan)[0].numpy(), ref)


def _for_each_point_split(p_off: int, k_off: int, n: int):
    """(head, vectors, tail) of the kernels' for_each_point for a range of n
    ints whose pix and key start p_off and k_off ints past 16-byte alignment."""
    head = n
    if p_off == k_off:
        head = min(n, (4 - p_off) % 4)
    nv = (n - head) // 4
    return head, nv, n - head - 4 * nv


def test_vector_loads_cover_every_point_once():
    """Head, 16-byte loads and tail partition every range, for every pair
    of offsets from 16-byte alignment; the loads start aligned."""
    for p_off in range(4):
        for k_off in range(4):
            for n in range(23):
                head, nv, tail = _for_each_point_split(p_off, k_off, n)
                assert head + 4 * nv + tail == n and min(head, nv, tail) >= 0
                if p_off != k_off:
                    assert head == n
                elif nv:
                    assert (p_off + head) % 4 == 0 and head < 4 and tail < 4
