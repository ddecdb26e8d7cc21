#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (`sgam_neurips22_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--profile] [--out DIR]

From the repository root. It builds the port's CUDA kernels from csrc/
(five sources, five kernels), holds each against its plain PyTorch version
on the card at the shapes the paths launch it at and times both (and the
one-call library equivalent; the z-buffer merge bit-exact at the shape and
point order of each of its callers, the JAX package's map-requery pool
splat and google_earth among them, on both of its routes, see
check_zbuffer; the codeword search at P = 256, 2048 and 4096
and the codebook phase's P = K = 2048, and also on a clustered codebook
against float64 and on exact ties, see check_nearest_codeword), then
drives the port's three paths with the flagship clevr-infinite model
(seeded random weights):

- unroll: one scene's flythrough through
  `InfiniteSceneGeneration.scene_expansion` (batch 1, plain attention),
  checking that the z-buffer and codeword kernels ran once per frame and
  the flash-attention kernel never; then one full-width step on the card
  against the same step on the CPU;
- unroll_batched: 8 scenes at once through `scene_expansion_batched`
  (batch 8, flash attention), checking one z-buffer and one codeword launch
  per step and 7 flash-attention launches per step, with the device's idle
  share from a profiled unroll; then one step of 2 scenes on the card
  against the CPU;
- train: the conditional-generation GAN training step as `bench.py
  --config train_conditional` defines it (batch 16, n_src 2, n_embed
  16384, remat, flash attention, disc_start 0, Adam (0.5, 0.9), LPIPS with
  seeded random weights) through `create_train_state` and `train_step`:
  one warm-up step and 3 timed steps, checking finite losses, that every
  trainable parameter moved and every frozen one did not, the kernel
  launches per step (z-buffer 1, codeword 1, flash forward 12, dQ 7,
  dK/dV 7) and the device's idle share from a profiled step; then
  parity_train: one step at batch 2 on the card against the same step on
  the CPU (logs, codeword indices, the discriminator's running statistics,
  and every trainable gradient, both devices' also against the step's
  gradients in float64 on the CPU).

Each phase prints one JSON line with its seconds; --out DIR also writes the
details to DIR/chip_smoke.json and nvcc's register report to
DIR/chip_smoke_ptxas.txt. The last line is {"ok": true, "device": {...}}
and is printed only when every check passed. It exits non-zero without
that line when CUDA is unavailable or any check fails. --profile adds a
torch.profiler pass over one more batch-1 unroll.
"""
from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM data-sheet peaks (NVIDIA, dense): HBM3 bandwidth, the f32 rate
# of the CUDA cores and the TF32 rate of the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
SEED = 0
H = W = 256
FRAMES = 24  # frames generated per unroll: the flythrough grid is (FRAMES + 1) x 1
SCENES = 8  # scenes of the batched unroll, as bench.py's batched_8_scenes
# the forward: the main path's two shapes, ragged S, and together every (C,
# BQ) tile that its launch rule picks on an H100 (BQ 64 / 16, 32 / 16 at C=512);
# the B=16 ragged shapes run the large tiles with a partial last query block,
# and at S=280 a last key tile of 24 keys, past which a whole warp's keys lie
FLASH_SHAPES = ((8, 4096, 256), (8, 256, 512), (16, 4096, 256), (2, 300, 128), (2, 300, 64), (16, 256, 512),
                (3, 77, 512), (5, 1000, 512), (2, 300, 256), (16, 1024, 128), (16, 1024, 64), (16, 300, 128),
                (16, 280, 256), (16, 280, 128), (16, 280, 64))
FLASH_TILES = {(c, bq) for c in (64, 128, 256, 512) for bq in (16, 32 if c == 512 else 64)}
# the codeword search: latents P of the batch-1 unroll, the 8-scene unroll
# and the training step (K=16384); the codebook phase's (P, K); the
# clustered case's P; identical codeword pairs of the exact-tie case
VQ_P = (256, SCENES * 256, 4096)
VQ_CODEBOOK_PHASE_P, VQ_CODEBOOK_PHASE_K = 2048, 2048
VQ_CLUSTERED_P = 2048
VQ_TIES = ((100, 9000), (130, 250), (16, 19))
# the z-buffer merge's map-requery pool splat: one call merges 2 sub-chunks of
# 2^18 slots for each of 8 scenes (sgam_neurips22_tpu/mapping/tsdf.py:123,
# 139, 929-940); keys carry a 20-bit slot; CLEVR's pool (near, far) from
# auto_config (depth range (7, 16), sdf_trunc 0.5); ring recycling
# interleaves runs of POOL_RUN slots
POOL_ROWS, POOL_P, POOL_IDX_BITS, POOL_RUN, POOL_INVALID = 16, 1 << 18, 20, 256, 0.3
POOL_NEAR_FAR = (0.8 * 7.0 - 0.5, 1.2 * 16.0 + 0.5)
ZB_LARGE = 1024  # the side of an image whose window would hold too few rows: the l2 route
ZB_KERNELS = "zbuffer_tile_kernel|zbuffer_l2_kernel"  # the z-buffer's own kernels in a profile
BACKWARD_SHAPES = ((16, 4096, 256), (16, 256, 512), (2, 300, 128), (2, 300, 64))  # training step x2, ragged S x2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def cuda_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 50, warmup: int = 5, match: str | None = None) -> float:
    """Device time per fn() call: the summed time of every kernel that
    `iters` calls launched (only those whose name matches the regex
    `match`, if given), from torch.profiler, over `iters`. Unlike cuda_ms
    it leaves out the gaps while the host prepares each launch."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.self_device_time_total for ev in prof.key_averages()
             if ev.device_type == DeviceType.CUDA and (match is None or re.search(match, ev.key)))
    return us / 1e3 / iters


def timings(torch, kernel, plain, library) -> dict:
    """Device time per call of the kernel's wrapper, its plain version and
    the one-call library equivalent, plus each call's CUDA-event time
    back to back (which includes host launch overhead when the device
    outruns the host)."""
    out = {}
    for name, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        out[f"{name}ms"] = device_ms(torch, fn)
        out[f"{name}call_ms"] = cuda_ms(torch, fn)
    return out


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def projected(torch, np, grid, k, n_src: int, depth_range, rng, dev):
    """(pix [1, P, 2], z [1, P], valid [1, P]) of n_src frames with depths
    uniform in depth_range at grid rows 0..n_src-1 projected into row
    n_src, in source-scanline order (P = n_src * H * W)."""
    from sgam_neurips22_tpu_torch.geometry.camera import pose_matrix
    from sgam_neurips22_tpu_torch.geometry.splat import project_points

    t_tgt = grid.w2c(n_src)
    rel = np.stack([t_tgt @ np.linalg.inv(grid.w2c(i)) for i in range(n_src)]).astype(np.float32)
    depths = torch.tensor(rng.uniform(*depth_range, (1, n_src, H, W)), dtype=torch.float32, device=dev)
    ks = torch.tensor(np.tile(np.asarray(k, np.float32), (n_src, 1, 1)), device=dev)
    src2tgt = pose_matrix(torch.tensor(rel[:, :3, :3], device=dev), torch.tensor(rel[:, :3, 3], device=dev))
    return project_points(depths, ks[:1], ks[None], src2tgt[None])


def pool_keys(torch, pix, z, valid, rng):
    """(pix, key) of the map-requery pool splat (sgam_neurips22_tpu/mapping/
    tsdf.py:862-880, 931-940): the uint32 key zq << 20 | slot, zq the 12-bit
    z over CLEVR's pool range, sign-flipped into int32, so that every key
    with zq < 2048 is negative; POOL_INVALID of the slots invalid (every
    point off the image among them), with pixel 0 and key INT32_MAX."""
    from sgam_neurips22_tpu_torch.ops.zbuffer import IMAX

    near, far = POOL_NEAR_FAR
    b, p = z.shape
    zq = torch.clamp((z - near) / (far - near) * 4095.0, 0, 4095).long()
    key = ((zq << POOL_IDX_BITS) | torch.arange(p, device=z.device)) ^ 0x80000000
    key = torch.where(key >= 2**31, key - 2**32, key).to(torch.int32)
    keep = (1 - POOL_INVALID) / float(valid.float().mean())  # so that POOL_INVALID of all slots are invalid
    ok = valid & torch.tensor(rng.random((b, p)) < keep, device=z.device)
    return torch.where(ok, pix, 0), torch.where(ok, key, IMAX)


def zbuffer_cases(torch, np, gen, rng) -> dict:
    """{case: (pix, key, h, w)}, each at the shape and in the point order of
    one caller of the z-buffer merge (random depths, seeded):

    - flythrough: the batch-1 unroll's splat, 5 clevr sources at grid rows
      0-4 projected into row 5, depths in (8, 14): [1, 327680];
    - scenes_8: 8 such splats, the 8-scene unroll: [8, 327680];
    - train: the training step's, train_batch's n_src 2 with identity
      poses, so that every point lands on its own pixel and each pixel
      takes an exact 2-way collision: [16, 131072];
    - google_earth: 3 sources of the google_earth grid with its intrinsics
      at 256^2 and depths in (0.1, 4.77), whose forward motion spreads a
      chunk's points over many target rows: [1, 196608];
    - pool_coherent: the map-requery pool splat's one call at 8 scenes (2
      sub-chunks of 2^18 slots each), slots booked in source-scanline
      order (4 clevr sources a row), keys from pool_keys: [16, 262144];
    - pool_recycled: the same points with the slots in runs of POOL_RUN,
      the runs shuffled, as ring recycling leaves them;
    - large: uniform ids over a ZB_LARGE^2 image, 20% invalid: [1, 2^20],
      4 MB of winners, 18 times what a block's shared memory holds."""
    from sgam_neurips22_tpu_torch.geometry.camera import pose_matrix
    from sgam_neurips22_tpu_torch.geometry.splat import packed_keys, project_points
    from sgam_neurips22_tpu_torch.ops.zbuffer import IMAX
    from sgam_neurips22_tpu_torch.pipeline.trajectory import prepare_grid

    dev = gen.device
    clevr, clevr_depths = (gen.grid, gen.grid.K), (8, 14)
    fly = [packed_keys(*projected(torch, np, *clevr, 5, clevr_depths, rng, dev), W) for _ in range(SCENES)]
    cases = {"flythrough": (*fly[0], H, W), "scenes_8": (*(torch.cat(x) for x in zip(*fly)), H, W)}
    tb = train_batch(torch, np, TRAIN_BATCH, dev)
    proj = project_points(tb["src_depths"], tb["Ks"][:, 0], tb["Ks"], pose_matrix(tb["R_rels"], tb["t_rels"]))
    cases["train"] = (*packed_keys(*proj, W), H, W)
    ge = prepare_grid("google_earth", (4, 1))
    cases["google_earth"] = (*packed_keys(*projected(torch, np, ge, ge.K, 3, (0.1, 4.77), rng, dev), W), H, W)
    rows = [projected(torch, np, *clevr, 4, clevr_depths, rng, dev) for _ in range(POOL_ROWS)]
    pix, z, valid = (torch.cat(x) for x in zip(*rows))
    pix = pix[..., 1] * W + pix[..., 0]
    cases["pool_coherent"] = (*pool_keys(torch, pix, z, valid, rng), H, W)
    runs = torch.tensor(np.argsort(rng.random((POOL_ROWS, POOL_P // POOL_RUN)), axis=1), device=dev)
    order = (runs[:, :, None] * POOL_RUN + torch.arange(POOL_RUN, device=dev)).reshape(POOL_ROWS, POOL_P)
    cases["pool_recycled"] = (*pool_keys(torch, *(x.gather(1, order) for x in (pix, z, valid)), rng), H, W)
    n = ZB_LARGE * ZB_LARGE
    lp = torch.tensor(rng.integers(0, n, (1, n)), dtype=torch.int32, device=dev)
    lk = torch.tensor(rng.integers(-2**31, IMAX, (1, n)), dtype=torch.int32, device=dev)
    bad = torch.tensor(rng.random((1, n)) < 0.2, device=dev)
    cases["large"] = (torch.where(bad, 0, lp), torch.where(bad, IMAX, lk), ZB_LARGE, ZB_LARGE)
    return cases


def collision_case(torch, rng, b: int, p: int, dev):
    """Every point on one of 1024 pixels, 20% invalid, keys over the whole
    int32 range: about 256 points a pixel at P = 327680."""
    from sgam_neurips22_tpu_torch.ops.zbuffer import IMAX

    cp = torch.tensor(rng.integers(0, 1024, (b, p)), dtype=torch.int32, device=dev)
    ck = torch.tensor(rng.integers(-2**31, IMAX, (b, p)), dtype=torch.int32, device=dev)
    bad = torch.tensor(rng.random((b, p)) < 0.2, device=dev)
    return torch.where(bad, 0, cp), torch.where(bad, IMAX, ck)


def zbuffer_edge_cases(torch, rng, dev) -> dict:
    """{case: (pix, key, h, w)} at the edges of the kernel's contract, each
    at a batch of 1 (the l2 route) and of 8 (the tile route): P not a
    multiple of 4 (rows off 16-byte alignment; one segment on the tile
    route), both pointers 4 bytes past 16-byte alignment, the two pointers
    off by different amounts, ids outside [0, h*w) (dropped), an image
    whose h*w is odd (on the tile route a window of 202 rows of 253), and
    keys of -1 beside INT32_MAX (whose bits differ from it in the sign
    alone)."""
    from sgam_neurips22_tpu_torch.ops.zbuffer import IMAX

    def draw(b, p, lo, hi):
        pix = torch.tensor(rng.integers(lo, hi, (b, p)), dtype=torch.int32, device=dev)
        key = torch.tensor(rng.integers(-2**31, IMAX, (b, p)), dtype=torch.int32, device=dev)
        return pix, torch.where(torch.tensor(rng.random((b, p)) < 0.2, device=dev), IMAX, key)

    def offset(x, by):  # the same values at a data pointer `by` int32s past an allocation's
        out = torch.empty(x.numel() + by, dtype=x.dtype, device=dev)[by:].view(x.shape)
        return out.copy_(x)

    cases = {}
    for b in (1, SCENES):
        flat = draw(b, 5 * H * W + 3, 0, H * W)
        cases.update({
            f"ragged_p_b{b}": (*draw(b, 5 * H * W - 1, 0, H * W), H, W),
            f"offset_both_b{b}": (offset(flat[0], 1), offset(flat[1], 1), H, W),
            f"offset_differ_b{b}": (offset(flat[0], 1), offset(flat[1], 2), H, W),
            f"out_of_range_b{b}": (*draw(b, 5 * H * W, -1000, H * W + 1000), H, W),
            f"odd_image_b{b}": (*draw(b, 5 * 255 * 253, 0, 255 * 253), 255, 253),
            f"minus_one_b{b}": (flat[0], torch.where(flat[1] < 0, -1, IMAX).to(torch.int32), H, W),
        })
    return cases


def check_zbuffer(torch, np, gen, failures):
    """The z-buffer merge against its plain version, bit-exact, at the
    shape of every caller (zbuffer_cases), each also on a collision-heavy
    case at its shape (collision_case), and on the contract's edges
    (zbuffer_edge_cases, not timed). Each row gives the route and launch
    shape that `zbuffer_plan` picks; the run fails unless every route of
    ROUTES ran at a timed case ("routes"). Each timed shape gives the
    device time of the whole call (ms), of the z-buffer's own kernels alone
    (kernel_only_ms: the call less the INT32_MAX fill), the plain version's
    and `scatter_reduce` amin's, and the bound: each point's pix and key
    read once and the image written once. The reported times and bound are
    the flythrough's; every shape's are under "shapes"."""
    from sgam_neurips22_tpu_torch.ops.zbuffer import IMAX, ROUTES, zbuffer_min, zbuffer_min_plain, zbuffer_plan

    dev = gen.device
    rng = np.random.default_rng(SEED)
    shapes, edges = [], []

    def exact(pix, key, h, w):
        out, ref = zbuffer_min(pix, key, h, w), zbuffer_min_plain(pix, key, h, w)
        torch.cuda.synchronize()
        return torch.equal(out, ref), int((out.long() - ref.long()).abs().max())

    for name, (pix, key, h, w) in zbuffer_cases(torch, np, gen, rng).items():
        b, p = pix.shape
        ok_case, err_case = exact(pix, key, h, w)
        ok_coll, err_coll = exact(*collision_case(torch, rng, b, p, dev), h, w)
        base, idx = torch.full((b, h * w), IMAX, dtype=torch.int32, device=dev), pix.long()
        b_ms, b_by = bound(2 * 4 * b * p + 4 * b * h * w, 0)
        row = {
            "case": name, "shape": {"pix": [b, p], "pixels": h * w}, **zbuffer_plan(b, p, h, w)._asdict(),
            "ok": ok_case and ok_coll,
            "bit_exact": ok_case, "collisions_bit_exact": ok_coll, "max_abs_err": max(err_case, err_coll),
            "valid_points": int((key != IMAX).sum()),
            **timings(torch, lambda: zbuffer_min(pix, key, h, w),
                      lambda: zbuffer_min_plain(pix, key, h, w),
                      lambda: torch.scatter_reduce(base, 1, idx, key, "amin")),
            "kernel_only_ms": device_ms(torch, lambda: zbuffer_min(pix, key, h, w), match=ZB_KERNELS),
            "bound_ms": b_ms, "bound_by": b_by,
        }
        row["bound_share"] = b_ms / row["ms"]
        shapes.append(row)
        if not row["ok"]:
            failures.append(f"zbuffer_min differs from zbuffer_min_plain, case {name} at pix [{b}, {p}]: {row}")
        del pix, key, base, idx
    for name, (pix, key, h, w) in zbuffer_edge_cases(torch, rng, dev).items():
        ok, err = exact(pix, key, h, w)
        edges.append({"case": name, "shape": {"pix": list(pix.shape), "pixels": h * w},
                      "route": zbuffer_plan(*pix.shape, h, w).route, "ok": ok, "max_abs_err": err})
        if not ok:
            failures.append(f"zbuffer_min differs from zbuffer_min_plain, edge case {name}: {edges[-1]}")
    routes = {r: [x["case"] for x in shapes if x["route"] == r] for r in ROUTES}
    missing = [r for r, cases in routes.items() if not cases]
    if missing:
        failures.append(f"zbuffer_min: no timed case ran the routes {missing}")
    ok = all(x["ok"] for x in shapes + edges) and not missing
    return {
        "name": "zbuffer_min", "route": "cuda", "routes": routes,
        "source": "sgam_neurips22_tpu_torch/csrc/zbuffer_min.cu",
        "replaces": "sgam_neurips22_tpu/ops/splat_pallas.py:88",
        "ok": ok, "bit_exact": ok, "max_abs_err": max(x["max_abs_err"] for x in shapes + edges),
        **{k: v for k, v in shapes[0].items()
           if k not in ("case", "ok", "bit_exact", "max_abs_err", "route", "parts", "segments", "tile_rows")},
        "shapes": shapes, "edges": edges,
    }


def near_ties_ok(torch, z, cb, idx, ref_idx) -> tuple[int, bool]:
    """(rows whose indices differ, whether every one is an f32 near-tie):
    the two codewords' exact (f64) scores e2 - 2 z.e within 1e-6 of the
    scale of their f32 sums."""
    rows = torch.nonzero(idx != ref_idx).flatten()
    if len(rows) == 0:
        return 0, True
    z64 = z[rows].double()
    a, b = (cb[i[rows].long()].double() for i in (idx, ref_idx))
    score = [(e * e).sum(1) - 2 * (z64 * e).sum(1) for e in (a, b)]
    scale = torch.maximum(*((e * e).sum(1) + 2 * (z64 * e).abs().sum(1) for e in (a, b)))
    return len(rows), bool(((score[0] - score[1]).abs() <= 1e-6 * scale).all())


def distance_gate_share(torch, z, cb, idx, dist) -> float:
    """The largest error of a winning distance against the float64
    ||z - e_idx||^2, as a share of its gate 1e-6 (||z||^2 + ||e_idx||^2 +
    2 sum |z e_idx|): the scale of the f32 sums that make the distance."""
    z64, e64 = z.double(), cb[idx.long()].double()
    ref = ((z64 - e64) ** 2).sum(1)
    scale = (z64 * z64).sum(1) + (e64 * e64).sum(1) + 2 * (z64 * e64).abs().sum(1)
    return float(((dist.double() - ref).abs() / (1e-6 * scale)).max())


def check_nearest_codeword(torch, codebook, failures):
    """The codeword search against its plain version, on the flagship's
    seeded init codebook (uniform(-1/K, 1/K), K=16384) at the batch-1
    unroll's P=256, the 8-scene unroll's P=2048 and the training step's
    P=4096, and on the codebook phase's (P=2048, a seeded K=2048 init
    codebook): distances at rtol 1e-5, indices equal but at f32 near-ties.
    Then two cases a trained codebook poses. Clustered: e ~ N(0, 1)
    [16384, 256], z = e_j + 0.05 N(0, 1), P=2048, where the distance is a
    small difference of large terms, so rtol 1e-5 fails f32 itself; each
    winning distance must lie within 1e-6 (||z||^2 + ||e||^2 + 2 sum |z e|)
    of the float64 one (gate_share; plain_gate_share is plain f32's, not
    gated), which a product that drops a 3xTF32 correction term misses.
    Exact ties: the clustered codebook with identical codewords at 100 and
    9000 (two K-split ranges), 130 and 250 (one tile, two warps), 16 and 19
    (one warp), and P=256 rows near each: the smaller index must win. Every
    init shape is timed with plain and `cdist` + `argmin`; bound_ms is the
    f32 CUDA-core bound, bound_tc_ms the 3xTF32 one (three TF32 products a
    product at the tensor cores' dense rate), on every row. The reported
    times and bounds are P=256's; every case's are under "shapes"."""
    from sgam_neurips22_tpu_torch.ops.vq import nearest_codeword, nearest_codeword_plain

    dev = codebook.device
    g = torch.Generator(device=dev).manual_seed(SEED)
    cb_init = codebook.detach()
    d = cb_init.shape[1]
    k_small = VQ_CODEBOOK_PHASE_K
    cb_small = (torch.rand((k_small, d), generator=g, device=dev) * 2 - 1) / k_small
    cb_clustered = torch.randn((cb_init.shape[0], d), generator=g, device=dev)

    def near(cb, rows):
        return (cb[rows] + 0.05 * torch.randn((len(rows), d), generator=g, device=dev)).contiguous()

    cases = [(f"init P={p}", torch.randn((p, d), generator=g, device=dev), cb_init) for p in VQ_P]
    cases.append((f"codebook phase P={VQ_CODEBOOK_PHASE_P}",
                  torch.randn((VQ_CODEBOOK_PHASE_P, d), generator=g, device=dev), cb_small))
    rows = torch.randint(0, cb_init.shape[0], (VQ_CLUSTERED_P,), generator=g, device=dev)
    cases.append((f"clustered P={VQ_CLUSTERED_P}", near(cb_clustered, rows), cb_clustered))
    cb_ties = cb_clustered.clone()
    for a, b in VQ_TIES:
        cb_ties[b] = cb_ties[a]
    want = torch.tensor([a for a, _ in VQ_TIES], device=dev).repeat_interleave(-(-256 // len(VQ_TIES)))[:256]
    cases.append(("exact ties P=256", near(cb_ties, want), cb_ties))

    shapes = []
    for name, z, cb in cases:
        (p, d), k = z.shape, cb.shape[0]
        idx, dist = nearest_codeword(z, cb)
        pidx, pdist = nearest_codeword_plain(z, cb)
        torch.cuda.synchronize()
        mismatches, ties_ok = near_ties_ok(torch, z, cb, idx, pidx)
        share = distance_gate_share(torch, z, cb, idx, dist)
        b_ms, b_by = bound(4 * (p * d + k * d) + 8 * p, 2.0 * p * k * d)
        row = {"case": name, "shape": {"P": p, "K": k, "D": d}, "index_mismatches": mismatches,
               "near_ties_ok": ties_ok, "max_abs_err": float((dist - pdist).abs().max()), "gate_share": share,
               "plain_gate_share": distance_gate_share(torch, z, cb, pidx, pdist), "bound_ms": b_ms,
               "bound_by": b_by, "bound_tc_ms": 3 * 2.0 * p * k * d / TF32_FLOP_PER_S * 1e3}
        if name.startswith("clustered"):
            row["ok"] = ties_ok and share <= 1.0
        elif name.startswith("exact ties"):
            row["smaller_index_mismatches"] = int((idx.long() != want).sum())
            row["ok"] = row["smaller_index_mismatches"] == 0
        else:
            row["dist_ok"] = bool(torch.allclose(dist, pdist, rtol=1e-5, atol=0.0))
            row["ok"] = ties_ok and row["dist_ok"]
            row.update(timings(torch, lambda: nearest_codeword(z, cb), lambda: nearest_codeword_plain(z, cb),
                               lambda: torch.cdist(z, cb).argmin(dim=1)))
        if not row["ok"]:
            failures.append(f"nearest_codeword, {name}: {row}")
        shapes.append(row)
    return {
        "name": "nearest_codeword", "route": "cuda",
        "source": "sgam_neurips22_tpu_torch/csrc/nearest_codeword.cu",
        "replaces": "sgam_neurips22_tpu/ops/vq_pallas.py:117",
        "ok": all(x["ok"] for x in shapes), "max_abs_err": max(x["max_abs_err"] for x in shapes),
        "gate_share": max(x["gate_share"] for x in shapes if x["case"].startswith("clustered")),
        **{k: shapes[0][k] for k in ("ms", "call_ms", "plain_ms", "plain_call_ms", "library_ms",
                                     "library_call_ms", "bound_ms", "bound_by", "bound_tc_ms")},
        "shapes": shapes,
    }


def check_flash_attention(torch, failures):
    """The flash-attention forward kernel against its plain version at the
    batched unroll's two shapes (5 and 2 launches a step), the training
    step's two ([16, 4096, 256] x10 and [16, 256, 512] x2), ragged S (300,
    77, 1000, 280, on the small and the large tiles) and further shapes,
    so that every (C, BQ) tile its launch rule can pick runs (each row
    gives the block_rows it ran with; the run fails if a tile of
    FLASH_TILES did not run). Tolerances: out max abs error 1e-4, and 2e-5
    at S=300, the JAX kernel test's; lse 1e-5 relative. The kernel
    multiplies in 3xTF32 on the tensor cores, so it agrees with the plain
    f32 version to f32 rounding, not bit for bit; each row gives the
    larger of its two errors as a share of its tolerance (gate_share), and
    the out error of the kernel and of the plain f32 version against the
    plain version in float64 (f64_max_abs_err, plain_f64_max_abs_err;
    not gated), which says which of the two is the nearer. Bounds from 2
    products of 2*B*S^2*C at the f32 rate of the CUDA cores, and bound_tc_ms, three
    TF32 products per f32 product at the tensor cores' dense rate. The
    reported times and bounds are the (8, 4096, 256) shape's, which takes
    most of the time; every shape's are under "shapes"."""
    from sgam_neurips22_tpu_torch.ops.attention import (
        flash_attention_fwd,
        flash_attention_fwd_block_rows,
        flash_attention_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED)
    shapes, ok = [], True
    for b, s, c in FLASH_SHAPES:
        q, k, v = (torch.randn((b, s, c), generator=g, device="cuda") for _ in range(3))
        out, lse = flash_attention_fwd(q, k, v)
        pout, plse = flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = float((out - pout).abs().max())
        lse_rel = float(((lse - plse).abs() / plse.abs()).max())
        ref64 = flash_attention_plain(q.double(), k.double(), v.double())[0]
        f64_err = [float((x.double() - ref64).abs().max()) for x in (out, pout)]
        del ref64
        tol = 2e-5 if s == 300 else 1e-4
        ok_s = err <= tol and lse_rel <= 1e-5
        ok &= ok_s
        b_ms, b_by = bound(4 * (4 * b * s * c + b * s), 4.0 * b * s * s * c)
        shapes.append({
            "shape": [b, s, c], "block_rows": flash_attention_fwd_block_rows(b, s, c, q.device), "ok": ok_s,
            "max_abs_err": err, "out_tol": tol, "lse_max_rel_err": lse_rel, "lse_tol_rel": 1e-5,
            "gate_share": max(err / tol, lse_rel / 1e-5),
            "f64_max_abs_err": f64_err[0], "plain_f64_max_abs_err": f64_err[1],
            **timings(torch, lambda: flash_attention_fwd(q, k, v),
                      lambda: flash_attention_plain(q, k, v),
                      lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)),
            "bound_ms": b_ms, "bound_by": b_by, "bound_tc_ms": 3 * 4.0 * b * s * s * c / TF32_FLOP_PER_S * 1e3,
        })
        del q, k, v, out, lse, pout, plse
    if not ok:
        failures.append(f"flash_attention_fwd differs from flash_attention_plain: {shapes}")
    missing = FLASH_TILES - {(x["shape"][2], x["block_rows"]) for x in shapes}
    if missing:
        failures.append(f"flash_attention_fwd: no shape ran the (C, BQ) tiles {sorted(missing)}")
    main = shapes[0]
    return {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "sgam_neurips22_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "sgam_neurips22_tpu/ops/attention_pallas.py:81",
        "ok": ok and not missing, "max_abs_err": max(x["max_abs_err"] for x in shapes),
        "gate_share": max(x["gate_share"] for x in shapes),
        **{k: main[k] for k in ("ms", "call_ms", "plain_ms", "plain_call_ms", "library_ms",
                                "library_call_ms", "bound_ms", "bound_by", "bound_tc_ms")},
        "shapes": shapes,
    }


def check_flash_backward(torch, failures) -> list:
    """The two flash-attention backward kernels against their plain versions
    at the training step's two shapes (B=16: 5 and 2 launches a step each)
    and at a ragged S=300 with C=128 and C=64, on the forward's (out, lse)
    of random q, k, v and a random upstream gradient. Tolerances, the gate
    for both kernels: each of dq, dk, dv within 1e-4 of that gradient's
    largest magnitude at the flagship shapes, 3e-5 absolute at S=300 (the
    JAX kernel test's). Both kernels multiply in 3xTF32 on the tensor
    cores, so they agree with the plain f32 versions to f32 rounding, not
    bit for bit; each row gives its error as a share of the gate
    (gate_share). Bounds from the work of _dq_kernel (3 products of [S, S]
    x C: 6*B*S^2*C) and _dkv_kernel (4: 8*B*S^2*C) at the f32 rate of the
    CUDA cores, so that rows compare across kernels and designs, and
    bound_tc_ms, three TF32 products per f32 product at the tensor cores'
    dense rate. The library yardstick is the f32 backward of
    scaled_dot_product_attention on a graph built beforehand; it computes
    dq, dk and dv at once, so both rows carry its time. The reported times
    and bounds are the (16, 4096, 256) shape's; every shape's are under
    "shapes"."""
    from sgam_neurips22_tpu_torch.ops.attention import (
        flash_attention_bwd,
        flash_attention_bwd_plain,
        flash_attention_dkv,
        flash_attention_dkv_plain,
        flash_attention_dq,
        flash_attention_dq_plain,
        flash_attention_fwd,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows = {"flash_attention_dq": [], "flash_attention_dkv": []}
    for b, s, c in BACKWARD_SHAPES:
        q, k, v, dout = (torch.randn((b, s, c), generator=g, device="cuda") for _ in range(4))
        out, lse = flash_attention_fwd(q, k, v)
        dd = (dout * out).sum(dim=-1)
        got = flash_attention_bwd(q, k, v, out, lse, dout)
        ref = flash_attention_bwd_plain(q, k, v, out, lse, dout)
        torch.cuda.synchronize()
        errs = [float((x - r).abs().max()) for x, r in zip(got, ref)]
        tols = [3e-5] * 3 if s == 300 else [1e-4 * float(r.abs().max()) for r in ref]
        ok = all(e <= t for e, t in zip(errs, tols))
        if not ok:
            failures.append(f"flash_attention_bwd differs from flash_attention_bwd_plain at {(b, s, c)}: "
                            f"errors {errs} > tolerances {tols}")
        del got, ref
        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
        lib_out = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg)
        library = lambda: torch.autograd.grad(lib_out, (qg, kg, vg), dout, retain_graph=True)  # noqa: E731
        for name, kernel, plain, n_out, products, grads in (
            ("flash_attention_dq", flash_attention_dq, flash_attention_dq_plain, 1, 3, ("dq",)),
            ("flash_attention_dkv", flash_attention_dkv, flash_attention_dkv_plain, 2, 4, ("dk", "dv")),
        ):
            b_ms, b_by = bound(4 * ((4 + n_out) * b * s * c + 2 * b * s), 2.0 * products * b * s * s * c)
            idx = [("dq", "dk", "dv").index(x) for x in grads]
            rows[name].append({
                "shape": [b, s, c], "ok": ok, "max_abs_err": max(errs[i] for i in idx),
                "tolerance": max(tols[i] for i in idx), "gate_share": max(errs[i] / tols[i] for i in idx),
                **timings(torch, lambda: kernel(q, k, v, dout, lse, dd), lambda: plain(q, k, v, dout, lse, dd),
                          library),
                "bound_ms": b_ms, "bound_by": b_by,
                "bound_tc_ms": 3 * 2.0 * products * b * s * s * c / TF32_FLOP_PER_S * 1e3,
            })
        del q, k, v, dout, out, lse, dd, qg, kg, vg, lib_out, library
    kernels = []
    for name, line, source in (("flash_attention_dq", 120, "flash_attention_dq.cu"),
                               ("flash_attention_dkv", 155, "flash_attention_dkv.cu")):
        shapes, main = rows[name], rows[name][0]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"sgam_neurips22_tpu_torch/csrc/{source}",
            "replaces": f"sgam_neurips22_tpu/ops/attention_pallas.py:{line}",
            "ok": all(x["ok"] for x in shapes), "max_abs_err": max(x["max_abs_err"] for x in shapes),
            "gate_share": max(x["gate_share"] for x in shapes),
            **{k: main[k] for k in ("ms", "call_ms", "plain_ms", "plain_call_ms", "library_ms",
                                    "library_call_ms", "bound_ms", "bound_by", "bound_tc_ms")},
            "library": "scaled_dot_product_attention backward (dq, dk and dv at once)",
            "shapes": shapes,
        })
    return kernels


def ptxas_summary(reports: dict) -> dict:
    """{kernel function: registers and spill bytes} from nvcc's -Xptxas -v."""
    import re

    out = {}
    for log in reports.values():
        fn = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn = m.group(1)
                out[fn] = {}
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and fn:
                out[fn]["spill_stores"], out[fn]["spill_loads"] = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                out[fn]["registers"] = int(m.group(1))
    return out


def model_gflop(torch, cfg) -> dict:
    """FLOPs of one frame's encode and decode at 256^2, counted with
    torch.utils.flop_counter on the meta device (no compute)."""
    from torch.utils.flop_counter import FlopCounterMode

    from sgam_neurips22_tpu_torch.models.vqgan.model import VQModel

    out = {}
    with torch.device("meta"), torch.no_grad():
        model = VQModel(cfg)
        x, m = torch.zeros(1, H, W, 4), torch.zeros(1, H, W, 1, dtype=torch.bool)
        for name, fn in (("encode", lambda: model.encode_prequant(x, m)),
                         ("decode", lambda: model.decode(torch.zeros(1, H // 16, W // 16, cfg.embed_dim)))):
            counter = FlopCounterMode(display=False)
            with counter:
                fn()
            out[name] = counter.get_total_flops() / 1e9
    return out


KERNEL_GROUPS = (  # profiler kernel name -> layer, first match wins
    ("flash_fwd_kernel", "ours: flash_attention_fwd"),
    ("flash_dq_kernel", "ours: flash_attention_dq"),
    ("flash_dkv_kernel", "ours: flash_attention_dkv"),
    (ZB_KERNELS, "ours: zbuffer_min"),
    ("search_kernel|finalize_kernel", "ours: nearest_codeword"),
    ("fprop|dgrad|wgrad|cudnn|nchwToNhwc|nhwcToNchw|conv|fft|pointwise_mult_and_sum_complex|gemm_cf32",
     "conv (cuDNN: implicit GEMM, FFT)"),
    ("gemm", "matmul (attention, plain GEMMs)"),
    ("batch_norm|bn_", "BatchNorm (discriminator)"),
    ("adam|Adam|multi_tensor", "optimizer (Adam)"),
    ("softmax|SoftMax", "softmax"),
    ("reduce_kernel", "reductions (GroupNorm stats, splat z range)"),
    ("", "elementwise / copies / index"),
)


def profile_unroll(torch, unroll, frames: int, timed_s: float) -> dict:
    """Device time by kernel over one more call of unroll(), which makes
    `frames` frames, grouped by layer, and the device's idle share:
    1 - device time / the timed unroll's wall time (the profiler itself
    slows the host, so its own wall time is not used)."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        unroll()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            rows.append((ev.self_device_time_total, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    groups: dict[str, float] = {}
    for us, key, _ in rows:
        label = next(lab for pat, lab in KERNEL_GROUPS if re.search(pat, key))
        groups[label] = groups.get(label, 0.0) + us / 1e3 / frames
    return {
        "profiled_wall_s": wall, "device_busy_ms_per_frame": busy_s * 1e3 / frames,
        "device_idle_share": 1.0 - busy_s / timed_s,
        "ms_per_frame_by_layer": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "top": [{"kernel": k[:120], "ms": us / 1e3, "calls": n} for us, k, n in rows[:25]],
    }


def parity_step(torch, gen, cpu_model, failures, seeds_batch=None) -> dict:
    """Frame 1 of the unroll on the card against the same step on the CPU
    (plain versions), same weights and inputs, stage by stage: for the
    generator's own scene, or for the scenes of seeds_batch at once (the
    flash-attention path at 2 scenes and up, as the batched unroll runs)."""
    from sgam_neurips22_tpu_torch.models.conditioning import get_x
    from sgam_neurips22_tpu_torch.models.vqgan.quantize import nearest_codeword_indices

    if seeds_batch is None:
        gen.reset()
        batch = gen.step_batch(gen.build_plan(), 0, gen.rgb_buf, gen.depth_buf)
    else:
        batch = gen.step_batch(gen.build_plan(), 0, *gen.batched_buffers(seeds_batch))
    flash = batch["src_imgs"].shape[0] >= 2
    model, ds, codec = gen.model, gen.cfg.dataset, gen.codec
    with torch.inference_mode():
        cond = get_x(batch, ds)
        cond_c = get_x({k: v.cpu() for k, v in batch.items()}, ds)
        # 1. conditioning: identical on >= 99.9% of pixels (projection may
        #    round differently at a pixel or z-level boundary)
        same = cond.x.cpu() == cond_c.x
        x_agree = float(same.all(dim=-1).float().mean())
        rgb_agree = float(same[..., :3].all(dim=-1).float().mean())
        # 2. encoder latent from the same x: max error <= 1e-4 of the
        #    latent's largest magnitude (f32 conv sums in another order)
        x, m = cond.x, cond.extrapolation_mask
        pre = model.encode_prequant(x, m)
        pre_c = cpu_model.encode_prequant(x.cpu(), m.cpu())
        latent_rel = float((pre.cpu() - pre_c).abs().max() / pre_c.abs().max())
        d = pre.shape[-1]
        idx = nearest_codeword_indices(pre.reshape(-1, d), model.codebook)
        idx_c = nearest_codeword_indices(pre_c.reshape(-1, d), cpu_model.codebook)
        # 3. decode from the same indices: rgb at atol 1e-3, metric depth at
        #    1e-3 relative (depth = 1/disparity amplifies absolute error)
        zq = model.codebook[idx.long()].reshape(pre.shape)
        xrec = model.decode(zq).cpu()
        xrec_c = cpu_model.decode(zq.cpu())
        rgb_err = float((xrec[..., :3].clamp(-1, 1) - xrec_c[..., :3].clamp(-1, 1)).abs().max())
        depth, depth_c = codec.decode(xrec[..., 3]), codec.decode(xrec_c[..., 3])
        depth_rel = float(((depth - depth_c).abs() / depth_c.abs().clamp(min=1.0)).max())
    res = {
        "scenes": int(x.shape[0]), "flash_attention": flash,
        "x_identical_pixel_share": x_agree, "x_rgb_identical_pixel_share": rgb_agree,
        "latent_max_err_rel": latent_rel,
        "index_agreement_gpu_vs_cpu_latents": float((idx.cpu() == idx_c).float().mean()),
        "rgb_max_abs_err": rgb_err, "depth_max_rel_err": depth_rel,
    }
    res["ok"] = x_agree >= 0.999 and latent_rel <= 1e-4 and rgb_err <= 1e-3 and depth_rel <= 1e-3
    if not res["ok"]:
        failures.append(f"GPU vs CPU parity: {res}")
    return res


TRAIN_BATCH = 16  # bench.py --config train_conditional
TRAIN_STEPS = 3
TRAIN_LR = 1e-4  # bench.py bench_train


def train_config(torch, bs: int):
    """The conditional-generation training configuration of `bench.py
    --config train_conditional` on the flagship model (phase
    conditional_generation, n_embed 16384, depth_range (7, 16), as JAX's
    flagship_config): remat, flash attention (the port's AttnBlock takes
    it at batch >= 2), LossConfig(disc_start=0), LR 1e-4."""
    import dataclasses

    from sgam_neurips22_tpu_torch.serving import flagship_config
    from sgam_neurips22_tpu_torch.training.losses import LossConfig
    from sgam_neurips22_tpu_torch.training.train_step import TrainConfig

    if bs < 2:
        raise ValueError("the training phases run flash attention, which AttnBlock takes at batch >= 2")
    model = flagship_config()
    model = dataclasses.replace(model, ddconfig=dataclasses.replace(model.ddconfig, remat=True))
    return TrainConfig(model=model, loss=LossConfig(disc_start=0), learning_rate=TRAIN_LR)


def train_batch(torch, np, bs: int, device) -> dict:
    """bench.py's conditional batch (n_src 2, 256^2), from numpy seed 2."""
    rng = np.random.default_rng(2)
    n, h, w = 2, H, W
    k = np.array([[355.5555, 0, 128.0], [0, 355.5555, 128.0], [0, 0, 1.0]], np.float32)
    arrays = {
        "dst_img": rng.uniform(-1, 1, (bs, h, w, 3)), "dst_depth": rng.uniform(8, 14, (bs, h, w)),
        "src_imgs": rng.uniform(-1, 1, (bs, n, h, w, 3)), "src_depths": rng.uniform(8, 14, (bs, n, h, w)),
        "Ks": np.broadcast_to(k, (bs, n, 3, 3)), "R_rels": np.broadcast_to(np.eye(3), (bs, n, 3, 3)),
        "t_rels": np.zeros((bs, n, 3)), "src_masks": np.ones((bs, n)),
    }
    return {key: torch.tensor(np.asarray(v, np.float32), device=device) for key, v in arrays.items()}


def train_components(torch, state, lpips, batch, cfg) -> dict:
    """Device time (CUDA events) of the step's two loss networks at the
    step's shapes: LPIPS forward on (target, reconstruction) plus one
    backward to the reconstruction (the step runs the backward twice: the
    adaptive weight and the update), and the discriminator forward plus
    backward to its input and its weights on one batch (the step runs it
    forward three times and backward three times)."""
    from sgam_neurips22_tpu_torch.training.train_step import model_inputs

    with torch.no_grad():
        _, x_dst, _ = model_inputs(batch, cfg)
    xrec = x_dst.flip(0).clone().requires_grad_()

    def lp():
        torch.autograd.grad(lpips(x_dst[..., :3], xrec[..., :3]).mean(), xrec)

    def disc():
        torch.autograd.grad(state.disc(xrec).mean(), [xrec, *state.disc.parameters()])

    stats = {k: v.clone() for k, v in state.disc.named_buffers()}
    out = {"lpips_fwd_bwd_ms": cuda_ms(torch, lp, iters=5, warmup=1),
           "disc_fwd_bwd_ms": cuda_ms(torch, disc, iters=5, warmup=1)}
    for k, v in state.disc.named_buffers():
        v.copy_(stats[k])
    return out


def run_train(torch, np, counters, failures) -> tuple:
    """The training phase: state, a warm-up step, TRAIN_STEPS timed steps
    (launches counted), parameter movement checks, one profiled step."""
    from sgam_neurips22_tpu_torch.training.lpips import random_lpips
    from sgam_neurips22_tpu_torch.training.train_step import create_train_state, split_params, train_step

    cfg = train_config(torch, TRAIN_BATCH)
    t0 = time.perf_counter()
    state = create_train_state(cfg, seed=SEED, device="cuda")
    lpips = random_lpips(SEED + 2).cuda()
    batch = train_batch(torch, np, TRAIN_BATCH, "cuda")
    setup_s = time.perf_counter() - t0
    trainable, frozen = split_params(state.model, cfg.phase)
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    t0 = time.perf_counter()
    _, logs = train_step(state, batch, lpips, cfg)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        _, logs = train_step(state, batch, lpips, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    totals = {fn.__name__: fn.launches for fn in counters}
    launches = {k: v // TRAIN_STEPS for k, v in totals.items()}
    exact = all(fn.launches % TRAIN_STEPS == 0 for fn in counters)
    logs = {k: float(v) for k, v in logs.items()}
    finite = all(np.isfinite(v) for v in logs.values())
    unmoved = [n for n, p in trainable if torch.equal(p.detach(), before[n])]
    moved_frozen = [n for n, p in frozen if not torch.equal(p.detach(), before[n])]
    rep = {
        "batch": TRAIN_BATCH, "steps": TRAIN_STEPS, "seconds": dt, "ms_per_step": dt / TRAIN_STEPS * 1e3,
        "images_per_s": TRAIN_BATCH * TRAIN_STEPS / dt, "warmup_seconds": warm, "setup_seconds": setup_s,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches_per_step": launches,
        "launches": totals,
        "finite": finite, "logs": logs, "trainable_tensors": len(trainable), "frozen_tensors": len(frozen),
        "trainable_unmoved": unmoved, "frozen_moved": moved_frozen,
    }
    want = {"zbuffer_min": 1, "nearest_codeword": 1, "flash_attention_fwd": 12,
            "flash_attention_dq": 7, "flash_attention_dkv": 7}
    if not exact or launches != want:
        failures.append(f"train launch counts per step {launches} (whole steps: {exact}) != {want}")
    if not finite or unmoved or moved_frozen:
        failures.append(f"train: finite={finite} trainable unmoved={unmoved} frozen moved={moved_frozen}")
    prof = profile_unroll(torch, lambda: train_step(state, batch, lpips, cfg), 1, dt / TRAIN_STEPS)
    rep.update({k: v for k, v in prof.items() if k != "top"})
    rep["ms_per_step_by_layer"] = rep.pop("ms_per_frame_by_layer")
    rep["device_busy_ms_per_step"] = rep.pop("device_busy_ms_per_frame")
    rep.update(train_components(torch, state, lpips, batch, cfg))
    del state, lpips, batch, before
    return rep, prof


def f64_gradients(torch, cfg, x, x_dst, mask) -> dict:
    """The autoencoder gradients of the training step's loss in float64 on
    the CPU, from the same seeded state and the same f32 conditioning: the
    reference both f32 runs are measured against. The attention wrappers
    take f32 only, so this run calls their plain versions directly."""
    from sgam_neurips22_tpu_torch.ops import attention
    from sgam_neurips22_tpu_torch.training.lpips import random_lpips
    from sgam_neurips22_tpu_torch.training.train_step import _ae_loss, create_train_state, split_params

    wrappers = attention.flash_attention_fwd, attention.flash_attention_bwd
    attention.flash_attention_fwd, attention.flash_attention_bwd = (
        attention.flash_attention_plain, attention.flash_attention_bwd_plain)
    try:
        state = create_train_state(cfg, seed=SEED, device="cpu")
        state.model.double()
        state.disc.double()
        lpips = random_lpips(SEED + 2).double()
        loss = _ae_loss(state.model, state.disc, lpips, x.cpu().double(), x_dst.cpu().double(), mask.cpu(), 0, cfg)[0]
        names, params = zip(*split_params(state.model, cfg.phase)[0])
        return dict(zip(names, torch.autograd.grad(loss, params)))
    finally:
        attention.flash_attention_fwd, attention.flash_attention_bwd = wrappers


def parity_train(torch, np, failures, bs: int = 2) -> dict:
    """One training step at batch `bs`, full width, on the card (kernels)
    and on the CPU (plain versions) from the same seeded state and batch,
    and the same step's autoencoder gradients in float64 on the CPU.

    Tolerances: every log at rtol 1e-4 plus atol 1e-6, but the adaptive
    weight d_weight at rtol 1e-3 (a ratio of gradient norms taken through
    the discriminator's train-mode BatchNorm, whose input gradient is a
    small residual of cancelling terms: each f32 run's d_weight is 2-3e-4
    off the float64 one); codeword indices equal (from the same state
    before the step); the discriminator's running statistics at rtol 1e-4,
    atol 1e-6. Gradients, per trainable tensor, as max error over the
    tensor's largest magnitude: the card's error against float64 no more
    than 1.5 times the CPU f32 run's worst, and the card against the CPU
    within 3e-2. The f32 step determines its gradients only to ~1% of each
    tensor's largest (the CPU's f32 step is that far from float64 too), so
    a tighter GPU-vs-CPU bound would test the arithmetic, not the port.
    Tensors whose gradient is zero up to f32 noise (below 1e-5 of the
    step's largest gradient: the key biases, which the softmax cancels)
    only need to stay below that floor.

    The card's step runs once more with the forward's plain version in
    place of its kernel (the backward kernels kept), and that run's log and
    gradient errors stand beside the card's (plain_fwd_witness, not gated):
    what the forward kernel's rounding adds to the step's."""
    from sgam_neurips22_tpu_torch.models.vqgan.quantize import nearest_codeword_indices
    from sgam_neurips22_tpu_torch.ops import attention
    from sgam_neurips22_tpu_torch.training.lpips import random_lpips
    from sgam_neurips22_tpu_torch.training.train_step import (
        create_train_state,
        model_inputs,
        split_params,
        train_step,
    )

    cfg = train_config(torch, bs)
    kernel_fwd, runs = attention.flash_attention_fwd, {}
    for run, dev in (("cuda", "cuda"), ("plain_fwd", "cuda"), ("cpu", "cpu")):
        if run == "plain_fwd":
            attention.flash_attention_fwd = attention.flash_attention_plain
        try:
            t0 = time.perf_counter()
            state = create_train_state(cfg, seed=SEED, device=dev)
            lpips = random_lpips(SEED + 2).to(dev)
            batch = train_batch(torch, np, bs, dev)
            with torch.no_grad():
                x, x_dst, mask = model_inputs(batch, cfg)
                pre = state.model.encode_prequant(x, mask)
                idx = nearest_codeword_indices(pre.reshape(-1, pre.shape[-1]), state.model.codebook).cpu()
            _, logs = train_step(state, batch, lpips, cfg)
            grads = {n: p.grad.detach().cpu().double() for n, p in split_params(state.model, cfg.phase)[0]}
            stats = {n: b.detach().cpu() for n, b in state.disc.named_buffers()}
            runs[run] = ({k: float(v) for k, v in logs.items()}, idx, grads, stats, time.perf_counter() - t0)
            del state, lpips, batch, pre
        finally:
            attention.flash_attention_fwd = kernel_fwd
    t0 = time.perf_counter()
    ref = f64_gradients(torch, cfg, x, x_dst, mask)
    f64_s = time.perf_counter() - t0
    (g_logs, g_idx, g_grads, g_stats, g_s), (c_logs, c_idx, c_grads, c_stats, c_s) = runs["cuda"], runs["cpu"]
    w_logs, w_grads = runs["plain_fwd"][0], runs["plain_fwd"][2]
    rtol = {k: 1e-3 if k.endswith("d_weight") else 1e-4 for k in c_logs}
    log_err = {k: abs(g_logs[k] - c_logs[k]) / max(abs(c_logs[k]), 1e-30) for k in c_logs}
    logs_ok = all(abs(g_logs[k] - c_logs[k]) <= rtol[k] * abs(c_logs[k]) + 1e-6 for k in c_logs)
    floor = 1e-5 * max(float(g.abs().max()) for g in ref.values())
    noise = sorted(n for n, r in ref.items() if float(r.abs().max()) < floor)
    noise_ok = all(float(g[n].abs().max()) < floor for g in (g_grads, c_grads) for n in noise)

    def rel(a, b):
        return {n: float((a[n] - b[n]).abs().max() / b[n].abs().max()) for n in b if n not in noise}

    gpu64, cpu64, gpu_cpu, plain_fwd64 = rel(g_grads, ref), rel(c_grads, ref), rel(g_grads, c_grads), rel(w_grads, ref)
    worst = {name: max(d.items(), key=lambda kv: kv[1]) for name, d in
             (("gpu_vs_f64", gpu64), ("cpu_vs_f64", cpu64), ("gpu_vs_cpu", gpu_cpu))}
    grads_ok = noise_ok and worst["gpu_vs_f64"][1] <= 1.5 * worst["cpu_vs_f64"][1] and worst["gpu_vs_cpu"][1] <= 3e-2
    stats_ok = all(torch.allclose(g_stats[n], c, rtol=1e-4, atol=1e-6) for n, c in c_stats.items())
    res = {
        "batch": bs, "gpu_seconds": g_s, "cpu_seconds": c_s, "cpu_f64_seconds": f64_s,
        "logs_gpu": g_logs, "logs_cpu": c_logs, "log_rel_err": log_err, "logs_ok": logs_ok,
        "index_agreement": float((g_idx == c_idx).float().mean()),
        "grad_tensors": len(ref), "grad_noise_tensors": noise, "grad_noise_floor": floor,
        "grad_worst": worst, "grad_median_gpu_vs_f64": float(np.median(list(gpu64.values()))),
        "grad_median_cpu_vs_f64": float(np.median(list(cpu64.values()))), "grads_ok": grads_ok,
        "running_stats_max_abs_err": max(float((g_stats[n] - c).abs().max()) for n, c in c_stats.items()),
        "running_stats_ok": stats_ok,
        "plain_fwd_witness": {
            "log_rel_err": {k: abs(w_logs[k] - c_logs[k]) / max(abs(c_logs[k]), 1e-30) for k in c_logs},
            "grad_worst_vs_f64": max(plain_fwd64.items(), key=lambda kv: kv[1]),
            "grad_median_vs_f64": float(np.median(list(plain_fwd64.values()))),
        },
    }
    res["ok"] = logs_ok and res["index_agreement"] == 1.0 and grads_ok and stats_ok
    if not res["ok"]:
        failures.append(f"training step GPU vs CPU: {res}")
    return res

def seed_frames(np, rng) -> list:
    """One scene's seeds: a random frame at grid (0, 0)."""
    return [((0, 0), rng.uniform(-1, 1, (H, W, 3)).astype(np.float32),
             rng.uniform(8, 14, (H, W)).astype(np.float32))]


def timed_unroll(torch, unroll, counters, prepare=lambda: None) -> tuple:
    """One warm-up call of unroll(), then one timed call whose kernel
    launches are counted, each after an untimed prepare():
    (result, seconds, warm-up seconds, launches)."""
    prepare()
    t0 = time.perf_counter()
    unroll()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    prepare()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = unroll()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return res, dt, warm, {fn.__name__: fn.launches for fn in counters}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true", help="profile one more batch-1 unroll")
    ap.add_argument("--out", type=Path, default=None, help="directory for the detailed JSON report")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a GPU", file=sys.stderr)
        return 1
    import numpy as np

    from sgam_neurips22_tpu_torch.core.device import resolve_device
    from sgam_neurips22_tpu_torch.core.state_dict import load_into, random_state_dict
    from sgam_neurips22_tpu_torch.models.vqgan.model import VQModel
    from sgam_neurips22_tpu_torch.ops import cuda_build
    from sgam_neurips22_tpu_torch.ops.attention import (
        flash_attention_dkv,
        flash_attention_dq,
        flash_attention_fwd,
    )
    from sgam_neurips22_tpu_torch.ops.vq import nearest_codeword
    from sgam_neurips22_tpu_torch.ops.zbuffer import zbuffer_min
    from sgam_neurips22_tpu_torch.pipeline.scene_generation import (
        InfiniteSceneGeneration,
        SceneGenConfig,
    )
    from sgam_neurips22_tpu_torch.serving import flagship_config

    resolve_device("cuda")
    kind, card = torch.cuda.get_device_name(0), card_line()
    failures: list[str] = []
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    counters = (zbuffer_min, nearest_codeword, flash_attention_fwd, flash_attention_dq, flash_attention_dkv)
    t_start = time.perf_counter()

    # 1. build
    t0 = time.perf_counter()
    ptxas = cuda_build.build("zbuffer_min", "nearest_codeword", "flash_attention_fwd", "flash_attention_dq",
                             "flash_attention_dkv")
    secs = time.perf_counter() - t0
    report["build"] = {"seconds": secs, "built": sorted(ptxas), "ptxas": ptxas_summary(ptxas)}
    if args.out:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "chip_smoke_ptxas.txt").write_text("\n".join(f"--- {k}\n{v}" for k, v in ptxas.items()))
    emit({"phase": "build", **report["build"], "card": card})

    # the flagship model with seeded random weights, on the CPU and the card
    cpu_model = VQModel(flagship_config())
    load_into(cpu_model, random_state_dict(cpu_model, SEED))
    cpu_model.eval()
    rng = np.random.default_rng(SEED)
    seeds = seed_frames(np, rng)
    cfg = SceneGenConfig(dataset="clevr-infinite", output_dim=(FRAMES + 1, 1), topk=1, image_resolution=(H, W))
    gen = InfiniteSceneGeneration(copy.deepcopy(cpu_model), cfg, seeds, device="cuda")

    # 2. kernels against their plain versions
    t0 = time.perf_counter()
    kernels = [check_zbuffer(torch, np, gen, failures), check_nearest_codeword(torch, gen.model.codebook, failures),
               check_flash_attention(torch, failures), *check_flash_backward(torch, failures)]
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0, "kernels": kernels})

    # 3. the flythrough, batch 1: one warm-up unroll, then one timed unroll
    #    whose kernel launches are counted
    t0 = time.perf_counter()
    (rgb, depth), dt, warm, launches = timed_unroll(torch, gen.scene_expansion, counters, gen.reset)
    finite = bool(torch.isfinite(rgb).all() and torch.isfinite(depth).all())
    unroll_rep = {
        "frames": FRAMES, "seconds": dt, "frames_per_s": FRAMES / dt,
        "ms_per_frame": dt / FRAMES * 1e3, "warmup_seconds": warm,
        "launches": launches, "finite": finite, "card": card,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "gflop_per_frame": model_gflop(torch, flagship_config()),
    }
    gflop = sum(unroll_rep["gflop_per_frame"].values())
    unroll_rep["model_tflop_per_s"] = gflop * FRAMES / dt / 1e3
    unroll_rep["model_bound_ms_per_frame"] = gflop * 1e9 / F32_FLOP_PER_S * 1e3
    if not finite:
        failures.append("non-finite frames in the unroll")
    want = {"zbuffer_min": FRAMES, "nearest_codeword": FRAMES, "flash_attention_fwd": 0,
            "flash_attention_dq": 0, "flash_attention_dkv": 0}
    if launches != want:
        failures.append(f"unroll launch counts {launches} != {want}")
    if args.profile:
        gen.reset()
        report["profile"] = profile_unroll(torch, gen.scene_expansion, FRAMES, dt)
        unroll_rep["profile"] = {k: v for k, v in report["profile"].items() if k != "top"}
    unroll_rep["phase_seconds"] = time.perf_counter() - t0
    emit({"phase": "unroll", **unroll_rep})

    # 4. one full-width step on the card against the CPU
    t0 = time.perf_counter()
    parity = parity_step(torch, gen, cpu_model, failures)
    emit({"phase": "parity", "seconds": time.perf_counter() - t0, **parity})

    # 5. the batched flythrough: SCENES scenes, each from its own seed frame
    t0 = time.perf_counter()
    seeds_batch = [seed_frames(np, rng) for _ in range(SCENES)]
    gen_b = InfiniteSceneGeneration(gen.model, cfg, seeds_batch[0], device="cuda")
    (rgb_b, depth_b), dt_b, warm_b, launches_b = timed_unroll(
        torch, lambda: gen_b.scene_expansion_batched(seeds_batch), counters)
    frames_b = SCENES * FRAMES
    finite_b = bool(torch.isfinite(rgb_b).all() and torch.isfinite(depth_b).all())
    scenes_differ = not torch.equal(rgb_b[0, 1], rgb_b[1, 1])
    batched = {
        "scenes": SCENES, "frames_per_scene": FRAMES, "seconds": dt_b,
        "frames_per_s": frames_b / dt_b, "ms_per_frame": dt_b / frames_b * 1e3,
        "ms_per_step": dt_b / FRAMES * 1e3, "warmup_seconds": warm_b,
        "launches": launches_b, "finite": finite_b, "scenes_0_1_differ_at_frame_1": scenes_differ,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card,
    }
    batched["model_tflop_per_s"] = gflop * frames_b / dt_b / 1e3
    del rgb_b, depth_b
    prof_b = profile_unroll(torch, lambda: gen_b.scene_expansion_batched(seeds_batch), frames_b, dt_b)
    report["profile_batched"] = prof_b
    batched.update({k: v for k, v in prof_b.items() if k != "top"})
    batched["phase_seconds"] = time.perf_counter() - t0
    emit({"phase": "unroll_batched", **batched})
    if not (finite_b and scenes_differ):
        failures.append(f"batched unroll: finite={finite_b} scenes_0_1_differ={scenes_differ}")
    want_b = {"zbuffer_min": FRAMES, "nearest_codeword": FRAMES, "flash_attention_fwd": 7 * FRAMES,
              "flash_attention_dq": 0, "flash_attention_dkv": 0}
    if launches_b != want_b:
        failures.append(f"batched unroll launch counts {launches_b} != {want_b}")

    # 6. one full-width step of 2 scenes on the card (flash kernel) against the CPU
    t0 = time.perf_counter()
    parity_b = parity_step(torch, gen_b, cpu_model, failures, seeds_batch[:2])
    emit({"phase": "parity_batched", "seconds": time.perf_counter() - t0, **parity_b})

    # 7. the conditional-generation training step, batch 16
    del gen, gen_b
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train, prof_t = run_train(torch, np, counters, failures)
    report["profile_train"] = prof_t
    train["phase_seconds"] = time.perf_counter() - t0
    emit({"phase": "train", **train, "card": card})

    # 8. one training step at batch 2 on the card against the CPU
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    parity_t = parity_train(torch, np, failures)
    emit({"phase": "parity_train", "seconds": time.perf_counter() - t0, **parity_t})

    main_path = {"zbuffer_min": "unroll", "nearest_codeword": "unroll", "flash_attention_fwd": "unroll_batched",
                 "flash_attention_dq": "train", "flash_attention_dkv": "train"}
    for k in kernels:
        by_path = {"unroll": launches[k["name"]], "unroll_batched": launches_b[k["name"]],
                   "train": train["launches"][k["name"]]}
        k["launches"] = by_path[main_path[k["name"]]]
        k["launches_by_path"] = by_path
        k["kernel_ms"] = k["ms"]
    report.update(kernels=kernels, unroll=unroll_rep, parity=parity, unroll_batched=batched,
                  parity_batched=parity_b, train=train, parity_train=parity_t, failures=failures,
                  seconds=time.perf_counter() - t_start)
    if args.out:
        (args.out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(card, flush=True)
    emit({"kernels": [{k: v for k, v in kern.items() if k not in ("shape",)} for kern in kernels]})
    if failures:
        for f in failures:
            print(f"chip_smoke: FAILED {f}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
