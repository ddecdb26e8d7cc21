#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (`sgam_neurips22_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--out DIR]

From the repository root. It builds the port's CUDA kernels from csrc/
(five sources, five kernels), holds each against its plain PyTorch version
on the card at the shapes the paths launch it at and times both (and the
one-call library equivalent; the z-buffer merge bit-exact at the shape and
point order of each of its callers, the JAX package's map-requery pool
splat, google_earth and the strided splat among them, on both of its
routes, see check_zbuffer; the codeword search at P = 256, 2048 and 4096,
the codebook phase's K = 2048 at P = 2048 and 768 and google_earth's K =
4096, and also on
a clustered codebook against float64 and on exact ties, see
check_nearest_codeword), holds the splat's two scatter modes
(nearest_exact, last) on the card bit-exact to the CPU at the flythrough's
and the 8-scene unroll's points (check_collision_modes), then drives the
port's paths with the flagship models (seeded random weights). Each unroll phase checks finite frames and
its kernel launches, and profiles one more call (device time by layer and
the device's idle share):

- unroll: one scene's clevr-infinite flythrough through
  `InfiniteSceneGeneration.scene_expansion` (batch 1, f32, plain
  attention): the z-buffer and codeword kernels once per frame, the
  flash-attention kernel never; then parity, one full-width step on the
  card against the same step on the CPU;
- unroll_batched: 8 scenes at once through `scene_expansion_batched`
  (batch 8, flash attention): one z-buffer and one codeword launch and 7
  flash-attention launches per step; then parity_batched, one step of 2
  scenes on the card against the CPU;
- unroll_bf16, unroll_batched_bf16: the same two unrolls with the model
  in bf16 (bench.py's default --model_dtype), the same launches, the
  layers beside the f32 unroll's, the batch-1 frames' PSNR against the
  f32 frames (not gated); each followed by its step on the card against
  the CPU's bf16 step (parity_bf16, parity_batched_bf16);
- stride2: the bf16 flythrough with splat_stride 2 (bench.py's
  flythrough_splat_stride2);
- topk: a few bf16 frames at topk 4, twice from one torch.Generator seed:
  the same frames, finite, the z-buffer once a frame and no codeword
  kernel (the draws use plain distances, as JAX's);
- google_earth: bench.py --config google_earth, its flagship model in
  bf16 (codebook 4096), 3 sources, its (24+1) x 1 trajectory;
- unroll_tsdf, unroll_tsdf_ge, unroll_tsdf_ge_coherent: map re-query in
  bf16 (`use_rgbd_integration`, the auto-sized TSDF volume): bench.py
  --config integration (clevr-infinite, 3x3, 8 frames, 5 sources, seed
  depth U(8, 14)); google_earth --rgbd_integration on its 25 x 1
  trajectory (24 frames, cut from 100; 3 sources, codebook 4096, a pool
  of 2^20 slots that recycles); and the same with coherent_plane_depth
  (--coherent). Each checks finite frames and one z-buffer and one
  codeword launch a frame, reports the pool telemetry bench.py prints and
  the fused share of depth samples, times the map's functions alone
  (map_ms) and runs integrate and render_depth once under
  torch.cuda.set_sync_debug_mode("error");
- integration_clevr_stride2: bench.py's integration_clevr_stride2, the
  CLEVR map phase with every second ray fused (--tsdf_stride 2), on a 2x2
  grid (3 frames, cut from 8 for time);
- unroll_tsdf_batched: bench.py's batched_8_scenes_tsdf, map re-query for
  8 scenes at once in bf16 (CLEVR 7x7, 48 frames a scene, 5 sources, one
  batched volume of 8 maps): one z-buffer and one codeword launch and 7
  flash-attention launches a step, each scene's pool telemetry and the
  volume's bytes; the pool splat's input at its last frame is kept for the
  z-buffer check;
- map_parity (f32): integrate's state on the card against the CPU (the
  seed and 3 generated frames; CLEVR, and google_earth at stride 1 and 2):
  the integer state bit-exact, the grid within GRID_MAX_ABS_DIFF with at
  most GRID_OBSERVEDNESS_SHARE of observed voxels changing observedness;
  render_depth (splat, raycast nearest and trilinear) from one volume on
  both: the splat's keys, z-buffer winners and every depth bit-exact; and
  frame 1 of the map-requery unroll under parity's gates; then
  parity_map_batched, one batched map-requery step of 2 scenes card
  against CPU in f32 and bf16 (parity's and parity_bf16's gates) and the
  volume after it; then the z-buffer on the keys the pool splat built at
  the last frame of unroll_tsdf ([3, 204960]), unroll_tsdf_ge ([4, 262144])
  and unroll_tsdf_batched ([24, 226464]), bit-exact on both routes, each
  route timed beside scatter_reduce;
- generate: the port's CLI (`python -m sgam_neurips22_tpu_torch.generate`,
  its main) on the card from a seed template and a reference-layout .ckpt
  that the phase writes: map re-query on a 2x2 grid with --output_dir
  (the frames, merged_pcds.ply and the map's rgbd_integrated_mesh.ply and
  rgbd_integrated_trimesh.ply), then the spiral, cylinder and pose-file
  trajectories; every file of the reference's layout, PLY sizes that match
  their headers, one z-buffer and one codeword launch a frame, and the
  unroll, export and mesh host times apart; then the exports of a
  coherent-plane map (random-weight depth puts triangles in nearly every
  observed voxel, which makes the map run's exports host-bound);
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
  gradients in float64 on the CPU);
- train_bf16: the same step with a bf16 model (train_conditional_bf16),
  the same launches; then parity_train_bf16, its batch-2 step on the card
  and on the CPU, each held to the CPU's f32 step at a codebook where no
  latent changes codeword, and a planted fault (dV zeroed) that must fail;
- the trainer (trainer_phases), on a CLEVR-style dataset written from a
  seed into a temporary directory (256^2 PNGs, half of them Paeth-filtered,
  ray depths, pose graphs, file lists and the codebook phase's packed
  shards): loader, the Loader's host examples/s (unfiltered and Paeth PNGs,
  the packed shard, pair examples);
  train_codebook_cli, the train CLI on configs/codebooks/clevr-infinite.yaml
  at full width from the packed shard, 9 steps with a k-means refresh at
  step 8 (CODEBOOK_OVERRIDES), then ms/step through Trainer.fit against
  train_step alone, the checkpoint's bytes and seconds, and the refresh at
  the YAML's own buffer; train_conditional_cli, the train CLI on
  configs/conditional_generation/clevr-infinite.yaml at full width, warm-
  started from the codebook run, 3 steps, validation and test, SIGUSR1
  mid-run (an emergency checkpoint, training goes on), -r for one more
  step, and the same timings; generate_config,
  the generate CLI with --config and --ckpt on the conditional run, 3
  frames; parity_trainer, two Trainer steps (accumulation 2, the
  scheduler on) on the card against the CPU under parity_train's gates.

Each phase prints one JSON line with its seconds; --out DIR also writes the
details to DIR/chip_smoke.json and nvcc's register report to
DIR/chip_smoke_ptxas.txt. The last line is {"ok": true, "device": {...}}
and is printed only when every check passed. It exits non-zero without
that line when CUDA is unavailable or any check fails.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
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
TOPK_FRAMES = 8  # frames of each top-k unroll
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
# the codebook phase's K = 2048 at P = 2048 and at its YAML's batch 3 (768 latents)
VQ_CODEBOOK_PHASE_P, VQ_CODEBOOK_PHASE_K = (2048, 768), 2048
VQ_CLUSTERED_P = 2048
VQ_TIES = ((100, 9000), (130, 250), (16, 19))
# google_earth's codebook of 4096 at the batch-1 and the 8-scene unroll's P,
# and its exact-tie pairs (two K-split ranges, one tile, one warp)
VQ_GE_K, VQ_GE_P, VQ_GE_TIES = 4096, (256, SCENES * 256), ((100, 3000), (130, 250), (16, 19))
# the z-buffer merge's map-requery pool splat: one call merges 2 sub-chunks of
# 2^18 slots for each of 8 scenes (sgam_neurips22_tpu/mapping/tsdf.py:123,
# 139, 929-940); keys carry a 20-bit slot; CLEVR's pool (near, far) from
# auto_config (depth range (7, 16), sdf_trunc 0.5); ring recycling
# interleaves runs of POOL_RUN slots
POOL_ROWS, POOL_P, POOL_IDX_BITS, POOL_RUN, POOL_INVALID = 16, 1 << 18, 20, 256, 0.3
POOL_NEAR_FAR = (0.8 * 7.0 - 0.5, 1.2 * 16.0 + 0.5)
ZB_LARGE = 1024  # the side of an image whose window would hold too few rows: the l2 route
ZB_KERNELS = "zbuffer_tile_kernel|zbuffer_l2_kernel"  # the z-buffer's own kernels in a profile
# calls whose profiler trace held no device time (device_ms, profile_unroll)
PROFILER_MISSES: list[str] = []
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


def device_ms(torch, fn, iters: int = 50, warmup: int = 5, match: str | None = None) -> float | None:
    """Device time per fn() call: the summed time of every kernel that
    `iters` calls launched (only those whose name matches the regex
    `match`, if given), from torch.profiler, over `iters`. Unlike cuda_ms
    it leaves out the gaps while the host prepares each launch. A trace
    that holds no device time at all (the profiler could not trace the
    card) is taken once more; if that one holds none either, the miss goes
    into PROFILER_MISSES and the time comes from CUDA events (cuda_ms),
    or is None where `match` asks for some kernels only."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
        if sum(ev.self_device_time_total for ev in events) > 0:
            us = sum(ev.self_device_time_total for ev in events if match is None or re.search(match, ev.key))
            return us / 1e3 / iters
    PROFILER_MISSES.append(f"device_ms(match={match!r})")
    return None if match else cuda_ms(torch, fn, iters, warmup)


def timings(torch, kernel, plain, library) -> dict:
    """Device time per call of the kernel's wrapper, its plain version and
    the one-call library equivalent, plus each call's CUDA-event time
    back to back (which includes host launch overhead when the device
    outruns the host). "clock" says where the first three came from: the
    profiler, or CUDA events where it could not trace the card."""
    out, misses = {}, len(PROFILER_MISSES)
    for name, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        out[f"{name}ms"] = device_ms(torch, fn)
        out[f"{name}call_ms"] = cuda_ms(torch, fn)
    out["clock"] = "profiler" if len(PROFILER_MISSES) == misses else "cuda_events"
    return out


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def projected(torch, np, grid, k, n_src: int, depth_range, rng, dev, stride: int = 1, nearest: bool = True):
    """(pix [1, P, 2], z [1, P], valid [1, P]) of n_src frames with depths
    uniform in depth_range at grid rows 0..n_src-1 projected into row
    n_src, in source-scanline order (P = n_src * (H / stride) * (W /
    stride), each source's pixels at its phase of the strided splat);
    nearest=False keeps the points behind the camera, as collision "last"
    does."""
    from sgam_neurips22_tpu_torch.geometry.camera import pose_matrix
    from sgam_neurips22_tpu_torch.geometry.splat import project_points

    t_tgt = grid.w2c(n_src)
    rel = np.stack([t_tgt @ np.linalg.inv(grid.w2c(i)) for i in range(n_src)]).astype(np.float32)
    depths = torch.tensor(rng.uniform(*depth_range, (1, n_src, H, W)), dtype=torch.float32, device=dev)
    ks = torch.tensor(np.tile(np.asarray(k, np.float32), (n_src, 1, 1)), device=dev)
    src2tgt = pose_matrix(torch.tensor(rel[:, :3, :3], device=dev), torch.tensor(rel[:, :3, 3], device=dev))
    return project_points(depths, ks[:1], ks[None], src2tgt[None], splat_stride=stride, nearest=nearest)


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
      4 MB of winners, 18 times what a block's shared memory holds;
    - flythrough_stride2, scenes_8_stride2, google_earth_stride2: the
      flythrough, the 8-scene unroll and google_earth at splat_stride 2,
      (H/2)(W/2) points a source: [1, 81920], [8, 81920], [1, 49152]."""
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
    fly2 = [packed_keys(*projected(torch, np, *clevr, 5, clevr_depths, rng, dev, 2), W) for _ in range(SCENES)]
    cases["flythrough_stride2"] = (*fly2[0], H, W)
    cases["scenes_8_stride2"] = (*(torch.cat(x) for x in zip(*fly2)), H, W)
    ge2 = projected(torch, np, ge, ge.K, 3, (0.1, 4.77), rng, dev, 2)
    cases["google_earth_stride2"] = (*packed_keys(*ge2, W), H, W)
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


def check_collision_modes(torch, np, gen, rng, failures) -> dict:
    """The splat's two scatter modes, collision "nearest_exact" (an f32
    scatter-min of z, then the smallest point index among equal-z ties)
    and "last" (a scatter-max of the pixel-major priority, through its
    inverse permutation), on the card against the same merge on the CPU:
    the flythrough's 5 clevr sources projected into row 5 on the CPU, at
    batch 1 and at 8 scenes ([1|8, 327680] points, int64 batch-folded
    pixel ids), every 7th point given the z of the point before it for
    exact ties. The winners, and so the raw depth and features gathered
    from them, must be bit-identical. Both modes use torch's
    scatter_reduce_ as JAX uses XLA scatters: no kernel of the port."""
    from sgam_neurips22_tpu_torch.geometry.splat import _winners

    rows = {}
    for mode in ("nearest_exact", "last"):
        for scenes in (1, SCENES):
            parts = [projected(torch, np, gen.grid, gen.grid.K, 5, (8, 14), rng, "cpu", nearest=mode != "last")
                     for _ in range(scenes)]
            pix, zs, valid = (torch.cat(x) for x in zip(*parts))
            zs[:, 1::7] = zs[:, ::7][:, : zs[:, 1::7].shape[1]]
            feats = torch.tensor(rng.uniform(-1, 1, (*zs.shape, 3)), dtype=torch.float32)
            pay = torch.cat([zs.reshape(-1, 1), feats.reshape(-1, 3)], dim=-1)
            won = {}
            for dev in ("cpu", "cuda"):
                args = (pix.to(dev), zs.to(dev), valid.to(dev), H, W, mode, 5)
                has_point, idx = _winners(*args)
                won[dev] = torch.where(has_point[:, None], pay.to(dev)[idx], 0.0).cpu()
            row = {"case": f"{mode}_{scenes}", "points": list(zs.shape), "bit_exact": torch.equal(won["cpu"], won["cuda"]),
                   "filled_share": float((won["cuda"][:, 0] != 0).float().mean()),
                   "ms": cuda_ms(torch, lambda: _winners(*args), iters=10)}
            if mode == "last":
                row["behind_camera_winners"] = int((won["cuda"][:, 0] < 0).sum())
            rows[row["case"]] = row
            if not row["bit_exact"]:
                failures.append(f"collision {mode} at {scenes} scenes: card and CPU winners differ")
    return rows


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
    P=4096, and on the codebook phase's (P=2048 and its YAML's batch-3
    P=768, a seeded K=2048 init codebook): distances at rtol 1e-5, indices equal but at f32 near-ties.
    Then two cases a trained codebook poses. Clustered: e ~ N(0, 1)
    [16384, 256], z = e_j + 0.05 N(0, 1), P=2048, where the distance is a
    small difference of large terms, so rtol 1e-5 fails f32 itself; each
    winning distance must lie within 1e-6 (||z||^2 + ||e||^2 + 2 sum |z e|)
    of the float64 one (gate_share; plain_gate_share is plain f32's, not
    gated), which a product that drops a 3xTF32 correction term misses.
    Exact ties: the clustered codebook with identical codewords at 100 and
    9000 (two K-split ranges), 130 and 250 (one tile, two warps), 16 and 19
    (one warp), and P=256 rows near each: the smaller index must win. Every
    init shape is timed with plain and `cdist` + `argmin`; so are
    google_earth's (K = 4096, a seeded init codebook, at P = 256 and 2048),
    with exact ties at K = 4096 too. bound_ms is the
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
    cases += [(f"codebook phase P={p}", torch.randn((p, d), generator=g, device=dev), cb_small)
              for p in VQ_CODEBOOK_PHASE_P]
    rows = torch.randint(0, cb_init.shape[0], (VQ_CLUSTERED_P,), generator=g, device=dev)
    cases.append((f"clustered P={VQ_CLUSTERED_P}", near(cb_clustered, rows), cb_clustered))
    cb_ties = cb_clustered.clone()
    for a, b in VQ_TIES:
        cb_ties[b] = cb_ties[a]
    want = torch.tensor([a for a, _ in VQ_TIES], device=dev).repeat_interleave(-(-256 // len(VQ_TIES)))[:256]
    cases.append(("exact ties P=256", near(cb_ties, want), cb_ties))
    cb_ge = (torch.rand((VQ_GE_K, d), generator=g, device=dev) * 2 - 1) / VQ_GE_K
    cases += [(f"init K={VQ_GE_K} P={p}", torch.randn((p, d), generator=g, device=dev), cb_ge) for p in VQ_GE_P]
    cb_ge_ties = cb_clustered[:VQ_GE_K].clone()
    for a, b in VQ_GE_TIES:
        cb_ge_ties[b] = cb_ge_ties[a]
    want_ge = torch.tensor([a for a, _ in VQ_GE_TIES], device=dev).repeat_interleave(-(-256 // len(VQ_GE_TIES)))[:256]
    cases.append((f"exact ties K={VQ_GE_K} P=256", near(cb_ge_ties, want_ge), cb_ge_ties))
    wants = {"exact ties P=256": want, f"exact ties K={VQ_GE_K} P=256": want_ge}

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
            row["smaller_index_mismatches"] = int((idx.long() != wants[name]).sum())
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
    slows the host, so its own wall time is not used). Where the trace
    holds no device time (the profiler could not trace the card), the
    device time and idle share are None, not measured, and the miss goes
    into PROFILER_MISSES."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:  # host ops untraced: they cost ~30 s to sort
        unroll()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            rows.append((ev.self_device_time_total, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    if not rows:
        PROFILER_MISSES.append("profile_unroll")
    groups: dict[str, float] = {}
    for us, key, _ in rows:
        label = next(lab for pat, lab in KERNEL_GROUPS if re.search(pat, key))
        groups[label] = groups.get(label, 0.0) + us / 1e3 / frames
    return {
        "profiled_wall_s": wall, "device_busy_ms_per_frame": busy_s * 1e3 / frames if rows else None,
        "device_idle_share": 1.0 - busy_s / timed_s if rows else None,
        "ms_per_frame_by_layer": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "top": [{"kernel": k[:120], "ms": us / 1e3, "calls": n} for us, k, n in rows[:25]],
    }


def parity_step(torch, gen, cpu_model, failures, seeds_batch=None, batches=None) -> dict:
    """Frame 1 of the unroll on the card against the same step on the CPU
    (plain versions), same weights and inputs, stage by stage: for the
    generator's own scene, or for the scenes of seeds_batch at once (the
    flash-attention path at 2 scenes and up, as the batched unroll runs),
    or from a given (card, CPU) pair of conditioning batches (map re-query,
    whose CPU batch is rendered and warped on the CPU)."""
    from sgam_neurips22_tpu_torch.models.conditioning import get_x
    from sgam_neurips22_tpu_torch.models.vqgan.quantize import nearest_codeword_indices

    if batches is None:
        if seeds_batch is None:
            gen.reset()
            batch = gen.step_batch(gen.build_plan(), 0, gen.rgb_buf, gen.depth_buf)
        else:
            batch = gen.step_batch(gen.build_plan(), 0, *gen.batched_buffers(seeds_batch))
        batches = (batch, {k: v.cpu() for k, v in batch.items()})
    batch, batch_c = batches
    flash = batch["dst_img"].shape[0] >= 2
    model, ds, codec = gen.model, gen.cfg.dataset, gen.codec
    with torch.inference_mode():
        cond = get_x(batch, ds)
        cond_c = get_x(batch_c, ds)
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


def xrec_gate(torch, xrec, xrec_ref, idx, idx_ref) -> dict:
    """The JAX package's gate of bf16 against f32 (tests/test_vqgan.py::
    test_bfloat16_compute_mode_close_to_f32): mean |d xrec| < 0.05, max <
    0.5, codeword index agreement > 0.9. A near-tied latent may pick
    another codeword under bf16 rounding, which moves its pixels a lot."""
    d = (xrec.float().cpu() - xrec_ref.float().cpu()).abs()
    res = {"xrec_mean_abs_err": float(d.mean()), "xrec_max_abs_err": float(d.max()),
           "index_agreement": float((idx.cpu() == idx_ref.cpu()).float().mean())}
    res["ok"] = res["xrec_mean_abs_err"] < 0.05 and res["xrec_max_abs_err"] < 0.5 and res["index_agreement"] > 0.9
    return res


def parity_step_bf16(torch, gen, cpu_model16, cpu_model, failures, seeds_batch=None, batches=None) -> dict:
    """Frame 1 of a bf16 unroll on the card against the same step on the
    CPU, for the generator's own scene or for the scenes of seeds_batch at
    once: the conditioning identical on >= 99.9% of pixels (f32 in both);
    then the model's forward from the same conditioning, in bf16 on the
    card and on the CPU and in f32 on the CPU (cpu_model, the same
    weights). Each bf16 forward is held to the f32 one by `xrec_gate`, the
    JAX package's bf16-vs-f32 gate; the card's against the CPU's bf16 is
    reported (two bf16 roundings of one computation, each with its own
    near-tie flips). The f32 tolerances of parity_step do not apply. A
    given (card, CPU) pair of map-requery batches takes get_x's map branch,
    as parity_step's."""
    from sgam_neurips22_tpu_torch.models.conditioning import get_x

    if batches is None:
        if seeds_batch is None:
            gen.reset()
            batch = gen.step_batch(gen.build_plan(), 0, gen.rgb_buf, gen.depth_buf)
        else:
            batch = gen.step_batch(gen.build_plan(), 0, *gen.batched_buffers(seeds_batch))
        batches = (batch, {k: v.cpu() for k, v in batch.items()})
    condition = gen.condition if "src_imgs" in batches[0] else (lambda b: get_x(b, gen.cfg.dataset))
    with torch.inference_mode():
        cond = condition(batches[0])
        cond_c = condition(batches[1])
        x_agree = float((cond.x.cpu() == cond_c.x).all(dim=-1).float().mean())
        x, m = cond.x.cpu(), cond.extrapolation_mask.cpu()
        res, res_c, ref = gen.model(cond.x, cond.extrapolation_mask), cpu_model16(x, m), cpu_model(x, m)
    out = {"scenes": int(cond.x.shape[0]), "flash_attention": cond.x.shape[0] >= 2,
           "x_identical_pixel_share": x_agree, "xrec_dtype": str(res.xrec.dtype),
           "gpu_bf16_vs_cpu_f32": xrec_gate(torch, res.xrec, ref.xrec, res.indices, ref.indices),
           "cpu_bf16_vs_cpu_f32": xrec_gate(torch, res_c.xrec, ref.xrec, res_c.indices, ref.indices),
           "gpu_vs_cpu_bf16": xrec_gate(torch, res.xrec, res_c.xrec, res.indices, res_c.indices),
           "latent_max_err_rel_gpu_vs_cpu_bf16": float((res.pre_quant.cpu() - res_c.pre_quant).abs().max()
                                                       / res_c.pre_quant.abs().max())}
    out["ok"] = (x_agree >= 0.999 and res.xrec.dtype == torch.float32 and out["gpu_bf16_vs_cpu_f32"]["ok"]
                 and out["cpu_bf16_vs_cpu_f32"]["ok"])
    if not out["ok"]:
        failures.append(f"bf16 GPU vs CPU parity: {out}")
    return out


def psnr(torch, a, b) -> list:
    """PSNR in dB of each frame of rgb a against b ([G, H, W, 3] in [-1, 1],
    so a peak-to-peak range of 2)."""
    mse = ((a.float() - b.float()) ** 2).flatten(1).mean(1)
    return [float(x) for x in 10 * torch.log10(4.0 / mse.clamp(min=1e-20))]


TRAIN_BATCH = 16  # bench.py --config train_conditional
TRAIN_STEPS = 3
TRAIN_LR = 1e-4  # bench.py bench_train


def train_config(torch, bs: int, dtype: str = "float32"):
    """The conditional-generation training configuration of `bench.py
    --config train_conditional` on the flagship model (phase
    conditional_generation, n_embed 16384, depth_range (7, 16), as JAX's
    flagship_config): remat, flash attention (the port's AttnBlock takes
    it at batch >= 2), LossConfig(disc_start=0), LR 1e-4; with dtype
    "bfloat16", `--train_dtype bfloat16` (train_conditional_bf16)."""
    import dataclasses

    from sgam_neurips22_tpu_torch.serving import flagship_config
    from sgam_neurips22_tpu_torch.training.losses import LossConfig
    from sgam_neurips22_tpu_torch.training.train_step import TrainConfig

    if bs < 2:
        raise ValueError("the training phases run flash attention, which AttnBlock takes at batch >= 2")
    model = flagship_config(compute_dtype=dtype)
    model = dataclasses.replace(model, ddconfig=dataclasses.replace(model.ddconfig, remat=True))
    return TrainConfig(model=model, loss=LossConfig(disc_start=0), learning_rate=TRAIN_LR)


def train_batch(torch, np, bs: int, device, seed: int = 2) -> dict:
    """bench.py's conditional batch (n_src 2, 256^2), from numpy seed `seed`."""
    rng = np.random.default_rng(seed)
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


def run_train(torch, np, counters, failures, dtype: str = "float32") -> tuple:
    """The training phase with the model in `dtype`: state, a warm-up
    step, TRAIN_STEPS timed steps (launches counted), parameter movement
    checks, one profiled step."""
    from sgam_neurips22_tpu_torch.training.lpips import random_lpips
    from sgam_neurips22_tpu_torch.training.train_step import create_train_state, split_params, train_step

    cfg = train_config(torch, TRAIN_BATCH, dtype)
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
        "compute_dtype": dtype, "batch": TRAIN_BATCH, "steps": TRAIN_STEPS, "seconds": dt,
        "ms_per_step": dt / TRAIN_STEPS * 1e3,
        "images_per_s": TRAIN_BATCH * TRAIN_STEPS / dt, "warmup_seconds": warm, "setup_seconds": setup_s,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches_per_step": launches,
        "launches": totals,
        "finite": finite, "logs": logs, "trainable_tensors": len(trainable), "frozen_tensors": len(frozen),
        "trainable_unmoved": unmoved, "frozen_moved": moved_frozen,
    }
    want = {"zbuffer_min": 1, "nearest_codeword": 1, "flash_attention_fwd": 12,
            "flash_attention_dq": 7, "flash_attention_dkv": 7}
    if not exact or launches != want:
        failures.append(f"train ({dtype}) launch counts per step {launches} (whole steps: {exact}) != {want}")
    if not finite or unmoved or moved_frozen:
        failures.append(f"train ({dtype}): finite={finite} trainable unmoved={unmoved} frozen moved={moved_frozen}")
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


def grad_distances(torch, grads, ref, skip=()) -> dict:
    """Per tensor (skipping `skip`): (the L2 norm of grads - ref over that
    of ref, the L2 norm of grads over that of ref)."""
    return {n: (float((grads[n] - ref[n]).norm() / ref[n].norm()), float(grads[n].norm() / ref[n].norm()))
            for n in ref if n not in skip}


def zeroed_dv(attention):
    """A planted fault: attention.flash_attention_bwd with dV zeroed."""
    bwd = attention.flash_attention_bwd

    def faulty(*args):
        dq, dk, dv = bwd(*args)
        return dq, dk, dv.new_zeros(dv.shape)

    return faulty


def parity_train_bf16(torch, np, failures, bs: int = 2, seed: int = SEED, batch_seed: int = 2) -> dict:
    """One training step at batch `bs` with the model in bf16, on the card
    and on the CPU, each held to the same step in f32 on the CPU, at inputs
    where bf16 rounding moves no latent to another codeword: rows 0..P-1 of
    the codebook are the batch's f32 latents (P = bs * 16 * 16), so each
    latent is its own nearest codeword at distance 0, and bf16 moves it by
    about 1% of its length while the nearest other latent lies tens of
    percent of it away. (On the init codebook bf16 flips 5-7% of the
    codewords, which moves a gradient by tens of percent of its tensor's
    largest, as much as a dropped gradient.) Model weights from `seed`,
    the batch from numpy seed `batch_seed`.

    Runs: f32 on the CPU (the reference), bf16 on the CPU and on the card,
    and a control, the card's bf16 step with dV of every flash-attention
    backward zeroed, which has to fail the gradient gate. bf16 rounding
    alone moves this step's gradients by about half their L2 norm (the
    median over the tensors 0.45-0.49 on the card and on the CPU, seeds
    0-2, studies/bf16_train_parity.py; 0.22 at the tests' TINY size, in
    JAX's own bf16 step as in the port's): at random weights each gradient
    is a small residual of cancelling terms. So no gate can hold a tensor
    near f32, and the gates are these:
    - codeword indices before the step: 0..P-1 in every run;
    - logs, each bf16 run against the f32 step: within 2^-6 |f32| + 1e-3;
      d_weight, a ratio of two gradient norms, within 0.15 |f32| (measured
      0.007-0.053 on the CPU, 0.033-0.094 on the card), and aeloss and
      total_loss, which hold d_weight * g_loss, within 0.15 |d_weight *
      g_loss| more;
    - gradients, per trainable tensor: its L2 norm within (0.5, 2) times
      the f32 step's in both bf16 runs (rounding noise adds to a norm, a
      dropped gradient reads 0 and a doubled one 2); against the f32 step,
      the card's worst L2 distance over the f32 norm within 2 times the
      CPU's worst, and its median over the tensors within 1.5 times the
      CPU's. Tensors whose f32 gradient is below 1e-5 of the step's largest
      (the key biases, which the softmax cancels) are held below 1e-3 of
      the step's largest instead."""
    from sgam_neurips22_tpu_torch.models.vqgan.quantize import nearest_codeword_indices
    from sgam_neurips22_tpu_torch.ops import attention
    from sgam_neurips22_tpu_torch.training.lpips import random_lpips
    from sgam_neurips22_tpu_torch.training.train_step import (
        create_train_state,
        model_inputs,
        split_params,
        train_step,
    )

    cfg32, cfg16 = train_config(torch, bs), train_config(torch, bs, "bfloat16")
    batch = train_batch(torch, np, bs, "cpu", batch_seed)
    with torch.no_grad():
        x, _, mask = model_inputs(batch, cfg32)
        latents = create_train_state(cfg32, seed=seed, device="cpu").model.encode_prequant(x, mask)
        latents = latents.reshape(-1, latents.shape[-1])
    p = latents.shape[0]
    kernel_bwd, runs = attention.flash_attention_bwd, {}
    for run, cfg, dev in (("f32", cfg32, "cpu"), ("cpu", cfg16, "cpu"), ("cuda", cfg16, "cuda"),
                          ("control", cfg16, "cuda")):
        if run == "control":
            attention.flash_attention_bwd = zeroed_dv(attention)
        try:
            t0 = time.perf_counter()
            state = create_train_state(cfg, seed=seed, device=dev)
            lpips = random_lpips(seed + 2).to(dev)
            b = {k: v.to(dev) for k, v in batch.items()}
            with torch.no_grad():
                state.model.codebook[:p] = latents.to(dev)
                xd, _, md = model_inputs(b, cfg)
                pre = state.model.encode_prequant(xd, md)
                idx = nearest_codeword_indices(pre.reshape(-1, pre.shape[-1]), state.model.codebook).cpu()
            _, logs = train_step(state, b, lpips, cfg)
            grads = {n: g.grad.detach().cpu().double() for n, g in split_params(state.model, cfg.phase)[0]}
            runs[run] = ({k: float(v) for k, v in logs.items()}, idx, grads, time.perf_counter() - t0)
            del state, lpips, b, pre
        finally:
            attention.flash_attention_bwd = kernel_bwd
    f_logs, f_idx, f_grads, f_s = runs.pop("f32")
    top = max(float(g.abs().max()) for g in f_grads.values())
    noise = sorted(n for n, g in f_grads.items() if float(g.abs().max()) < 1e-5 * top)
    own = np.arange(p)
    res = {"batch": bs, "seed": seed, "batch_seed": batch_seed, "codebook_rows_from_latents": p,
           "f32_seconds": f_s, "f32_logs": f_logs, "f32_index_is_own_row": bool((f_idx.numpy() == own).all()),
           "grad_noise_tensors": noise}
    tol = {k: 2**-6 * abs(v) + 1e-3 for k, v in f_logs.items()}
    tol["train/d_weight"] = 0.15 * abs(f_logs["train/d_weight"])
    for k in ("aeloss", "train/total_loss"):
        tol[k] += 0.15 * abs(f_logs["train/d_weight"] * f_logs["train/g_loss"])
    for run, (logs, idx, grads, secs) in runs.items():
        dist = grad_distances(torch, grads, f_grads, noise)
        err = {n: d[0] for n, d in dist.items()}
        res[run] = {
            "seconds": secs, "logs": logs, "index_is_own_row": float((idx.numpy() == own).mean()),
            "log_err_vs_f32": {k: abs(logs[k] - f_logs[k]) for k in f_logs},
            "logs_ok": all(abs(logs[k] - f_logs[k]) <= tol[k] for k in f_logs),
            "grad_distances_vs_f32": dist,
            "grad_worst_vs_f32": max(err.items(), key=lambda kv: kv[1]),
            "grad_median_vs_f32": float(np.median(list(err.values()))),
            "grad_norm_ratio_range": [min(d[1] for d in dist.values()), max(d[1] for d in dist.values())],
            "grad_norm_off": sorted(n for n, d in dist.items() if not 0.5 < d[1] < 2.0),
            "grad_noise_max": max((float(grads[n].abs().max()) / top for n in noise), default=0.0),
        }
    c = res["cpu"]
    for run in ("cpu", "cuda", "control"):
        g = res[run]
        g["grads_ok"] = (not g["grad_norm_off"] and g["grad_noise_max"] <= 1e-3
                         and g["grad_worst_vs_f32"][1] <= 2.0 * c["grad_worst_vs_f32"][1]
                         and g["grad_median_vs_f32"] <= 1.5 * c["grad_median_vs_f32"])
        g["ok"] = res["f32_index_is_own_row"] and g["index_is_own_row"] == 1.0 and g["logs_ok"] and g["grads_ok"]
    res["control_fails"] = not res["control"]["grads_ok"]
    res["ok"] = res["cpu"]["ok"] and res["cuda"]["ok"] and res["control_fails"]
    for run in ("cpu", "cuda", "control"):  # the per-tensor table goes to --out only
        res[f"{run}_grad_distances_vs_f32"] = res[run].pop("grad_distances_vs_f32")
    if not res["ok"]:
        failures.append(f"bf16 training step GPU vs CPU: { {k: v for k, v in res.items() if 'distances' not in k} }")
    return res


MAP_GRID = (3, 3)  # bench.py --config integration: 8 frames on a 3x3 grid
MAP_BATCH_GRID = (7, 7)  # bench.py batched_8_scenes_tsdf: --frames 48 on a 7x7 grid
MAP_STRIDE2_GRID = (2, 2)  # integration_clevr_stride2, cut from 3x3 (8 frames) to 3 frames for time
MAP_PARITY_FRAMES = 3  # generated frames that map_parity fuses after the seed


def map_config(dataset: str, grid, coherent: bool = False, stride: int = 1):
    """bench.py's map-requery configuration of `dataset` on `grid`: its
    auto-sized volume and defaults (splat re-query), 256^2, topk 1, every
    `stride`-th ray fused (--tsdf_stride)."""
    from sgam_neurips22_tpu_torch.pipeline.scene_generation import SceneGenConfig

    return SceneGenConfig(dataset=dataset, output_dim=grid, topk=1, image_resolution=(H, W),
                          use_rgbd_integration=True, coherent_plane_depth=coherent, tsdf_integrate_stride=stride)


def pool_telemetry(np, gen) -> dict:
    """The map's telemetry as bench.py prints it (live and lifetime pool
    slots, dropped, recycled), the fused share of valid depth samples, and
    the volume's layout."""
    cfg = gen.tsdf_cfg
    counts = gen.volume.cell_counts.cpu().numpy()
    frac, n_valid, dropped, recycled = gen.fusion_stats()
    return {"pool_live_slots": int(np.minimum(counts, cfg.cell_cap).sum()), "pool_lifetime_slots": int(counts.sum()),
            "pool_dropped": int(dropped), "pool_recycled": int(recycled), "fusion_fraction": frac,
            "valid_samples": n_valid, "volume": {"dims": list(cfg.dims), "voxel_size": cfg.voxel_size,
                                                 "band": cfg.band, "pool_cells": cfg.n_cells,
                                                 "cell_cap": cfg.cell_cap, "chunk": cfg.chunk}}


def capture_pool_splat(torch, gen, run=None):
    """(pix, key) of the pool splat at the last frame of one more unroll
    from the seeds (run(), default gen's own unroll): the z-buffer's input
    as the map built it."""
    from sgam_neurips22_tpu_torch.mapping import tsdf

    keep, orig = {}, tsdf.pool_splat_keys

    def spy(*args, **kw):
        out = orig(*args, **kw)
        keep["pix"], keep["key"] = out[0].clone(), out[1].clone()
        return out

    tsdf.pool_splat_keys = spy
    try:
        if run is None:
            gen.reset()
            gen.scene_expansion()
        else:
            run()
    finally:
        tsdf.pool_splat_keys = orig
    torch.cuda.synchronize()
    return keep["pix"], keep["key"]


def last_step(torch, gen) -> dict:
    """Device inputs of the trajectory's last step (its target pose, its
    sources and their transforms) and that frame's depth, for timing the
    map's functions at the phase's shapes."""
    src, _, _, _, t2s, w2c = gen._step_inputs_host(gen.order[-1], len(gen.order) - 1)
    tgt = gen.grid.index(*gen.order[-1])
    dev = gen.device
    return {"src": torch.as_tensor(src, device=dev), "t2s": torch.as_tensor(t2s, device=dev),
            "w2c": torch.as_tensor(w2c, device=dev), "depth": gen.depth_buf[tgt]}


def map_times(torch, gen) -> dict:
    """Time per call of the map's functions at the phase's shapes, on a copy
    of the volume at the phase's end: render_depth (the splat, and its
    whole-pool projection alone), inverse_warp_multi_src and integrate
    (into the copy). "<name>_ms" is CUDA-event time back to back (cuda_ms),
    which holds the gaps while the host launches at batch 1;
    "<name>_device_ms" the kernels' own summed time (device_ms)."""
    from sgam_neurips22_tpu_torch.geometry.warp import inverse_warp_multi_src
    from sgam_neurips22_tpu_torch.mapping.tsdf import integrate, pool_splat_keys, render_depth

    vol, cfg, k, st = gen.volume.to(gen.device), gen.tsdf_cfg, gen.ks[0], last_step(torch, gen)
    near, far = gen.near_far
    depth = render_depth(vol, cfg, k, st["w2c"], (H, W), near, far)
    rgb_s, depth_s = gen.rgb_buf[st["src"]][None], gen.depth_buf[st["src"]][None]
    fns = {
        "render_depth": lambda: render_depth(vol, cfg, k, st["w2c"], (H, W), near, far),
        "pool_projection": lambda: pool_splat_keys(vol, cfg, k, st["w2c"][None], (H, W), near, far),
        "inverse_warp_multi_src": lambda: inverse_warp_multi_src(rgb_s, depth_s, depth[None], gen.ks[None], k[None],
                                                                 st["t2s"][None]),
        "integrate": lambda: integrate(vol, cfg, st["depth"], None, k, st["w2c"]),
    }
    out = {"pool_slots": cfg.capacity, "pool_splat_rows": [cfg.n_cells * -(-cfg.cell_cap // cfg.chunk), cfg.chunk]}
    for name, fn in fns.items():
        out[f"{name}_ms"] = cuda_ms(torch, fn, 20, 2)
        out[f"{name}_device_ms"] = device_ms(torch, fn, 20, 2)
    return out


def sync_free(torch, gen, failures) -> dict:
    """render_depth (the splat) and integrate once each at the phase's
    shapes under torch.cuda.set_sync_debug_mode("error"), which raises at
    any call that waits for the device: the map's per-frame loop must not."""
    from sgam_neurips22_tpu_torch.mapping.tsdf import integrate, render_depth

    vol, st = gen.volume.to(gen.device), last_step(torch, gen)
    torch.cuda.synchronize()
    res = {"render_depth": None, "integrate": None}
    torch.cuda.set_sync_debug_mode("error")
    try:
        for name, fn in (("render_depth", lambda: render_depth(vol, gen.tsdf_cfg, gen.ks[0], st["w2c"], (H, W),
                                                                 *gen.near_far)),
                         ("integrate", lambda: integrate(vol, gen.tsdf_cfg, st["depth"], None, gen.ks[0], st["w2c"]))):
            try:
                fn()
                res[name] = "no synchronisation"
            except RuntimeError as e:
                res[name] = f"synchronised: {str(e)[:200]}"
                failures.append(f"sync_free: {name} synchronised with the device: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return res


def map_phase(torch, np, gen, frames: int, counters, failures, name: str, card: str) -> tuple:
    """unroll_phase for a map-requery unroll (zbuffer_min and
    nearest_codeword once a frame, no flash attention), with the pool
    telemetry, the map's times alone, the sync check, and the pool splat's
    input at the last frame: (report, profile, (pix, key))."""
    t0 = time.perf_counter()
    want = {"zbuffer_min": frames, "nearest_codeword": frames, "flash_attention_fwd": 0, "flash_attention_dq": 0,
            "flash_attention_dkv": 0}
    (rgb, _), rep, prof = unroll_phase(torch, gen.scene_expansion, frames, counters, want, failures, name, gen.reset)
    rep.update(card=card, dataset=gen.cfg.dataset, grid=list(gen.cfg.output_dim),
               sources=gen.cfg.effective_num_src, coherent_plane_depth=gen.cfg.coherent_plane_depth,
               frames_differ=not torch.equal(rgb[gen.grid.index(*gen.order[1])], rgb[gen.grid.index(*gen.order[-1])]),
               **pool_telemetry(np, gen))
    if not rep["frames_differ"]:
        failures.append(f"{name}: the first and last generated frames are equal")
    rep["map_ms"] = map_times(torch, gen)
    rep["sync_free"] = sync_free(torch, gen, failures)
    pix, key = capture_pool_splat(torch, gen)
    rep["pool_splat_shape"] = list(pix.shape)
    rep["phase_seconds"] = time.perf_counter() - t0
    return rep, prof, (pix, key)


def state_equal(torch, a, b) -> dict:
    """The integer state and telemetry of two volumes, field by field
    (bit-exact), and the grid's largest difference and the voxels whose
    observedness (grid != 0) differs."""
    a_grid, b_grid = a.grid.cpu(), b.grid.cpu()
    res = {f: torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
           for f in ("pool_ids", "cell_counts", "inpool", "claim", "frame", "stats")}
    res.update(grid_bit_exact=torch.equal(a_grid, b_grid), grid_max_abs_diff=float((a_grid - b_grid).abs().max()),
               grid_values_differing=int((a_grid != b_grid).sum()),
               observedness_differing=int(((a_grid != 0) != (b_grid != 0)).sum()),
               observed_voxels=int((b_grid != 0).sum()))
    return res


# map_parity's gate on the grid, card against CPU: index_add_ sums in
# another order on the card (atomics), so a float sum may differ in its
# last bits, and a sum that cancels may read 0 on one side alone (PERF.md:
# at most 4.8e-7 apart, 14 of 1.7 M observed voxels flipped). The integer
# state is held bit-exact.
GRID_MAX_ABS_DIFF = 1e-5
GRID_OBSERVEDNESS_SHARE = 1e-4


def integrate_parity(torch, gen, cfg, frames: int) -> dict:
    """The seed frame and the first `frames` generated frames of `gen`'s
    unroll, at their poses, fused into a new volume on the card and one on
    the CPU, f32; their states compared (state_equal)."""
    from sgam_neurips22_tpu_torch.mapping.tsdf import create_volume, integrate

    idx = [gen.grid.index(*c) for c in gen.order[: frames + 1]]
    k = gen.ks[0]
    vols = []
    for dev in (gen.device, "cpu"):
        vol = create_volume(cfg, device=dev)
        for i in idx:
            integrate(vol, cfg, gen.depth_buf[i].to(dev), None, k.to(dev), gen._w2c(i).to(dev))
        vols.append(vol)
    res = state_equal(torch, *vols)
    res.update(frames=len(idx), integrate_stride=cfg.integrate_stride)
    res["ok"] = (all(res[f] for f in ("pool_ids", "cell_counts", "inpool", "claim", "frame", "stats"))
                 and res["grid_max_abs_diff"] <= GRID_MAX_ABS_DIFF
                 and res["observedness_differing"] <= GRID_OBSERVEDNESS_SHARE * res["observed_voxels"])
    del vols
    return res


def render_parity(torch, gen) -> dict:
    """render_depth from the volume at the phase's end, on the card and on a
    CPU copy, at the last step's pose: the pool splat's z-buffer input and
    winners (the card's kernel against the CPU's plain version) and depth,
    and the raycast's depth, nearest and trilinear."""
    from sgam_neurips22_tpu_torch.mapping.tsdf import pool_splat_keys, render_depth
    from sgam_neurips22_tpu_torch.ops.zbuffer import zbuffer_min, zbuffer_min_plain

    st, near_far = last_step(torch, gen), gen.near_far
    args = ((gen.volume, gen.tsdf_cfg, gen.ks[0], st["w2c"]),
            (gen.volume.to("cpu"), gen.tsdf_cfg, gen.ks[0].cpu(), st["w2c"].cpu()))
    keys = [pool_splat_keys(a[0], a[1], a[2], a[3][None], (H, W), *near_far) for a in args]
    wins = (zbuffer_min(*keys[0][:2], H, W).cpu(), zbuffer_min_plain(*keys[1][:2], H, W))
    res = {"splat_keys_bit_exact": all(torch.equal(keys[0][i].cpu(), keys[1][i]) for i in range(3)),
           "zbuffer_winners_bit_exact": torch.equal(*wins)}
    for name, kw in (("splat", {}), ("raycast_nearest", {"method": "raycast"}),
                     ("raycast_trilinear", {"method": "raycast", "interp": "trilinear"})):
        got, ref = (render_depth(*a, (H, W), *near_far, n_samples=gen.cfg.raycast_samples, **kw).cpu() for a in args)
        res[name] = {"bit_exact": torch.equal(got, ref), "differing_pixel_share": float((got != ref).float().mean()),
                     "max_abs_diff": float((got - ref).abs().max()), "hit_share": float((ref > 0).float().mean())}
    # the gate: the z-buffer bit-exact, and every depth bit-exact (all ops
    # are IEEE elementwise arithmetic and integer gathers on both)
    res["ok"] = (res["splat_keys_bit_exact"] and res["zbuffer_winners_bit_exact"]
                 and all(res[n]["bit_exact"] for n in ("splat", "raycast_nearest", "raycast_trilinear")))
    return res


def map_parity(torch, np, gen_clevr, gen_ge, cpu_model, seeds, failures) -> dict:
    """The map on the card against the CPU, f32 (module docstring)."""
    import dataclasses

    from sgam_neurips22_tpu_torch.pipeline.scene_generation import InfiniteSceneGeneration

    res = {"integrate": {
        "clevr": integrate_parity(torch, gen_clevr, gen_clevr.tsdf_cfg, MAP_PARITY_FRAMES),
        "google_earth": integrate_parity(torch, gen_ge, gen_ge.tsdf_cfg, MAP_PARITY_FRAMES),
        "google_earth_stride2": integrate_parity(torch, gen_ge, dataclasses.replace(gen_ge.tsdf_cfg, integrate_stride=2),
                                                 MAP_PARITY_FRAMES),
    }, "render": {"clevr": render_parity(torch, gen_clevr), "google_earth": render_parity(torch, gen_ge)},
        "gates": {"grid_max_abs_diff": GRID_MAX_ABS_DIFF, "grid_observedness_share": GRID_OBSERVEDNESS_SHARE}}
    # frame 1 of the f32 map-requery unroll, the CPU's map a copy of the card's
    cfg = map_config("clevr-infinite", MAP_GRID)
    gen = InfiniteSceneGeneration(copy.deepcopy(cpu_model), cfg, seeds, device=gen_clevr.device)
    gen_c = InfiniteSceneGeneration(cpu_model, cfg, seeds, device="cpu")
    gen_c.volume = gen.volume.to("cpu")
    with torch.inference_mode():
        batches = (gen.requery_batch(gen.build_plan(), 0), gen_c.requery_batch(gen_c.build_plan(), 0))
    res["step"] = parity_step(torch, gen, cpu_model, failures, batches=batches)
    del gen, gen_c
    for group in ("integrate", "render"):
        for name, r in res[group].items():
            if not r["ok"]:
                failures.append(f"map_parity {group} {name}: {r}")
    res["ok"] = res["step"]["ok"] and all(r["ok"] for g in ("integrate", "render") for r in res[g].values())
    return res


def check_zbuffer_map(torch, cases: dict, failures) -> list:
    """The z-buffer merge at the map's own shapes, on the (pix, key) that
    the pool splat built at a phase's last frame: bit-exact against the
    plain version on the route zbuffer_plan picks and on each route alone,
    with the time of the whole call, of each route (ms and kernels alone),
    of the plain version and of scatter_reduce amin, and the byte bound."""
    from sgam_neurips22_tpu_torch.ops.zbuffer import (
        IMAX, ROUTES, _launch, route_plan, zbuffer_min, zbuffer_min_plain, zbuffer_plan)

    rows = []
    for name, (pix, key) in cases.items():
        b, p = pix.shape
        ref = zbuffer_min_plain(pix, key, H, W)
        outs = {"plan": zbuffer_min(pix, key, H, W),
                **{r: _launch(pix, key, H, W, route_plan(r, b, p, H, W)) for r in ROUTES}}
        torch.cuda.synchronize()
        exact = {r: torch.equal(o, ref) for r, o in outs.items()}
        base, idx = torch.full((b, H * W), IMAX, dtype=torch.int32, device=pix.device), pix.long()
        b_ms, b_by = bound(2 * 4 * b * p + 4 * b * H * W, 0)
        row = {
            "case": name, "shape": {"pix": [b, p], "pixels": H * W}, **zbuffer_plan(b, p, H, W)._asdict(),
            "ok": all(exact.values()), "bit_exact": exact["plan"], "routes_bit_exact": exact,
            "max_abs_err": max(int((o.long() - ref.long()).abs().max()) for o in outs.values()),
            "valid_points": int((key != IMAX).sum()),
            **timings(torch, lambda: zbuffer_min(pix, key, H, W), lambda: zbuffer_min_plain(pix, key, H, W),
                      lambda: torch.scatter_reduce(base, 1, idx, key, "amin")),
            "route_ms": {r: device_ms(torch, lambda r=r: _launch(pix, key, H, W, route_plan(r, b, p, H, W)))
                         for r in ROUTES},
            "route_kernel_only_ms": {r: device_ms(torch, lambda r=r: _launch(pix, key, H, W, route_plan(r, b, p, H, W)),
                                                  match=ZB_KERNELS) for r in ROUTES},
            "bound_ms": b_ms, "bound_by": b_by, "bytes": 2 * 4 * b * p + 4 * b * H * W,
        }
        row["bound_share"] = b_ms / row["ms"]
        rows.append(row)
        if not row["ok"]:
            failures.append(f"zbuffer_min differs from zbuffer_min_plain at the map's shape {name}: {row}")
    return rows


def volume_bytes(vol) -> int:
    """Device bytes of a TSDF volume's state."""
    import dataclasses

    return sum(getattr(vol, f.name).numel() * getattr(vol, f.name).element_size() for f in dataclasses.fields(vol))


def batched_pool_telemetry(np, gen) -> dict:
    """The batched map's telemetry: each scene's live, lifetime and
    recycled pool slots (recycled: the bookings past a cell's capacity,
    each of which reused a slot), the batch's dropped and recycled slots and
    fused share from the volume's stats (summed over scenes), and its bytes."""
    from sgam_neurips22_tpu_torch.mapping.tsdf import fusion_fraction

    cfg, vol = gen.tsdf_cfg, gen.batched_volume
    counts = vol.cell_counts.cpu().numpy().reshape(-1, cfg.n_cells).astype(np.int64)
    frac, n_valid, dropped, recycled = fusion_fraction(vol)
    scenes = [{"pool_live_slots": int(np.minimum(c, cfg.cell_cap).sum()), "pool_lifetime_slots": int(c.sum()),
               "pool_recycled": int(np.maximum(c - cfg.cell_cap, 0).sum())} for c in counts]
    return {"scenes_pool": scenes, "pool_dropped": int(dropped), "pool_recycled": int(recycled),
            "pool_recycled_matches_scenes": int(recycled) == sum(x["pool_recycled"] for x in scenes),
            "fusion_fraction": frac, "valid_samples": n_valid, "volume_bytes": volume_bytes(vol),
            "volume": {"dims": list(cfg.dims), "voxel_size": cfg.voxel_size, "band": cfg.band,
                       "pool_cells": cfg.n_cells, "cell_cap": cfg.cell_cap, "chunk": cfg.chunk}}


def map_parity_batched(torch, np, cpu_model, cpu_model16, seeds_batch, failures) -> dict:
    """One batched map-requery step of 2 scenes (CLEVR, MAP_GRID), card
    against CPU, from one seeded volume (the CPU's a copy of the card's):
    the f32 step under parity_step's gates and the bf16 step under
    parity_step_bf16's; then the card's f32 frames fused into the card's
    volume and into a CPU copy of it, whose states must agree as
    integrate_parity's (the integer state bit-exact)."""
    from sgam_neurips22_tpu_torch.mapping.tsdf import integrate
    from sgam_neurips22_tpu_torch.pipeline.scene_generation import InfiniteSceneGeneration

    seeds2, cfg = seeds_batch[:2], map_config("clevr-infinite", MAP_GRID)
    res = {"scenes": len(seeds2)}
    for name, model_c in (("f32", cpu_model), ("bf16", cpu_model16)):
        gen = InfiniteSceneGeneration(copy.deepcopy(model_c), cfg, seeds2[0], device="cuda")
        gen_c = InfiniteSceneGeneration(model_c, cfg, seeds2[0], device="cpu")
        with torch.inference_mode():
            rgb_flat, depth_flat = gen.batched_buffers(seeds2)
            vol = gen.seeded_volume(seeds2, depth_flat)
            vol_c = vol.to("cpu")
            plan, plan_c = gen.build_plan(), gen_c.build_plan()
            batches = (gen.requery_batch(plan, 0, rgb_flat, depth_flat, vol),
                       gen_c.requery_batch(plan_c, 0, rgb_flat.cpu(), depth_flat.cpu(), vol_c))
        if name == "f32":
            res[name] = parity_step(torch, gen, cpu_model, failures, batches=batches)
            with torch.inference_mode():
                gen._step(plan, 0, rgb_flat, depth_flat, vol, None)
                tgt = [s * gen.grid.size + plan["tgt"][0] for s in range(len(seeds2))]
                integrate(vol_c, gen.tsdf_cfg, depth_flat[tgt].cpu(), None, gen.ks[0].cpu(), plan["tgt_w2c"][0].cpu())
            st = state_equal(torch, vol, vol_c)
            st["ok"] = (all(st[f] for f in ("pool_ids", "cell_counts", "inpool", "claim", "frame", "stats"))
                        and st["grid_max_abs_diff"] <= GRID_MAX_ABS_DIFF
                        and st["observedness_differing"] <= GRID_OBSERVEDNESS_SHARE * st["observed_voxels"])
            res["state_after_step"] = st
            if not st["ok"]:
                failures.append(f"map_parity_batched: the volume after the step, card vs CPU: {st}")
        else:
            res[name] = parity_step_bf16(torch, gen, cpu_model16, cpu_model, failures, batches=batches)
        del gen, gen_c, vol, vol_c, batches
        torch.cuda.empty_cache()
    res["ok"] = res["f32"]["ok"] and res["bf16"]["ok"] and res["state_after_step"]["ok"]
    return res


def ply_counts(path) -> dict:
    """The element counts of a binary PLY's header and whether the file's
    size is the header's plus the records they announce (15-byte vertices:
    3 float + 3 uchar; 13-byte faces: a count and 3 int)."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    counts = {line.split()[1]: int(line.split()[2]) for line in data[:end].decode().splitlines()
              if line.startswith("element")}
    size = end + 15 * counts.get("vertex", 0) + 13 * counts.get("face", 0)
    return {**counts, "bytes": len(data), "size_matches_header": size == len(data)}


def write_template(np, rng, root: Path) -> None:
    """A clevr-infinite seed template in the reference layout at H x W: an
    8-bit RGB PNG and its ray depth, U(8, 14), at grid (0, 0)."""
    from sgam_neurips22_tpu_torch.pipeline.png import write_png

    root.mkdir(parents=True)
    write_png(str(root / "im_00000_00_00.png"), rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
    np.save(root / "dm_00000_00_00.npy", rng.uniform(8, 14, (H, W)).astype(np.float32))


def write_pose_file(np, path: Path, n: int) -> None:
    """A KITTI-360-style cam0_to_world.txt: n camera -> world poses along the
    clevr-infinite grid's first row, frame indices 10, 12, 14, ..."""
    from sgam_neurips22_tpu_torch.pipeline.trajectory import prepare_grid

    grid = prepare_grid("clevr-infinite", (1, n))
    np.savetxt(path, np.stack([np.concatenate([[10 + 2 * k], grid.c2w(k).reshape(-1)]) for k in range(n)]))


GENERATE_RUNS = (  # (name, generate.py flags, frames generated): the map run writes the mesh
    ("map_requery_2x2", ["--rows", "2", "--cols", "2", "--use_rgbd_integration"], 3),
    ("spiral", ["--rows", "4", "--trajectory", "spiral"], 3),
    ("cylinder", ["--rows", "4", "--trajectory", "cylinder"], 3),
    ("pose_file", ["--rows", "4", "--trajectory", "trajectory"], 3),
)


def coherent_export(torch, np, model, seeds, out_dir: Path) -> dict:
    """The exports of a coherent-plane map (CLEVR, MAP_GRID, every depth one
    world plane's, so the surface converges as with trained weights): the
    host seconds of export_frames, of export_point_clouds and of the mesh
    in it, and the PLY element counts. Random-weight depth turns nearly
    every observed voxel into triangles, which makes those exports
    host-bound (generate's map run)."""
    from sgam_neurips22_tpu_torch.mapping import mesh
    from sgam_neurips22_tpu_torch.pipeline.scene_generation import InfiniteSceneGeneration

    gen = InfiniteSceneGeneration(model, map_config("clevr-infinite", MAP_GRID, coherent=True), seeds, device="cuda")
    gen.reset([((0, 0), seeds[0][1], gen.plane_depth_at(0))])
    gen.scene_expansion()
    torch.cuda.synchronize()
    out, extract = {}, mesh.extract_mesh
    t0 = time.perf_counter()
    gen.export_frames(str(out_dir))
    out["export_frames_seconds"] = time.perf_counter() - t0

    def timed_extract(*a, **kw):
        t1 = time.perf_counter()
        try:
            return extract(*a, **kw)
        finally:
            out["mesh_seconds"] = time.perf_counter() - t1

    mesh.extract_mesh = timed_extract
    try:
        t0 = time.perf_counter()
        gen.export_point_clouds(str(out_dir))
        out["export_point_clouds_seconds"] = time.perf_counter() - t0
    finally:
        mesh.extract_mesh = extract
    out["ply"] = {p.name: ply_counts(p) for p in sorted(out_dir.iterdir()) if p.suffix == ".ply"}
    out["ok"] = ("rgbd_integrated_trimesh.ply" in out["ply"]
                 and all(x["size_matches_header"] for x in out["ply"].values()))
    return out


def generate_phase(torch, np, cpu_model, counters, failures, model16=None, seeds=None) -> dict:
    """The port's generate CLI (`sgam_neurips22_tpu_torch.generate.main`) on
    the card, its default device, from a seed template and a reference-
    layout .ckpt of the seeded random f32 weights that the phase writes,
    once per GENERATE_RUNS entry with --output_dir: the file names of the
    reference's layout (im_/dm_/R_/t_ a frame, merged_pcds.ply, and under
    map re-query rgbd_integrated_mesh.ply and rgbd_integrated_trimesh.ply),
    PLY sizes that match their headers, one z-buffer and one codeword launch
    a generated frame, and the host seconds of the unroll, the frame and
    point-cloud exports and the mesh apart. With model16 and seeds it
    also times the exports of a coherent-plane map (coherent_export)."""
    import tempfile

    from sgam_neurips22_tpu_torch import generate
    from sgam_neurips22_tpu_torch.mapping import mesh
    from sgam_neurips22_tpu_torch.pipeline.ordering import ORDERS
    from sgam_neurips22_tpu_torch.pipeline.scene_generation import InfiniteSceneGeneration as Gen

    timers: dict[str, float] = {}

    def timed(name, fn):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                timers[name] = timers.get(name, 0.0) + time.perf_counter() - t0
        return wrapper

    patched = {(Gen, n): getattr(Gen, n) for n in ("scene_expansion", "export_frame", "export_frames",
                                                   "export_point_clouds")}
    patched[(mesh, "extract_mesh")] = mesh.extract_mesh
    out: dict = {"runs": {}}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_template(np, np.random.default_rng(SEED + 5), root / "templates")
        t0 = time.perf_counter()
        torch.save({"state_dict": cpu_model.state_dict()}, root / "last.ckpt")
        out["ckpt_write_seconds"] = time.perf_counter() - t0
        write_pose_file(np, root / "cam0_to_world.txt", 6)
        for (obj, name), fn in patched.items():
            setattr(obj, name, timed(name, fn))
        try:
            for name, flags, frames in GENERATE_RUNS:
                timers.clear()
                out_dir = root / name
                argv = ["--dataset", "clevr-infinite", "--ckpt", str(root / "last.ckpt"), "--template_dir",
                        str(root / "templates"), "--output_dir", str(out_dir), "--resolution", str(H), *flags]
                if name == "pose_file":
                    argv += ["--pose_file", str(root / "cam0_to_world.txt")]
                for fn in counters:
                    fn.launches = 0
                t0 = time.perf_counter()
                generate.main(argv)
                torch.cuda.synchronize()
                total = time.perf_counter() - t0
                launches = {fn.__name__: fn.launches for fn in counters}
                rows, cols = int(flags[1]), int(flags[3]) if flags[2] == "--cols" else 1
                want = {f"{p}_{step:05d}_{i:02d}_{j:02d}.{e}"
                        for step, (i, j) in enumerate(ORDERS["zigzag"](rows, cols))
                        for p, e in (("im", "png"), ("dm", "npy"), ("R", "npy"), ("t", "npy"))}
                want.add("merged_pcds.ply")
                if "--use_rgbd_integration" in flags:
                    want |= {"rgbd_integrated_mesh.ply", "rgbd_integrated_trimesh.ply"}
                got = set(p.name for p in out_dir.iterdir())
                plys = {n: ply_counts(out_dir / n) for n in sorted(got) if n.endswith(".ply")}
                exports = sum(timers.get(n, 0.0) for n in ("export_frame", "export_frames", "export_point_clouds"))
                run = {
                    "frames": frames, "files_as_reference": got == want, "missing": sorted(want - got),
                    "unexpected": sorted(got - want), "ply": plys, "launches": launches,
                    "seconds": total, "setup_seconds": total - timers.get("scene_expansion", 0.0),
                    "unroll_seconds": timers.get("scene_expansion", 0.0) - exports,
                    "export_seconds": exports - timers.get("extract_mesh", 0.0),
                    "mesh_seconds": timers.get("extract_mesh", 0.0),
                }
                run["ok"] = (run["files_as_reference"] and all(x["size_matches_header"] for x in plys.values())
                             and launches["zbuffer_min"] == frames and launches["nearest_codeword"] == frames
                             and launches["flash_attention_fwd"] == 0)
                if not run["ok"]:
                    failures.append(f"generate {name}: {run}")
                out["runs"][name] = run
        finally:
            for (obj, name), fn in patched.items():
                setattr(obj, name, fn)
        if model16 is not None:
            out["coherent_export"] = coherent_export(torch, np, model16, seeds, root / "coherent")
            if not out["coherent_export"]["ok"]:
                failures.append(f"generate coherent_export: {out['coherent_export']}")
    out["ok"] = all(r["ok"] for r in out["runs"].values()) and out.get("coherent_export", {}).get("ok", True)
    return out


def seed_frames(np, rng, depth_range=(8, 14)) -> list:
    """One scene's seeds: a random frame at grid (0, 0), depths uniform in
    depth_range (bench.py's: (8, 14) for clevr-infinite, (0.5, 4.0) for
    google_earth)."""
    return [((0, 0), rng.uniform(-1, 1, (H, W, 3)).astype(np.float32),
             rng.uniform(*depth_range, (H, W)).astype(np.float32))]


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


def unroll_phase(torch, unroll, frames: int, counters, want: dict, failures, name: str, prepare=lambda: None,
                 per_step: int = 1) -> tuple:
    """timed_unroll, then the checks and the report of an unroll phase:
    finite frames, the launch counts `want`, and the device time by layer
    from one more (profiled) call. frames counts the generated frames of
    one call, per_step the frames of one step (the scenes)."""
    (rgb, depth), dt, warm, launches = timed_unroll(torch, unroll, counters, prepare)
    finite = bool(torch.isfinite(rgb).all() and torch.isfinite(depth).all())
    rep = {"frames": frames, "seconds": dt, "frames_per_s": frames / dt, "ms_per_frame": dt / frames * 1e3,
           "ms_per_step": dt / frames * per_step * 1e3, "warmup_seconds": warm, "launches": launches,
           "finite": finite, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    if not finite:
        failures.append(f"{name}: non-finite frames")
    if launches != want:
        failures.append(f"{name}: launch counts {launches} != {want}")
    prepare()
    prof = profile_unroll(torch, unroll, frames, dt)
    rep.update({k: v for k, v in prof.items() if k != "top"})
    return (rgb, depth), rep, prof


# ---------------------------------------------------------------- the trainer
# (the repository's configs at full width, on datasets written below from a seed)
CODEBOOK_YAML = "configs/codebooks/clevr-infinite.yaml"
CONDITIONAL_YAML = "configs/conditional_generation/clevr-infinite.yaml"
DATA_SCENES, DATA_FRAMES = 8, 18  # train split: 8 scenes x 18 frames (9 batches of 16); val: 1 scene
PAETH_EVERY = 2  # every second PNG of the dataset is hand-encoded with the Paeth filter
# the codebook run's overrides besides dataset_dir: a buffer of 8 steps, full
# after step 8, and a timeout of one step, so that the refresh fires at step 8
# with every codeword batch element 0 did not use at step 7 inactive
CODEBOOK_MAX_STEPS = 8
CODEBOOK_OVERRIDES = ("model.params.online_kmeans_config.train_feature_buffer_size=8",
                      "model.params.online_kmeans_config.frequency=8",
                      "model.params.online_kmeans_config.online_kmeans_word_timeout=1",
                      "model.params.online_kmeans_config.inactive_threshold=0.1")
CONDITIONAL_MAX_STEPS = 2  # fit stops after the step numbered max_steps: 3 steps
FIT_TIMED_STEPS = 5  # steps timed through Trainer.fit, after one untimed step, images off
LOADER_BATCH, LOADER_BATCHES = 16, 4  # batches per loader-rate measurement


def loader_rates(np, root: Path, by_filter: dict) -> dict:
    """Host examples/s of the Loader (batch 16, 8 decode threads, no device
    copy) after its first batch, over LOADER_BATCHES batches: one-PNG
    codebook examples, unfiltered and Paeth-filtered; the packed shard; and
    the conditional phase's pair examples (a target and 2 sources: 3 PNGs,
    half of them Paeth, and 3 depth files)."""
    from sgam_neurips22_tpu_torch.training.data.codebook_dataset import CodebookDataset
    from sgam_neurips22_tpu_torch.training.data.datamodule import Loader
    from sgam_neurips22_tpu_torch.training.data.packed import PackedCodebookDataset, shard_path
    from sgam_neurips22_tpu_torch.training.data.pair_dataset import ClevrInfinitePairs

    bs, out, lists = LOADER_BATCH, {}, {}
    for name, paths in by_filter.items():
        lists[name] = root / f"list_{name}.txt"
        lists[name].write_text("\n".join(paths[: bs * LOADER_BATCHES]))

    def rate(ds):
        """(seconds to the first batch, examples/s over the batches after it)"""
        loader = Loader(ds, bs, shuffle=True, seed=SEED)
        t0 = time.perf_counter()
        marks = []
        for i, _ in enumerate(loader):
            marks.append(time.perf_counter())
            if i + 1 == LOADER_BATCHES:
                break
        return {"first_batch_s": marks[0] - t0, "examples_per_s": bs * (len(marks) - 1) / (marks[-1] - marks[0])}

    for name in ("none", "paeth"):
        ds = CodebookDataset("train", str(root), "clevr-infinite", (H, W), training_images_list_file=str(lists[name]))
        out[f"png_{name}"] = rate(ds)
    out["packed"] = rate(PackedCodebookDataset(shard_path(str(root), "train", (H, W))))
    out["pairs"] = rate(ClevrInfinitePairs("train", str(root), 2, (H, W)))
    out["batch"] = bs
    return out


def run_train_cli(argv: list, observe=None):
    """The port's train CLI (`sgam_neurips22_tpu_torch.train.main`) in this
    process; the signal handlers it installs are put back afterwards.
    `observe(trainer_class)` may wrap methods for the run."""
    import signal

    from sgam_neurips22_tpu_torch import train as train_cli

    saved = {s: signal.getsignal(s) for s in (signal.SIGUSR1, signal.SIGUSR2, signal.SIGTERM)}
    try:
        return train_cli.main([*argv, "--no_wandb", "--lpips_weights", "", "--device", "cuda"])
    finally:
        for s, h in saved.items():
            signal.signal(s, h)


def checkpoint_costs(torch, trainer, root: Path) -> dict:
    """Bytes of the run's checkpoint file, and the seconds of one more save
    (into a scratch manager) and of its restore into the train state."""
    from sgam_neurips22_tpu_torch.core.checkpoint import CKPT_FILE, CheckpointManager, checkpoint_file

    mgr = CheckpointManager(str(root), save_interval_steps=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(trainer.state.step, trainer.checkpoint_dict(), force=True)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    trainer.load_checkpoint_dict(mgr.restore(map_location=trainer.device))
    torch.cuda.synchronize()
    return {"bytes": os.path.getsize(checkpoint_file(trainer.logdir)), "file": CKPT_FILE, "save_seconds": save_s,
            "restore_seconds": time.perf_counter() - t0}


def fit_timing(torch, trainer, counters) -> dict:
    """studies/trainer_host.fit_timing over FIT_TIMED_STEPS steps, with one
    more train_step profiled for the device's busy time by layer."""
    from sgam_neurips22_tpu_torch.studies.trainer_host import fit_timing as timing

    return timing(trainer, counters, FIT_TIMED_STEPS, profile=lambda fn, s: profile_unroll(torch, fn, 1, s))


def refresh_at_yaml_size(torch, yaml_path: str) -> dict:
    """The k-means refresh at the codebook YAML's own buffer
    (train_feature_buffer_size x 256 positions x embed_dim features, seeded
    N(0, 1)) with every codeword of its n_embed inactive: k = n_embed, 20
    Lloyd iterations, timed twice (the first includes the allocations)."""
    from sgam_neurips22_tpu_torch.core.config import load_configs
    from sgam_neurips22_tpu_torch.training.kmeans import KMeansState, refresh_codebook

    mp = load_configs([yaml_path]).model.params
    size, k, d = mp.online_kmeans_config.train_feature_buffer_size, mp.n_embed, mp.embed_dim
    g = torch.Generator(device="cuda").manual_seed(SEED)
    buffer = torch.randn((size, 256, d), generator=g, device="cuda")
    times = []
    for _ in range(2):
        state = KMeansState(torch.zeros(k, dtype=torch.int32, device="cuda"), buffer, size)
        codebook = torch.zeros((k, d), device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refresh_codebook(codebook, state, 10, torch.Generator().manual_seed(SEED))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    m = size * 256
    flop = 20 * 2.0 * m * k * d
    return {"features": m, "width": d, "k": k, "iterations": 20, "buffer_bytes": buffer.numel() * 4, "ms": times,
            "tflop": flop / 1e12, "f32_bound_ms": flop / F32_FLOP_PER_S * 1e3,
            "finite": bool(torch.isfinite(codebook).all())}


def train_codebook_cli(torch, np, root: Path, counters, failures, card) -> tuple:
    """`python -m sgam_neurips22_tpu_torch.train --base CODEBOOK_YAML` on
    the card at full width (batch 3, 256^2, n_embed 2048, online k-means)
    from the packed shard (the native loader), CODEBOOK_MAX_STEPS + 1
    steps with CODEBOOK_OVERRIDES: a refresh must fire and checkpoints be
    written. Then fit_timing, the checkpoint's costs, and the refresh at
    the YAML's own buffer."""
    from sgam_neurips22_tpu_torch.training.data.packed import PackedCodebookDataset

    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    tr = run_train_cli(["--base", CODEBOOK_YAML, "-l", str(root / "logs"), "-n", "codebook",
                        "--max_steps", str(CODEBOOK_MAX_STEPS), f"data.params.dataset_dir={root / 'data'}",
                        *CODEBOOK_OVERRIDES])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    rep = {"argv_overrides": [f"data.params.dataset_dir={root / 'data'}", *CODEBOOK_OVERRIDES,
                              f"--max_steps {CODEBOOK_MAX_STEPS}"],
           "steps": tr.state.step, "seconds": seconds, "launches": launches, "refreshes": tr.refreshes,
           "packed_loader": isinstance(tr.data.train_ds, PackedCodebookDataset),
           "checkpoint_steps": tr.ckpt.all_steps(), "best_checkpoint_steps": tr.best_ckpt.all_steps(),
           "lr": tr.train_cfg.learning_rate, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card}
    rep["checkpoint"] = checkpoint_costs(torch, tr, root / "ckpt_timing")
    rep.update(fit_timing(torch, tr, counters))
    tr.close()
    rep["refresh_yaml_size"] = refresh_at_yaml_size(torch, CODEBOOK_YAML)
    rep["ok"] = (rep["steps"] == CODEBOOK_MAX_STEPS + 1 and any(r["codewords"] > 0 for r in tr.refreshes)
                 and rep["packed_loader"] and rep["checkpoint_steps"] and rep["refresh_yaml_size"]["finite"]
                 and all(v > 0 for k, v in launches.items() if k != "zbuffer_min"))
    if not rep["ok"]:
        failures.append(f"train_codebook_cli: {rep}")
    return rep, tr.logdir


def train_conditional_cli(torch, np, root: Path, codebook_run: str, counters, failures, card) -> tuple:
    """`python -m sgam_neurips22_tpu_torch.train --base CONDITIONAL_YAML` on
    the card at full width (batch 16, n_src 2, 256^2, n_embed 16384, flash
    attention) on the pose-graph scenes, warm-started from the codebook
    run's directory, CONDITIONAL_MAX_STEPS + 1 steps, then validation and
    test. SIGUSR1 is sent once step 1's images are written: an emergency
    checkpoint must follow and training go on. Then `-r` the run for one
    more step, fit_timing, and the checkpoint's costs."""
    import signal
    import threading

    from sgam_neurips22_tpu_torch.core.checkpoint import checkpoint_file
    from sgam_neurips22_tpu_torch.training.trainer import Trainer

    emergencies, stop = [], threading.Event()
    original = Trainer._emergency_save

    def recorded(self):
        before = self.ckpt.latest_step()
        original(self)
        emergencies.append({"step": self.state.step, "latest_before": before, "latest_after": self.ckpt.latest_step()})

    def send_usr1(run_root: Path):
        while not stop.is_set():
            hits = list(run_root.glob("*/images/train/*_gs-000001.png"))
            if hits:
                os.kill(os.getpid(), signal.SIGUSR1)
                return
            time.sleep(0.02)

    logs = root / "logs_conditional"
    data = f"data.params.dataset_dir={root / 'data'}"
    warm = f"model.params.ckpt_path={codebook_run}"
    watcher = threading.Thread(target=send_usr1, args=(logs,), daemon=True)
    Trainer._emergency_save = recorded
    watcher.start()
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    try:
        tr = run_train_cli(["--base", CONDITIONAL_YAML, "-l", str(logs), "-n", "conditional",
                            "--max_steps", str(CONDITIONAL_MAX_STEPS), data, warm])
    finally:
        stop.set()
        Trainer._emergency_save = original
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    cb = torch.load(checkpoint_file(codebook_run), map_location="cpu", weights_only=False)["state_dict"]
    own = tr.state.model.state_dict()
    warm_ok = all(torch.equal(own[k].cpu(), v) for k, v in cb.items() if k.startswith("decoder."))
    usr1 = [e for e in emergencies if e["latest_after"] == e["step"] != e["latest_before"]]
    steps_first = tr.state.step
    t1 = time.perf_counter()
    again = run_train_cli(["-r", tr.logdir, "--max_steps", str(CONDITIONAL_MAX_STEPS), data])
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t1
    val = [json.loads(x) for x in open(os.path.join(tr.logdir, "metrics.jsonl")) if "val/rec_loss" in x]
    rep = {"argv_overrides": [data, warm, f"--max_steps {CONDITIONAL_MAX_STEPS}"], "steps": steps_first,
           "seconds": seconds, "launches": launches, "warm_start_decoder_equal": warm_ok,
           "emergency_checkpoints": emergencies, "sigusr1_checkpoint": bool(usr1),
           "resumed_from": steps_first, "steps_after_resume": again.state.step, "resume_seconds": resume_s,
           "validation_records": len(val), "val_rec_loss": [v["val/rec_loss"] for v in val],
           "checkpoint_steps": again.ckpt.all_steps(), "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card}
    rep["checkpoint"] = checkpoint_costs(torch, again, root / "ckpt_timing_conditional")
    rep.update(fit_timing(torch, again, counters))
    again.close()
    tr.close()
    rep["ok"] = (steps_first == CONDITIONAL_MAX_STEPS + 1 and warm_ok and rep["sigusr1_checkpoint"]
                 and again.state.step > steps_first and len(val) >= 2 and all(np.isfinite(rep["val_rec_loss"]))
                 and all(v > 0 for v in launches.values()))
    if not rep["ok"]:
        failures.append(f"train_conditional_cli: {rep}")
    return rep, tr.logdir


def generate_config_phase(torch, np, run_dir: str, counters, failures) -> dict:
    """`python -m sgam_neurips22_tpu_torch.generate --config
    <run>/config.yaml --ckpt <run>` (the conditional run) for 3 frames on a
    4 x 1 grid from a seed template: every file of the reference's layout,
    finite frames, one z-buffer and one codeword launch a frame."""
    from sgam_neurips22_tpu_torch import generate
    from sgam_neurips22_tpu_torch.pipeline.ordering import ORDERS
    from sgam_neurips22_tpu_torch.pipeline.png import read_png

    root = Path(run_dir) / "generate_config"
    write_template(np, np.random.default_rng(SEED + 6), root / "templates")
    out = root / "out"
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    generate.main(["--config", os.path.join(run_dir, "config.yaml"), "--ckpt", run_dir, "--template_dir",
                   str(root / "templates"), "--rows", "4", "--cols", "1", "--output_dir", str(out),
                   "--resolution", str(H), "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    want = {f"{p}_{step:05d}_{i:02d}_{j:02d}.{e}" for step, (i, j) in enumerate(ORDERS["zigzag"](4, 1))
            for p, e in (("im", "png"), ("dm", "npy"), ("R", "npy"), ("t", "npy"))} | {"merged_pcds.ply"}
    got = {p.name for p in out.iterdir()}
    finite = all(np.isfinite(np.load(out / n)).all() for n in got if n.startswith("dm_"))
    frames = [read_png(str(out / n)) for n in sorted(got) if n.startswith("im_")]
    rep = {"frames": 3, "seconds": seconds, "launches": launches, "files_as_reference": got == want,
           "missing": sorted(want - got), "finite_depth": finite, "frames_differ": len(frames) == 4 and
           not np.array_equal(frames[1], frames[2])}
    rep["ok"] = (rep["files_as_reference"] and finite and launches["zbuffer_min"] == 3
                 and launches["nearest_codeword"] == 3)
    if not rep["ok"]:
        failures.append(f"generate_config: {rep}")
    return rep


PARITY_TRAINER_RES = 64  # parity_trainer's images: the full-width model on a small input
UPDATE_FLOOR = 1e-2  # the update gate's elements: CPU first moment at least this share of its tensor's largest


def update_gap(torch, w0: dict, w1: dict, ref_w0: dict, ref_w1: dict, ref_m: dict, skip) -> dict:
    """The applied Adam update (weights after minus before) of a run
    against the reference run's, per tensor but those in `skip`, over the
    elements whose reference first moment is at least UPDATE_FLOOR of the
    tensor's largest (clear of f32 noise: the moments agree to 1e-4 of the
    largest): the share whose update's sign differs, and the L2 distance
    over the reference update's norm. Adam's first update moves a weight
    by about LR times the sign of its mean gradient, so a wrong gradient
    shows as flipped signs."""
    flips, gaps = {}, {}
    for n, m in ref_m.items():
        if n in skip:
            continue
        sel = m.abs() >= UPDATE_FLOOR * m.abs().max()
        d, ref = (w1[n] - w0[n])[sel], (ref_w1[n] - ref_w0[n])[sel]
        flips[n] = float((torch.sign(d) != torch.sign(ref)).double().mean())
        gaps[n] = float((d - ref).norm() / ref.norm())
    worst = max(gaps, key=gaps.get)
    return {"flip_share_max": max(flips.values()), "gap_worst": [worst, gaps[worst]],
            "ok": max(flips.values()) <= 1e-3 and gaps[worst] <= 2e-2}


def parity_trainer(torch, np, root: Path, failures) -> dict:
    """Two Trainer steps of the conditional YAML's model at full width on
    PARITY_TRAINER_RES^2 pair data (batch 2, n_src 2), with accumulation 2
    and the scheduler on (warm-up 2 from lr_start 0.5, so that the one
    update, at the second step, has half the LR), from one seeded state on
    the card and on the CPU. Gates, as parity_train's: every log of both
    steps at rtol 1e-4 plus atol 1e-6 (d_weight 1e-3), the discriminator's
    running statistics at rtol 1e-4, atol 1e-6; the Adam first moments
    (the accumulated mean gradient times 1 - beta1) card against CPU
    within 3e-2 of each tensor's largest, tensors at f32 noise (below 1e-5
    of the largest moment) below that floor on both; the applied update
    card against CPU (`update_gap`): no more than 1e-3 of the elements
    with flipped signs, L2 distance within 2e-2 of the CPU update's. A
    third run on the card plants a fault, an accumulator that drops the
    first mini-step's gradients, and must fail the update gate."""
    from sgam_neurips22_tpu_torch.core.config import load_configs
    from sgam_neurips22_tpu_torch.pipeline.png import write_png
    from sgam_neurips22_tpu_torch.training import train_step as ts_mod
    from sgam_neurips22_tpu_torch.training import trainer as trainer_mod

    data = root / "parity_data"
    rng = np.random.default_rng(SEED + 13)
    r = PARITY_TRAINER_RES
    for split in ("train", "val"):
        scene = data / split / "scene_0000"
        scene.mkdir(parents=True)
        frames = []
        for i in range(6):
            c2w = np.eye(4)
            c2w[:3, 3] = [0.5 * i, 0, 0]
            frames.append({"transform_matrix": c2w.tolist(), "file_path": f"./im_{i:05d}.png"})
            write_png(str(scene / f"im_{i:05d}.png"), rng.integers(0, 256, (r, r, 3), dtype=np.uint8))
            np.save(scene / f"dm_{i:05d}.npy", rng.uniform(8, 14, (r, r)).astype(np.float32))
        with open(scene / "transforms.json", "w") as f:
            json.dump({"frames": frames}, f)
    np.save(data / "K.npy", np.array([[88.9, 0, 32.0], [0, 88.9, 32.0], [0, 0, 1.0]]))
    cfg = load_configs([CONDITIONAL_YAML], [
        f"data.params.dataset_dir={data}", "data.params.batch_size=2", f"data.params.image_resolution=[{r},{r}]",
        "model.params.ckpt_path=null", "model.params.lossconfig.params.disc_start=0",
        "model.params.lr_scheduler_config.warm_up_steps=2", "model.params.lr_scheduler_config.lr_start=0.5"])
    step_fn, add = trainer_mod.train_step, ts_mod.GradAccumulator.add

    def dropping_first(acc, grads):  # the planted fault
        return add(acc, [torch.zeros_like(g) for g in grads] if acc.mini_step == 0 else grads)

    runs = {}
    for run, dev in (("gpu", "cuda"), ("cpu", "cpu"), ("gpu_fault", "cuda")):
        seen = []

        def recording(*args):
            state, logs = step_fn(*args)
            seen.append({k: float(v) for k, v in logs.items()})
            return state, logs

        trainer_mod.train_step = recording
        if run == "gpu_fault":
            ts_mod.GradAccumulator.add = dropping_first
        try:
            t0 = time.perf_counter()
            tr = trainer_mod.Trainer(cfg, str(root / f"parity_{run}"), seed=SEED, use_wandb=False, max_steps=1,
                                     install_signals=False, accumulate_grad_batches=2, device=dev)
            params = ts_mod.split_params(tr.state.model, tr.train_cfg.phase)[0]
            w0 = {n: p.detach().cpu().double() for n, p in params}
            tr.fit(epochs=1)
            tr.close()
        finally:
            trainer_mod.train_step = step_fn
            ts_mod.GradAccumulator.add = add
        runs[run] = {"logs": seen, "seconds": time.perf_counter() - t0, "w0": w0,
                     "m": {n: tr.state.opt_ae.state[p]["exp_avg"].detach().cpu().double() for n, p in params},
                     "w": {n: p.detach().cpu().double() for n, p in params},
                     "stats": {n: b.detach().cpu() for n, b in tr.state.disc.named_buffers()},
                     "lr": tr.state.opt_ae.param_groups[0]["lr"], "step": tr.state.step}
    g, c, fault = runs["gpu"], runs["cpu"], runs["gpu_fault"]
    log_err, logs_ok = [], len(g["logs"]) == len(c["logs"]) == 2
    for gl, cl in zip(g["logs"], c["logs"]):
        rtol = {k: 1e-3 if k.endswith("d_weight") else 1e-4 for k in cl}
        log_err.append({k: abs(gl[k] - cl[k]) / max(abs(cl[k]), 1e-30) for k in cl})
        logs_ok = logs_ok and all(abs(gl[k] - cl[k]) <= rtol[k] * abs(cl[k]) + 1e-6 for k in cl)
    floor = 1e-5 * max(float(m.abs().max()) for m in c["m"].values())
    noise = sorted(n for n, m in c["m"].items() if float(m.abs().max()) < floor)
    noise_ok = all(float(x["m"][n].abs().max()) < floor for x in (g, c) for n in noise)
    m_err = {n: float((g["m"][n] - c["m"][n]).abs().max() / c["m"][n].abs().max()) for n in c["m"] if n not in noise}
    stats_ok = all(torch.allclose(g["stats"][n], x, rtol=1e-4, atol=1e-6) for n, x in c["stats"].items())
    same_init = all(torch.equal(g["w0"][n], w) for n, w in c["w0"].items())
    update = update_gap(torch, g["w0"], g["w"], c["w0"], c["w"], c["m"], noise)
    planted = update_gap(torch, fault["w0"], fault["w"], c["w0"], c["w"], c["m"], noise)
    worst = max(m_err.items(), key=lambda kv: kv[1])
    res = {"resolution": r, "batch": 2, "accumulate_grad_batches": 2, "update_lr": c["lr"],
           "steps": [g["step"], c["step"]], "gpu_seconds": g["seconds"], "cpu_seconds": c["seconds"],
           "log_rel_err": log_err, "logs_ok": logs_ok, "moment_worst_gpu_vs_cpu": worst, "moment_noise": noise,
           "moments_ok": noise_ok and worst[1] <= 3e-2, "same_init": same_init, "update": update,
           "planted_fault_update": planted, "running_stats_ok": stats_ok}
    res["ok"] = (res["steps"] == [2, 2] and c["lr"] == g["lr"] > 0 and logs_ok and res["moments_ok"] and same_init
                 and update["ok"] and not planted["ok"] and stats_ok)
    if not res["ok"]:
        failures.append(f"parity_trainer: {res}")
    return res


def trainer_phases(torch, np, counters, failures, card, paths: dict, report: dict) -> None:
    """The trainer's four phases, each emitted as it ends."""
    import tempfile

    from sgam_neurips22_tpu_torch.studies.trainer_host import write_train_dataset

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        (root / "data").mkdir()
        by_filter = write_train_dataset(root / "data", H, W, SEED + 11, DATA_SCENES, DATA_FRAMES, PAETH_EVERY)
        rates = loader_rates(np, root / "data", by_filter)
        rates.update(seconds=time.perf_counter() - t0, card=card)
        report["loader"] = rates
        emit({"phase": "loader", **rates})

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cb, cb_run = train_codebook_cli(torch, np, root, counters, failures, card)
        cb["phase_seconds"] = time.perf_counter() - t0
        paths["train_codebook_cli"] = cb["launches"]
        report["train_codebook_cli"] = cb
        emit({"phase": "train_codebook_cli", **cb})
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

        t0 = time.perf_counter()
        cond, cond_run = train_conditional_cli(torch, np, root, cb_run, counters, failures, card)
        cond["phase_seconds"] = time.perf_counter() - t0
        paths["train_conditional_cli"] = cond["launches"]
        report["train_conditional_cli"] = cond
        emit({"phase": "train_conditional_cli", **cond})
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

        t0 = time.perf_counter()
        gen = generate_config_phase(torch, np, cond_run, counters, failures)
        gen["phase_seconds"] = time.perf_counter() - t0
        paths["generate_config"] = gen["launches"]
        report["generate_config"] = gen
        emit({"phase": "generate_config", **gen})
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

        t0 = time.perf_counter()
        par = parity_trainer(torch, np, root, failures)
        par["phase_seconds"] = time.perf_counter() - t0
        report["parity_trainer"] = par
        emit({"phase": "parity_trainer", **par})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
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

    # the flagship model with seeded random weights, on the CPU and the card;
    # the same weights in the bf16 model
    cpu_model = VQModel(flagship_config())
    load_into(cpu_model, random_state_dict(cpu_model, SEED))
    cpu_model.eval()
    cpu_model16 = VQModel(flagship_config(compute_dtype="bfloat16"))
    cpu_model16.load_state_dict(cpu_model.state_dict())
    cpu_model16.eval()
    rng = np.random.default_rng(SEED)
    seeds = seed_frames(np, rng)
    cfg = SceneGenConfig(dataset="clevr-infinite", output_dim=(FRAMES + 1, 1), topk=1, image_resolution=(H, W))
    gen = InfiniteSceneGeneration(copy.deepcopy(cpu_model), cfg, seeds, device="cuda")

    # 2. kernels against their plain versions
    t0 = time.perf_counter()
    kernels = [check_zbuffer(torch, np, gen, failures), check_nearest_codeword(torch, gen.model.codebook, failures),
               check_flash_attention(torch, failures), *check_flash_backward(torch, failures)]
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0, "kernels": kernels})
    t0 = time.perf_counter()
    report["collision_modes"] = check_collision_modes(torch, np, gen, np.random.default_rng(SEED + 3), failures)
    emit({"phase": "collision_modes", "seconds": time.perf_counter() - t0, "cases": report["collision_modes"]})
    paths = {}  # launches of each path's timed run

    # 3. the flythrough, batch 1: one warm-up unroll, then one timed unroll
    #    whose kernel launches are counted, then one profiled unroll
    t0 = time.perf_counter()
    want1 = {"zbuffer_min": FRAMES, "nearest_codeword": FRAMES, "flash_attention_fwd": 0,
             "flash_attention_dq": 0, "flash_attention_dkv": 0}
    (rgb, _), unroll_rep, report["profile"] = unroll_phase(torch, gen.scene_expansion, FRAMES, counters, want1,
                                                            failures, "unroll", gen.reset)
    rgb32 = rgb.clone()
    unroll_rep.update(card=card, gflop_per_frame=model_gflop(torch, flagship_config()))
    gflop = sum(unroll_rep["gflop_per_frame"].values())
    unroll_rep["model_tflop_per_s"] = gflop * FRAMES / unroll_rep["seconds"] / 1e3
    unroll_rep["model_bound_ms_per_frame"] = gflop * 1e9 / F32_FLOP_PER_S * 1e3
    unroll_rep["phase_seconds"] = time.perf_counter() - t0
    paths["unroll"] = unroll_rep["launches"]
    emit({"phase": "unroll", **unroll_rep})

    # 4. one full-width step on the card against the CPU
    t0 = time.perf_counter()
    parity = parity_step(torch, gen, cpu_model, failures)
    emit({"phase": "parity", "seconds": time.perf_counter() - t0, **parity})

    # 5. the batched flythrough: SCENES scenes, each from its own seed frame
    t0 = time.perf_counter()
    seeds_batch = [seed_frames(np, rng) for _ in range(SCENES)]
    gen_b = InfiniteSceneGeneration(gen.model, cfg, seeds_batch[0], device="cuda")
    want_b = {"zbuffer_min": FRAMES, "nearest_codeword": FRAMES, "flash_attention_fwd": 7 * FRAMES,
              "flash_attention_dq": 0, "flash_attention_dkv": 0}
    (rgb_b, _), batched, report["profile_batched"] = unroll_phase(
        torch, lambda: gen_b.scene_expansion_batched(seeds_batch), SCENES * FRAMES, counters, want_b, failures,
        "unroll_batched", per_step=SCENES)
    scenes_differ = not torch.equal(rgb_b[0, 1], rgb_b[1, 1])
    batched.update(scenes=SCENES, frames_per_scene=FRAMES, scenes_0_1_differ_at_frame_1=scenes_differ, card=card,
                   model_tflop_per_s=gflop * SCENES * FRAMES / batched["seconds"] / 1e3)
    del rgb_b
    if not scenes_differ:
        failures.append("batched unroll: scenes 0 and 1 equal at frame 1")
    batched["phase_seconds"] = time.perf_counter() - t0
    paths["unroll_batched"] = batched["launches"]
    emit({"phase": "unroll_batched", **batched})

    # 6. one full-width step of 2 scenes on the card (flash kernel) against the CPU
    t0 = time.perf_counter()
    parity_b = parity_step(torch, gen_b, cpu_model, failures, seeds_batch[:2])
    emit({"phase": "parity_batched", "seconds": time.perf_counter() - t0, **parity_b})
    del gen_b
    torch.cuda.empty_cache()

    # 7. the flythrough at bf16 (bench.py's default --model_dtype), same
    #    weights and seeds: launches, time and layers beside the f32
    #    unroll's, the frames' PSNR against the f32 frames (not gated)
    t0 = time.perf_counter()
    gen16 = InfiniteSceneGeneration(copy.deepcopy(cpu_model16), cfg, seeds, device="cuda")
    (rgb16, _), bf16_rep, report["profile_bf16"] = unroll_phase(
        torch, gen16.scene_expansion, FRAMES, counters, want1, failures, "unroll_bf16", gen16.reset)
    frame_psnr = psnr(torch, rgb16[1:], rgb32[1:])
    bf16_rep.update(card=card, psnr_vs_f32_db={"mean": float(np.mean(frame_psnr)), "min": min(frame_psnr),
                                               "first": frame_psnr[0], "last": frame_psnr[-1]},
                    f32_ms_per_frame=unroll_rep["ms_per_frame"],
                    f32_ms_per_frame_by_layer=unroll_rep["ms_per_frame_by_layer"],
                    phase_seconds=time.perf_counter() - t0)
    paths["unroll_bf16"] = bf16_rep["launches"]
    emit({"phase": "unroll_bf16", **bf16_rep})
    t0 = time.perf_counter()
    parity16 = parity_step_bf16(torch, gen16, cpu_model16, cpu_model, failures)
    emit({"phase": "parity_bf16", "seconds": time.perf_counter() - t0, **parity16})

    # 8. the 8-scene unroll at bf16 (bench.py's batched_8_scenes)
    t0 = time.perf_counter()
    gen16_b = InfiniteSceneGeneration(gen16.model, cfg, seeds_batch[0], device="cuda")
    (rgb16_b, _), batched16, report["profile_batched_bf16"] = unroll_phase(
        torch, lambda: gen16_b.scene_expansion_batched(seeds_batch), SCENES * FRAMES, counters, want_b, failures,
        "unroll_batched_bf16", per_step=SCENES)
    batched16.update(scenes=SCENES, frames_per_scene=FRAMES, card=card, f32_ms_per_frame=batched["ms_per_frame"],
                     f32_ms_per_frame_by_layer=batched["ms_per_frame_by_layer"])
    del rgb16_b
    batched16["phase_seconds"] = time.perf_counter() - t0
    paths["unroll_batched_bf16"] = batched16["launches"]
    emit({"phase": "unroll_batched_bf16", **batched16})
    t0 = time.perf_counter()
    parity16_b = parity_step_bf16(torch, gen16_b, cpu_model16, cpu_model, failures, seeds_batch[:2])
    emit({"phase": "parity_batched_bf16", "seconds": time.perf_counter() - t0, **parity16_b})
    del gen16_b

    # 9. the strided splat at bf16 (bench.py's flythrough_splat_stride2)
    t0 = time.perf_counter()
    cfg2 = SceneGenConfig(dataset="clevr-infinite", output_dim=(FRAMES + 1, 1), topk=1, image_resolution=(H, W),
                          splat_stride=2)
    gen2 = InfiniteSceneGeneration(gen16.model, cfg2, seeds, device="cuda")
    _, stride2, report["profile_stride2"] = unroll_phase(torch, gen2.scene_expansion, FRAMES, counters, want1,
                                                         failures, "stride2", gen2.reset)
    stride2.update(card=card, splat_stride=2, bf16_ms_per_frame=bf16_rep["ms_per_frame"],
                   phase_seconds=time.perf_counter() - t0)
    paths["stride2"] = stride2["launches"]
    emit({"phase": "stride2", **stride2})
    del gen2

    # 10. top-k sampling at bf16: TOPK_FRAMES frames at topk 4, twice from
    #     one generator seed (the draws need no kernel: plain distances and
    #     torch.topk, as JAX's codeword_distances and lax.top_k)
    t0 = time.perf_counter()
    cfg_k = SceneGenConfig(dataset="clevr-infinite", output_dim=(TOPK_FRAMES + 1, 1), topk=4,
                           image_resolution=(H, W))
    gen_k = InfiniteSceneGeneration(gen16.model, cfg_k, seeds, device="cuda")
    want_k = {**want1, "zbuffer_min": TOPK_FRAMES, "nearest_codeword": 0}
    runs_k = []
    for _ in range(2):
        gen_k.reset()
        for fn in counters:
            fn.launches = 0
        out = gen_k.scene_expansion(torch.Generator(device="cuda").manual_seed(SEED))
        torch.cuda.synchronize()
        runs_k.append(([x.clone() for x in out], {fn.__name__: fn.launches for fn in counters}))
    (k_rgb, k_depth), launches_k = runs_k[0]
    topk = {"topk": 4, "frames": TOPK_FRAMES, "launches": launches_k,
            "same_seed_same_frames": all(torch.equal(a, b) for a, b in zip(runs_k[0][0], runs_k[1][0])),
            "finite": bool(torch.isfinite(k_rgb).all() and torch.isfinite(k_depth).all()),
            "differs_from_topk_1": not torch.equal(k_rgb[1], rgb16[1])}
    topk["ok"] = (all(topk[k] for k in ("same_seed_same_frames", "finite", "differs_from_topk_1"))
                  and launches_k == want_k == runs_k[1][1])
    if not topk["ok"]:
        failures.append(f"topk: {topk} (launches wanted {want_k})")
    topk["seconds"] = time.perf_counter() - t0
    paths["topk"] = launches_k
    emit({"phase": "topk", **topk})
    del gen_k, gen16, gen, runs_k
    torch.cuda.empty_cache()

    # 11. google_earth at bf16: its flagship model (codebook 4096, seeded
    #     random weights), 3 sources, the (FRAMES+1) x 1 trajectory of
    #     bench.py --config google_earth, seed depths in (0.5, 4.0)
    t0 = time.perf_counter()
    ge_model = VQModel(flagship_config("google_earth", "bfloat16"))
    load_into(ge_model, random_state_dict(ge_model, SEED))
    cfg_ge = SceneGenConfig(dataset="google_earth", output_dim=(FRAMES + 1, 1), topk=1, image_resolution=(H, W))
    gen_ge = InfiniteSceneGeneration(ge_model, cfg_ge, seed_frames(np, rng, (0.5, 4.0)), device="cuda")
    _, ge_rep, report["profile_google_earth"] = unroll_phase(torch, gen_ge.scene_expansion, FRAMES, counters, want1,
                                                             failures, "google_earth", gen_ge.reset)
    ge_rep.update(card=card, codebook=list(gen_ge.model.codebook.shape), sources=cfg_ge.effective_num_src,
                  phase_seconds=time.perf_counter() - t0)
    paths["google_earth"] = ge_rep["launches"]
    emit({"phase": "google_earth", **ge_rep})
    del gen_ge
    torch.cuda.empty_cache()

    # 12. map re-query at bf16 (bench.py --config integration): CLEVR on a
    #     3x3 grid, seed depth U(8, 14); each phase also times the map alone,
    #     runs it once under sync debug mode "error" and keeps the pool
    #     splat's z-buffer input at its last frame
    map_keys = {}
    gen_map = InfiniteSceneGeneration(copy.deepcopy(cpu_model16), map_config("clevr-infinite", MAP_GRID), seeds,
                                      device="cuda")
    map_frames = gen_map.grid.size - 1
    tsdf_rep, report["profile_unroll_tsdf"], map_keys["map_clevr_last_frame"] = map_phase(
        torch, np, gen_map, map_frames, counters, failures, "unroll_tsdf", card)
    paths["unroll_tsdf"] = tsdf_rep["launches"]
    emit({"phase": "unroll_tsdf", **tsdf_rep})
    emit({"phase": "map_ms", "unroll_tsdf": tsdf_rep["map_ms"], "card": card})

    # 13. google_earth's map re-query at bf16 (bench.py --config google_earth
    #     --rgbd_integration): 25 x 1, 24 frames (cut from 100), 3 sources,
    #     codebook 4096, seed depth U(0.5, 4.0); its 2^20-slot pool recycles
    ge_seeds = seed_frames(np, rng, (0.5, 4.0))
    gen_ge_map = InfiniteSceneGeneration(ge_model, map_config("google_earth", (FRAMES + 1, 1)), ge_seeds,
                                         device="cuda")
    ge_tsdf_rep, report["profile_unroll_tsdf_ge"], map_keys["map_google_earth_last_frame"] = map_phase(
        torch, np, gen_ge_map, FRAMES, counters, failures, "unroll_tsdf_ge", card)
    paths["unroll_tsdf_ge"] = ge_tsdf_rep["launches"]
    emit({"phase": "unroll_tsdf_ge", **ge_tsdf_rep})

    # 14. the same with coherent_plane_depth: every frame's depth, the seed's
    #     too, is one world plane's (bench.py --coherent)
    gen_coh = InfiniteSceneGeneration(ge_model, map_config("google_earth", (FRAMES + 1, 1), coherent=True), ge_seeds,
                                      device="cuda")
    gen_coh.reset([((0, 0), ge_seeds[0][1], gen_coh.plane_depth_at(0))])
    coh_rep, report["profile_unroll_tsdf_ge_coherent"], _ = map_phase(
        torch, np, gen_coh, FRAMES, counters, failures, "unroll_tsdf_ge_coherent", card)
    paths["unroll_tsdf_ge_coherent"] = coh_rep["launches"]
    emit({"phase": "unroll_tsdf_ge_coherent", **coh_rep})
    emit({"phase": "map_ms", "unroll_tsdf_ge": ge_tsdf_rep["map_ms"], "unroll_tsdf_ge_coherent": coh_rep["map_ms"],
          "card": card})
    del gen_coh
    torch.cuda.empty_cache()

    # 14b. CLEVR's map re-query fusing every second ray (bench.py's
    #      integration_clevr_stride2: --config integration --tsdf_stride 2)
    gen_s2 = InfiniteSceneGeneration(gen_map.model, map_config("clevr-infinite", MAP_STRIDE2_GRID, stride=2),
                                     seeds, device="cuda")
    s2_rep, report["profile_integration_clevr_stride2"], _ = map_phase(
        torch, np, gen_s2, gen_s2.grid.size - 1, counters, failures, "integration_clevr_stride2", card)
    s2_rep["integrate_stride"] = 2
    paths["integration_clevr_stride2"] = s2_rep["launches"]
    emit({"phase": "integration_clevr_stride2", **s2_rep})
    del gen_s2

    # 14c. map re-query for SCENES scenes at once at bf16 (bench.py's
    #      batched_8_scenes_tsdf: --batch_scenes 8 --frames 48
    #      --rgbd_integration): CLEVR 7x7, 5 sources, each scene its own
    #      seed frame (depth U(8, 14)), their maps in one batched volume
    t0 = time.perf_counter()
    gen_mb = InfiniteSceneGeneration(gen_map.model, map_config("clevr-infinite", MAP_BATCH_GRID), seeds,
                                     device="cuda")
    mb_frames = gen_mb.grid.size - 1
    want_mb = {"zbuffer_min": mb_frames, "nearest_codeword": mb_frames, "flash_attention_fwd": 7 * mb_frames,
               "flash_attention_dq": 0, "flash_attention_dkv": 0}
    (rgb_mb, _), mb_rep, report["profile_unroll_tsdf_batched"] = unroll_phase(
        torch, lambda: gen_mb.scene_expansion_batched(seeds_batch), SCENES * mb_frames, counters, want_mb, failures,
        "unroll_tsdf_batched", per_step=SCENES)
    scenes_differ = not torch.equal(rgb_mb[0, 1], rgb_mb[1, 1])
    mb_rep.update(card=card, scenes=SCENES, frames_per_scene=mb_frames, grid=list(MAP_BATCH_GRID),
                  sources=gen_mb.cfg.effective_num_src, scenes_0_1_differ_at_frame_1=scenes_differ,
                  **batched_pool_telemetry(np, gen_mb))
    del rgb_mb
    if not scenes_differ:
        failures.append("unroll_tsdf_batched: scenes 0 and 1 equal at frame 1")
    if not mb_rep["pool_recycled_matches_scenes"]:
        failures.append(f"unroll_tsdf_batched: pool telemetry disagrees: {mb_rep}")
    pix, key = capture_pool_splat(torch, gen_mb, lambda: gen_mb.scene_expansion_batched(seeds_batch))
    map_keys["map_clevr_8_scenes_last_frame"] = (pix, key)
    mb_rep["pool_splat_shape"] = list(pix.shape)
    mb_rep["phase_seconds"] = time.perf_counter() - t0
    paths["unroll_tsdf_batched"] = mb_rep["launches"]
    emit({"phase": "unroll_tsdf_batched", **mb_rep})
    del gen_mb, pix, key
    torch.cuda.empty_cache()

    # 15. the map on the card against the CPU, f32, and the z-buffer at the
    #     map's own shapes
    t0 = time.perf_counter()
    parity_map = map_parity(torch, np, gen_map, gen_ge_map, cpu_model, seeds, failures)
    emit({"phase": "map_parity", "seconds": time.perf_counter() - t0, **parity_map})
    t0 = time.perf_counter()
    parity_map_b = map_parity_batched(torch, np, cpu_model, cpu_model16, seeds_batch, failures)
    parity_map_b["seconds"] = time.perf_counter() - t0
    emit({"phase": "parity_map_batched", **parity_map_b})
    t0 = time.perf_counter()
    zb_map = check_zbuffer_map(torch, map_keys, failures)
    kernels[0]["shapes"].extend(zb_map)
    emit({"phase": "zbuffer_map_shapes", "seconds": time.perf_counter() - t0, "shapes": zb_map})
    gen_map_model = gen_map.model
    del gen_map, gen_ge_map, ge_model, map_keys
    torch.cuda.empty_cache()

    # 15b. the port's generate CLI on the card: map re-query with the
    #      exports and the mesh, then the spiral, cylinder and pose-file
    #      trajectories; and the exports of a coherent-plane map
    t0 = time.perf_counter()
    gen_rep = generate_phase(torch, np, cpu_model, counters, failures, gen_map_model, seeds)
    gen_rep["seconds"] = time.perf_counter() - t0
    paths.update({f"generate_{name}": r["launches"] for name, r in gen_rep["runs"].items()})
    emit({"phase": "generate", **gen_rep, "card": card})
    del gen_map_model

    # 16. the conditional-generation training step, batch 16
    t0 = time.perf_counter()
    train, report["profile_train"] = run_train(torch, np, counters, failures)
    train["phase_seconds"] = time.perf_counter() - t0
    paths["train"] = train["launches"]
    emit({"phase": "train", **train, "card": card})

    # 17. one training step at batch 2 on the card against the CPU
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    parity_t = parity_train(torch, np, failures)
    emit({"phase": "parity_train", "seconds": time.perf_counter() - t0, **parity_t})

    # 18. the same training step with a bf16 model (train_conditional_bf16),
    #     then its batch-2 step on the card against the CPU
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train16, report["profile_train_bf16"] = run_train(torch, np, counters, failures, "bfloat16")
    train16.update(phase_seconds=time.perf_counter() - t0, f32_ms_per_step=train["ms_per_step"],
                   f32_ms_per_step_by_layer=train["ms_per_step_by_layer"])
    paths["train_bf16"] = train16["launches"]
    emit({"phase": "train_bf16", **train16, "card": card})
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    parity_t16 = parity_train_bf16(torch, np, failures)
    emit({"phase": "parity_train_bf16", "seconds": time.perf_counter() - t0, **parity_t16})
    torch.cuda.empty_cache()

    # 19. the trainer through its entry points: the loader's rates, the
    #     codebook and conditional YAMLs at full width through the train
    #     CLI, generate --config on the trained run, and two Trainer steps
    #     on the card against the CPU
    trainer_phases(torch, np, counters, failures, card, paths, report)

    main_path = {"zbuffer_min": "unroll", "nearest_codeword": "unroll", "flash_attention_fwd": "unroll_batched",
                 "flash_attention_dq": "train", "flash_attention_dkv": "train"}
    for k in kernels:
        k["launches"] = paths[main_path[k["name"]]][k["name"]]
        k["launches_by_path"] = {path: counts[k["name"]] for path, counts in paths.items()}
        k["kernel_ms"] = k["ms"]
    report.update(kernels=kernels, unroll=unroll_rep, parity=parity, unroll_batched=batched,
                  parity_batched=parity_b, unroll_bf16=bf16_rep, parity_bf16=parity16,
                  unroll_batched_bf16=batched16, parity_batched_bf16=parity16_b, stride2=stride2, topk=topk,
                  google_earth=ge_rep, unroll_tsdf=tsdf_rep, unroll_tsdf_ge=ge_tsdf_rep,
                  unroll_tsdf_ge_coherent=coh_rep, integration_clevr_stride2=s2_rep, unroll_tsdf_batched=mb_rep,
                  map_parity=parity_map, parity_map_batched=parity_map_b, generate=gen_rep, train=train,
                  parity_train=parity_t,
                  train_bf16=train16, parity_train_bf16=parity_t16, profiler_misses=PROFILER_MISSES, failures=failures,
                  seconds=time.perf_counter() - t_start)
    emit({"phase": "profiler", "misses": len(PROFILER_MISSES), "calls": sorted(set(PROFILER_MISSES))})
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
