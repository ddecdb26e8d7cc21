#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (`sgam_neurips22_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--out DIR]

From the repository root. It builds the port's CUDA kernels from csrc/
(six sources: the five TPU kernels' ports and the map's deterministic grid
accumulation, grid_accumulate), holds each against its plain PyTorch version
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
  (batch 8, flash attention; BATCHED_F32_FRAMES frames a scene, cut for
  the run's time): one z-buffer and one codeword launch and 7
  flash-attention launches per step; then parity_batched, one step of 2
  scenes on the card against the CPU;
- generate_precision: generate's --matmul_precision on the card
  (`core.device.set_matmul_precision`, as `generate.main` sets it): the
  f32 flythrough, PRECISION_FRAMES frames at batch 1 and at 8 scenes, in
  `float32` (TF32 off) and `default` (TF32): ms/frame, device conv ms a
  frame and the conv kernels' names (TF32 ones in `default`, none in
  `float32`), the z-buffer and codeword kernels once a step in both, and
  the first frame's pre-quant latents, RGB, depth and codeword indices of
  `default` against `float32` (latents within PRECISION_LATENT_TOL);
- unroll_bf16, unroll_batched_bf16: the same two unrolls with the model
  in bf16 (bench.py's default --model_dtype; FRAMES frames a scene), the same launches, the
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
  depth U(8, 14)); google_earth --rgbd_integration on a 13 x 1
  trajectory (GE_MAP_FRAMES = 12 frames, cut from 100; 3 sources, codebook
  4096, a pool of 2^20 slots); and the same with coherent_plane_depth
  (--coherent). Each checks finite frames and one z-buffer and one
  codeword launch a frame, reports the pool telemetry bench.py prints and
  the fused share of depth samples, times the map's functions alone
  (map_ms) and runs integrate and render_depth once under
  torch.cuda.set_sync_debug_mode("error");
- integration_clevr_stride2: bench.py's integration_clevr_stride2, the
  CLEVR map phase with every second ray fused (--tsdf_stride 2), on a 2x2
  grid (3 frames, cut from 8 for time);
- unroll_tsdf_batched: bench.py's batched_8_scenes_tsdf, map re-query for
  8 scenes at once in bf16 (CLEVR 5x5, 24 frames a scene, cut from 7x7
  and 48 for time, 5 sources, one
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
  grid_accumulate, the map's grid accumulation on the inputs integrate
  built at the last step of unroll_tsdf, unroll_tsdf_ge,
  integration_clevr_stride2 and unroll_tsdf_batched, bit-exact (as words:
  -0.0 is not +0.0) against its plain version on the CPU, with each case's
  key bits, zero addends and runs, its kernels' device time one by one,
  and the first route (torch.sort, a gather, the walk) timed in turns
  beside it (each map phase counts its launches, one a frame); then
  parity_map_batched, one batched map-requery step of 2 scenes card
  against CPU in f32 and bf16 (parity's and parity_bf16's gates) and the
  volume after it; then the z-buffer on the keys the pool splat built at
  the last frame of unroll_tsdf ([3, 204960]), unroll_tsdf_ge ([4, 262144])
  and unroll_tsdf_batched ([24, 215712] at 5x5), bit-exact on both routes, each
  route timed beside scatter_reduce;
- generate: the port's CLI (`python -m sgam_neurips22_tpu_torch.generate`,
  its main) on the card from a seed template and a reference-layout .ckpt
  that the phase writes: map re-query on a 2x2 grid with --output_dir
  (the frames, merged_pcds.ply and the map's rgbd_integrated_mesh.ply and
  rgbd_integrated_trimesh.ply), then the spiral, cylinder and pose-file
  trajectories, and a run from a template of another size (LANCZOS-resized
  on load), each with --matmul_precision float32; every file of the
  reference's layout, PLY sizes that match
  their headers, one z-buffer and one codeword launch a frame, and the
  unroll, export and mesh host times apart; then the exports of a
  coherent-plane map (random-weight depth puts triangles in nearly every
  observed voxel, which makes the map run's exports host-bound);
- inference_step: `serving.build_inference_step` at the flagship width
  (f32), given a config that asks for flash attention: one z-buffer and
  one codeword launch and no flash (the step strips the field), finite
  outputs, its time a call, and the same step on the CPU under parity's
  gates;
- export_step: `export_aot.export_step` of the flagship clevr-infinite
  step (f32, traced on the card) for the platforms cuda and cpu into a
  temporary directory, loaded in this process (`load_step`): after a
  warm-up call one call launches the z-buffer and codeword kernels once
  each and no flash attention, and equals the eager step bit for bit;
  loaded again in a fresh process that cannot import jax, the JAX package
  or the port's models, pipeline, serving and training: on the card the
  same launches, and its outputs within the inference step's gates of the
  eager step (whether bit-equal is reported); on the CPU (a second fresh
  process, `load_step(device="cpu")`) no kernel launch, and its outputs
  within the same gates of the port's eager step on the CPU; export, save
  and load seconds, the artifact's MB, ms a call
  of the loaded program and of the eager step in turns (CUDA events), and
  the host microseconds a z-buffer and a codeword call spends in the
  custom op's dispatch (op_overhead);
- serve: the serve CLI's server (`serve.build_server`, bf16, seeded random
  weights, CLEVR on serve.py's 5 x 5 example grid) behind
  `run_http_server` on 127.0.0.1, over HTTP: /healthz, /warmup, two
  /generate whose depth checksums must be bit-equal (24 frames, 24
  z-buffer and codeword launches each), an export under output_root, an
  escaping output_dir (500), unknown paths (404), /metrics; seconds and
  frames/s a request, export seconds, peak memory and the idle share of a
  profiled request;
- evaluate: the evaluate CLI (`evaluate.main`) on serve's exported frames
  against a seeded noisy copy, with masks and --fid, on the card and on
  the CPU (PSNR, SSIM and the visible variants within 1e-9), and
  InceptionV3's features of 8 frames on the card against the CPU;
- serve_map: a map-requery server (CLEVR 3 x 3, bf16): two requests with
  equal checksums (reset rebuilds the map);
- parity_check: the port's checkpoint-parity tool (`python -m
  sgam_neurips22_tpu_torch.parity_check`, its `run`) on a flagship .ckpt
  written from the seeded weights with codewords drawn from the model's
  own pre-quant latents: --record on the CPU, then on the card --compare
  against it, the cross-check against the torch-functional oracle, and
  --compare of a copy with one decoder tensor perturbed, which must exit 1
  on decoder-side stages only; one z-buffer and two codeword launches a
  card run; each stage's max |diff| beside its largest magnitude;
- convert_exr: the port's EXR converter (`python -m
  sgam_neurips22_tpu_torch.convert_exr`, its main) on four 256^2 Blender
  multilayer renders (HALF and FLOAT, ZIP and NONE) written here from
  seeded arrays: the depth and instance files equal to the arrays (HALF as
  np.float16 rounds them), the PNGs to their sRGB; whether this machine
  has OpenEXR is probed, and where it is held against the port's reader;
  then PIZ, PXR24, B44 and B44A files (HALF and FLOAT, 256 wide, 200 to
  256 rows; B44A with flat blocks, and a B44A file with its channels'
  pLinear flag set) written by this machine's cv2 (OpenEXR inside), which
  must be able to write them: each read by the port bit-equal to cv2.imread, PXR24 FLOAT
  also equal to OpenEXR's 24-bit rounding of the written array, a PIZ
  FLOAT file whose chunks reach the modular wavelet, and the seconds a
  file of the native and the numpy PIZ decoders; then DWAA and DWAB files
  (Y, BGR, BGRA, HALF and FLOAT, pLinear, 256 wide, rows ending in a
  partial chunk and block, one at a level that leaves blocks DC-only)
  written here by `write_dwa` (this cv2 writes DWA files without chunks,
  which is probed and recorded), read by OpenEXR (cv2.imread, which must
  read them) and by the port with both Huffman decoders, bit-equal, every
  chunk compressed; and the seconds of `read_exr` on one 256^2 BGRA HALF
  image as DWAA, ZIP and PIZ (recorded, not gated);
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
  gradients in float64, computed on the card with the plain attention and
  codeword search);
- train_bf16: the same step with a bf16 model (train_conditional_bf16),
  the same launches; then parity_train_bf16, its batch-2 step on the card
  and on the CPU, each held to the CPU's f32 step at a codebook where no
  latent changes codeword, and a planted fault (dV zeroed) that must fail;
- trace_tools (run right after the kernel checks, early in the process,
  where profiler sessions lose fewest records): the port's trace tools on
  the card. One bf16 training step
  at batch 16 and 4 frames of bf16 CLEVR map re-query at batch 1 (all six
  hand ops between them), each traced by `utils.profiling.trace` after an
  untraced run whose hand-op inputs are kept, read by
  `utils.trace_events` and printed by `parse_trace` and `roofline`: every
  hand op present with its kernels under it, each hand row's modelled work
  equal to `roofline.hand_work` at the kept inputs, no hand row under its
  bound and no other row under its L2 floor (rows under their bound but
  not their floor are counted: operands in the L2), the card's L2 at
  least the floor's, and each hand op's kept call traced alone within 5%
  of device_ms of the same call, where no launch was lost (lost launches
  are counted and printed, not gated);
- train_batch1: the same f32 step at batch 1, whose config asks for flash
  attention (as every training YAML does), so that the step runs the
  three attention kernels at [1, 4096, 256] and [1, 256, 512], as at
  batch 16 (the attention checks above hold them there too);
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
  frames, no flash attention though the run's YAML asks for it;
  parity_trainer, two Trainer steps (accumulation 2, the scheduler on) on
  the card against the CPU under parity_train's gates; tools, the port's
  JAX-free tools: pack_dataset packs the train split at 128^2 from the
  256^2 PNGs (bit-equal to the PNG path), convert_lpips converts seeded
  VGG16 and LPIPS-head .pth files, and the train CLI runs two steps of the
  codebook YAML at 128^2 from the packed loader with those LPIPS weights;
- data parallelism (the port's parallel/, with the rank functions of
  sgam_neurips22_tpu_torch/studies/data_parallel.py): dp_world1, the
  conditional YAML's step at batch 16 (f32) through the data-parallel path
  in one spawned rank over NCCL against the plain one-process step from the
  same state, under parity_train's gates, beside the distance between two
  plain steps (the floor), the rank's launches a step, NCCL's device time
  and both processes' peaks; dp_two_ranks_one_card, two gloo ranks sharing
  the card (2 rows each) against the one-process step at batch 4 (logs,
  d_weight, the applied update, the running statistics), with two planted
  faults (BatchNorm on local statistics, the adaptive weight from local
  gradients) that must fail, and every rank's parameters, Adam moments and
  k-means state bit-equal after two steps and a refresh; scenes_sharded, in
  the same two ranks, the 8-scene unrolls split 4 a rank against the
  unsharded ones: one f32 step within 1e-5 relative, and one step of 2
  scenes, one a rank, against the unsharded 2-scene step (each rank runs
  flash attention at batch 1, as the whole batch takes it), the bf16
  splat unroll's PSNR per scene (reported), the bf16 map unroll's stats
  summed over the ranks (their recycled slots equal to the ranks'
  per-scene sum). dp_two_ranks_one_card's batch has halves of two kinds
  (random images and flat walls), on which both planted faults must fail;
each rank also profiles one more training step and its f32 sharded step,
whose idle shares must lie in [0, 1] (unless their traces lost launches).

Device times by kernel come from torch.profiler traces read by
`sgam_neurips22_tpu_torch/utils/trace_events.py` (device_ms,
kernel_split, profile_unroll: primed sessions whose primers take the
records a session loses at its edges; busy time is the union of the
card's record intervals, and a session that lost a launch of its work
gives none); the seeded cases and helpers that the studies share with
this script live in `sgam_neurips22_tpu_torch/studies/cases.py`, the
hand ops' FLOPs and bytes in `roofline.hand_work`. Each phase prints one JSON line with its
seconds; --out DIR also writes the details to DIR/chip_smoke.json and
nvcc's register report to DIR/chip_smoke_ptxas.txt. The last line is
{"ok": true, "device": {...}} and is printed only when every check passed.
It exits non-zero without that line when CUDA is unavailable or any check
fails.
"""
from __future__ import annotations

import argparse
import copy
import gc
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

from sgam_neurips22_tpu_torch.roofline import HAND_OPS, bound_parts, hand_work, tc_bound_s
from sgam_neurips22_tpu_torch.studies.cases import (
    FRAMES,
    GE_MAP_FRAMES,
    MAP_BATCH_GRID,
    MAP_GRID,
    MAP_STRIDE2_GRID,
    SCENES,
    SEED,
    TRAIN_BATCH,
    H,
    W,
    batched_pool_telemetry,
    capture_grid_inputs,
    capture_grid_inputs_batched,
    collision_case,
    grid_accumulate_sorted,
    grid_input_stats,
    last_step,
    map_config,
    parity_train_bf16,
    pool_telemetry,
    projected,
    psnr,
    ptxas_summary,
    seed_frames,
    train_batch,
    train_config,
    update_gap,
    zbuffer_cases,
)
from sgam_neurips22_tpu_torch.utils.trace_events import (
    F32_FLOP_PER_S,
    L2_BYTES,
    PROFILER_MISSES,
    ZB_KERNELS,
    card_line,
    cuda_ms,
    device_ms,
    kernel_split,
    profile_unroll,
)

TOPK_FRAMES = 8  # frames of each top-k unroll
BATCHED_F32_FRAMES = 12  # frames a scene of the f32 8-scene unroll (cut from FRAMES for the run's time)
# the forward: the main path's two shapes, ragged S, and together every (C,
# BQ) tile that its launch rule picks on an H100 (BQ 64 / 16, 32 / 16 at C=512);
# the B=16 ragged shapes run the large tiles with a partial last query block,
# and at S=280 a last key tile of 24 keys, past which a whole warp's keys lie;
# last, batch 1's two shapes (a rank of one scene, a batch-1 training step)
BATCH1_SHAPES = ((1, 4096, 256), (1, 256, 512))
FLASH_SHAPES = ((8, 4096, 256), (8, 256, 512), (16, 4096, 256), (2, 300, 128), (2, 300, 64), (16, 256, 512),
                (3, 77, 512), (5, 1000, 512), (2, 300, 256), (16, 1024, 128), (16, 1024, 64), (16, 300, 128),
                (16, 280, 256), (16, 280, 128), (16, 280, 64), *BATCH1_SHAPES)
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
# training step x2, ragged S x2, a batch-1 training step's two
BACKWARD_SHAPES = ((16, 4096, 256), (16, 256, 512), (2, 300, 128), (2, 300, 64), *BATCH1_SHAPES)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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


def hand_bound(name: str, dims, concrete=(), touched: int = 0) -> tuple[float, str, float]:
    """(bound_ms, bound_by, bound_tc_ms) of one call of the hand op `name`
    at input shapes `dims`: the roofline tool's bound of its work
    (`roofline.hand_work`, `bound_parts`: at the f32 rate of the CUDA
    cores) and its 3xTF32 bound (`tc_bound_s`)."""
    w = hand_work(f"sgam::{name}", dims, concrete, touched)
    t_bytes, t_ops = bound_parts(w, None)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", tc_bound_s(w) * 1e3


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
        b_ms, b_by, _ = hand_bound("zbuffer_min", [[b, p], [b, p]], ("", "", h, w))
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
    from sgam_neurips22_tpu_torch.ops.vq import (
        distance_gate_share,
        near_ties_ok,
        nearest_codeword,
        nearest_codeword_plain,
    )

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
        mismatches, ties_ok = near_ties_ok(z, cb, idx, pidx)
        share = distance_gate_share(z, cb, idx, dist)
        b_ms, b_by, b_tc = hand_bound("nearest_codeword", [[p, d], [k, d]])
        row = {"case": name, "shape": {"P": p, "K": k, "D": d}, "index_mismatches": mismatches,
               "near_ties_ok": ties_ok, "max_abs_err": float((dist - pdist).abs().max()), "gate_share": share,
               "plain_gate_share": distance_gate_share(z, cb, pidx, pdist), "bound_ms": b_ms,
               "bound_by": b_by, "bound_tc_ms": b_tc}
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
        b_ms, b_by, b_tc = hand_bound("flash_attention_fwd", [[b, s, c]] * 3)
        shapes.append({
            "shape": [b, s, c], "block_rows": flash_attention_fwd_block_rows(b, s, c, q.device), "ok": ok_s,
            "max_abs_err": err, "out_tol": tol, "lse_max_rel_err": lse_rel, "lse_tol_rel": 1e-5,
            "gate_share": max(err / tol, lse_rel / 1e-5),
            "f64_max_abs_err": f64_err[0], "plain_f64_max_abs_err": f64_err[1],
            **timings(torch, lambda: flash_attention_fwd(q, k, v),
                      lambda: flash_attention_plain(q, k, v),
                      lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)),
            "bound_ms": b_ms, "bound_by": b_by, "bound_tc_ms": b_tc,
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
        for name, kernel, plain, grads in (
            ("flash_attention_dq", flash_attention_dq, flash_attention_dq_plain, ("dq",)),
            ("flash_attention_dkv", flash_attention_dkv, flash_attention_dkv_plain, ("dk", "dv")),
        ):
            b_ms, b_by, b_tc = hand_bound(name, [[b, s, c]] * 4 + [[b, s]] * 2)
            idx = [("dq", "dk", "dv").index(x) for x in grads]
            rows[name].append({
                "shape": [b, s, c], "ok": ok, "max_abs_err": max(errs[i] for i in idx),
                "tolerance": max(tols[i] for i in idx), "gate_share": max(errs[i] / tols[i] for i in idx),
                **timings(torch, lambda: kernel(q, k, v, dout, lse, dd), lambda: plain(q, k, v, dout, lse, dd),
                          library),
                "bound_ms": b_ms, "bound_by": b_by,
                "bound_tc_ms": b_tc,
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


def parity_step(torch, gen, cpu_model, failures, seeds_batch=None, batches=None) -> dict:
    """Frame 1 of the unroll on the card against the same step on the CPU
    (plain versions), same weights and inputs, stage by stage: for the
    generator's own scene, or for the scenes of seeds_batch at once (the
    flash-attention path at 2 scenes and up, as the batched unroll asks
    for it, and the plain path at 1),
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
        pre = model.encode_prequant(x, m, flash)
        pre_c = cpu_model.encode_prequant(x.cpu(), m.cpu(), flash)
        latent_rel = float((pre.cpu() - pre_c).abs().max() / pre_c.abs().max())
        d = pre.shape[-1]
        idx = nearest_codeword_indices(pre.reshape(-1, d), model.codebook)
        idx_c = nearest_codeword_indices(pre_c.reshape(-1, d), cpu_model.codebook)
        # 3. decode from the same indices: rgb at atol 1e-3, metric depth at
        #    1e-3 relative (depth = 1/disparity amplifies absolute error)
        zq = model.codebook[idx.long()].reshape(pre.shape)
        xrec = model.decode(zq, flash).cpu()
        xrec_c = cpu_model.decode(zq.cpu(), flash)
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
        flash = cond.x.shape[0] >= 2  # as the unrolls ask for it
        res, res_c, ref = (gen.model(cond.x, cond.extrapolation_mask, flash=flash),
                           cpu_model16(x, m, flash=flash), cpu_model(x, m, flash=flash))
    out = {"scenes": int(cond.x.shape[0]), "flash_attention": flash,
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


TRAIN_STEPS = 3


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


def f64_gradients(torch, cfg, x, x_dst, mask, device: str = "cuda") -> dict:
    """The autoencoder gradients of the training step's loss in float64 on
    `device`, returned on the CPU, from the same seeded state and the same
    f32 conditioning: the reference both f32 runs are measured against.
    The hand kernels take f32 only, so this run calls the plain versions of
    the attention and the codeword search directly (the search ranks the
    f64 latents in f32). On an H100 the card's float64 gradients lay within
    1.7e-13 (relative, worst tensor) of the CPU's and took 1.5-2.9 s
    against the CPU's 64 s, so parity_train computes them on the card."""
    from sgam_neurips22_tpu_torch.models.vqgan import quantize
    from sgam_neurips22_tpu_torch.ops import attention, vq
    from sgam_neurips22_tpu_torch.training.lpips import random_lpips
    from sgam_neurips22_tpu_torch.training.train_step import _ae_loss, create_train_state, split_params

    wrappers = attention.flash_attention_fwd, attention.flash_attention_bwd, quantize.nearest_codeword
    attention.flash_attention_fwd, attention.flash_attention_bwd, quantize.nearest_codeword = (
        attention.flash_attention_plain, attention.flash_attention_bwd_plain, vq.nearest_codeword_plain)
    try:
        state = create_train_state(cfg, seed=SEED, device=device)
        state.model.double()
        state.disc.double()
        lpips = random_lpips(SEED + 2).to(device).double()
        loss = _ae_loss(state.model, state.disc, lpips, x.to(device).double(), x_dst.to(device).double(),
                        mask.to(device), 0, cfg)[0]
        names, params = zip(*split_params(state.model, cfg.phase)[0])
        return {n: g.cpu() for n, g in zip(names, torch.autograd.grad(loss, params))}
    finally:
        attention.flash_attention_fwd, attention.flash_attention_bwd, quantize.nearest_codeword = wrappers


def parity_train(torch, np, failures, bs: int = 2) -> dict:
    """One training step at batch `bs`, full width, on the card (kernels)
    and on the CPU (plain versions) from the same seeded state and batch,
    and the same step's autoencoder gradients in float64 (on the card:
    f64_gradients).

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
        "batch": bs, "gpu_seconds": g_s, "cpu_seconds": c_s, "f64_seconds": f64_s, "f64_device": "cuda",
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


MAP_PARITY_FRAMES = 3  # generated frames that map_parity fuses after the seed


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


def check_grid_accumulate(torch, cases: dict, failures) -> dict:
    """The map's grid accumulation (csrc/grid_accumulate.cu: zero addends
    dropped, a radix sort with the value as payload, the walk) against its
    plain version on the CPU (index_add_, sequential, as the JAX package's
    scatter-add on the CPU), bit-exact as 32-bit words, at the inputs
    integrate built at the last step of each map phase in `cases`; the
    plain version on the card (index_add_'s float atomics) is reported
    beside it. Per case: the inputs' key bits, zero addends and runs
    (grid_input_stats) and the sort's digit plan; times of the whole call,
    index_add_ and index_put_(accumulate=True) on the card (timings); the
    first route (grid_accumulate_sorted) and the op timed in turns (old,
    new, new, old: old_ms is the mean of the two old turns, ms the median
    of the two new turns and timings' reading, since a trace late in this
    process was seen to miss events and read low); each kernel's device
    time in launch order for both routes (kernel_split). The bound
    is the bytes, each sample's int32 id and f32 value read once and each
    touched voxel's f32 read and written once. The reported times and
    bound are the first case's; every case's are under "shapes"."""
    from sgam_neurips22_tpu_torch.ops.grid_accumulate import digit_plan, grid_accumulate, grid_accumulate_plain

    def words(t):
        return t.cpu().view(torch.int32)

    shapes = []
    for name, c in cases.items():
        grid, idx, vals = c["grid"], c["idx"], c["vals"]
        out = grid_accumulate(grid.clone(), idx, vals)
        ref = grid_accumulate_plain(grid.to("cpu", copy=True), idx.cpu(), vals.cpu())
        atomics = grid_accumulate_plain(grid.clone(), idx, vals)
        torch.cuda.synchronize()
        stats = grid_input_stats(torch, grid, idx, vals)
        b_ms, b_by, _ = hand_bound("grid_accumulate", [[grid.numel()], [idx.numel()], [idx.numel()]],
                                   touched=stats["touched_voxels"])
        work, lib_idx = grid.clone(), idx.long()

        def new():
            grid_accumulate(work, idx, vals)

        def old():
            grid_accumulate_sorted(torch, work, idx, vals)

        turns = [{"route": r, "ms": device_ms(torch, fn), "call_ms": cuda_ms(torch, fn)}
                 for r, fn in (("old", old), ("new", new), ("new", new), ("old", old))]
        times = timings(torch, new, lambda: grid_accumulate_plain(work, idx, vals),
                        lambda: work.index_put_((lib_idx,), vals, accumulate=True))
        times["ms"] = sorted([times["ms"], turns[1]["ms"], turns[2]["ms"]])[1]
        row = {"case": name, "shape": stats, "digit_plan": digit_plan(grid.numel()),
               "bit_exact": torch.equal(words(out), ref.view(torch.int32)),
               "max_abs_err": float((out.cpu() - ref).abs().max()),
               "plain_on_card_max_abs_err": float((atomics.cpu() - ref).abs().max()),
               **times, "old_ms": (turns[0]["ms"] + turns[3]["ms"]) / 2,
               "old_call_ms": (turns[0]["call_ms"] + turns[3]["call_ms"]) / 2,
               "turns": turns, "split": kernel_split(torch, new), "old_split": kernel_split(torch, old),
               "bound_ms": b_ms, "bound_by": b_by}
        row["ok"] = row["bit_exact"]
        row["bound_share"] = b_ms / row["ms"]
        shapes.append(row)
        if not row["ok"]:
            failures.append(f"grid_accumulate differs from its plain version on the CPU, case {name}: "
                            f"{ {k: v for k, v in row.items() if k not in ('split', 'old_split')} }")
        del out, ref, atomics, work, lib_idx
    return {
        "name": "grid_accumulate", "route": "cuda", "source": "sgam_neurips22_tpu_torch/csrc/grid_accumulate.cu",
        "replaces": "sgam_neurips22_tpu/mapping/tsdf.py:564 (XLA scatter-add, no Pallas kernel)",
        "ok": all(r["ok"] for r in shapes), "bit_exact": all(r["bit_exact"] for r in shapes),
        "max_abs_err": max(r["max_abs_err"] for r in shapes),
        **{k: v for k, v in shapes[0].items() if k not in ("case", "ok", "bit_exact", "max_abs_err")},
        "shapes": shapes,
    }


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
    from sgam_neurips22_tpu_torch.ops.grid_accumulate import grid_accumulate

    want = {**want_launches(frames), "grid_accumulate": frames}
    (rgb, _), rep, prof = unroll_phase(torch, gen.scene_expansion, frames, (*counters, grid_accumulate), want,
                                       failures, name, gen.reset)
    rep.update(card=card, dataset=gen.cfg.dataset, grid=list(gen.cfg.output_dim),
               sources=gen.cfg.effective_num_src, coherent_plane_depth=gen.cfg.coherent_plane_depth,
               frames_differ=not torch.equal(rgb[gen.grid.index(*gen.order[1])], rgb[gen.grid.index(*gen.order[-1])]),
               **pool_telemetry(np, gen))
    if not rep["frames_differ"]:
        failures.append(f"{name}: the first and last generated frames are equal")
    rep["map_ms"] = map_times(torch, gen)
    rep["sync_free"] = sync_free(torch, gen, failures)
    rep["grid_inputs"] = capture_grid_inputs(torch, gen)
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


# map_parity's gate on the grid, card against CPU: a float sum in another
# order may differ in its last bits, and a sum that cancels may read 0 on
# one side alone (index_add_'s atomics did: at most 4.8e-7 apart, 14 of
# 1.7 M observed voxels flipped; ops/grid_accumulate adds in the CPU's
# order, and the grids read bit-exact, PERF.md §6). The integer state
# is held bit-exact.
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
        b_ms, b_by, _ = hand_bound("zbuffer_min", [[b, p], [b, p]], ("", "", H, W))
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
                gen._step(plan, 0, rgb_flat, depth_flat, vol, None, flash=True)  # 2 scenes: the batched unroll's path
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


def write_template(np, rng, root: Path, size: tuple = (H, W)) -> None:
    """A clevr-infinite seed template in the reference layout at `size`
    (H x W unless given): an 8-bit RGB PNG and its ray depth, U(8, 14), at
    grid (0, 0)."""
    from sgam_neurips22_tpu_torch.pipeline.png import write_png

    root.mkdir(parents=True)
    write_png(str(root / "im_00000_00_00.png"), rng.integers(0, 256, (*size, 3), dtype=np.uint8))
    np.save(root / "dm_00000_00_00.npy", rng.uniform(8, 14, size).astype(np.float32))


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
    ("template_resize", ["--rows", "2", "--cols", "1"], 1),  # from a TEMPLATE_SIDE^2 template
)
TEMPLATE_SIDE = 320  # the template_resize run's template: LANCZOS-resized to H x W on load


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
    point-cloud exports and the mesh apart. The template_resize run reads a
    template of TEMPLATE_SIDE^2, which the loader resizes to H x W with
    Pillow's LANCZOS (the branch a template of another size takes): its
    seed frame must be that resize of the template's PNG (within one level:
    the frame's PNG is written from the [-1, 1] float frame). With model16
    and seeds it also times the exports of a coherent-plane map
    (coherent_export)."""
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
        write_template(np, np.random.default_rng(SEED + 7), root / "templates_resize", (TEMPLATE_SIDE,) * 2)
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
                templates = root / ("templates_resize" if name == "template_resize" else "templates")
                argv = ["--dataset", "clevr-infinite", "--ckpt", str(root / "last.ckpt"), "--template_dir",
                        str(templates), "--output_dir", str(out_dir), "--resolution", str(H),
                        "--matmul_precision", "float32", *flags]
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
                if name == "template_resize":
                    from PIL import Image

                    from sgam_neurips22_tpu_torch.pipeline.png import read_png

                    with Image.open(templates / "im_00000_00_00.png") as im:
                        want_seed = np.asarray(im.convert("RGB").resize((W, H), resample=Image.LANCZOS), np.int16)
                    seed_diff = int(np.abs(read_png(str(out_dir / "im_00000_00_00.png")).astype(np.int16)
                                           - want_seed).max())
                    run.update(template_side=TEMPLATE_SIDE, seed_frame_max_level_diff_vs_lanczos=seed_diff)
                    run["ok"] = run["ok"] and seed_diff <= 1
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


PRECISION_FRAMES = 4  # frames of each generate_precision unroll, at batch 1 and at SCENES scenes
PRECISION_MODES = ("float32", "default")  # generate --matmul_precision: TF32 off, TF32 on
# max |diff| of the first frame's pre-quant latents (largest ~1.2), default against float32: 1.84e-3 at
# batch 1 and 2.17e-3 at 8 scenes were measured (NVIDIA H100 80GB HBM3, 700.00 W), TF32's 10-bit
# significand through the encoder's convolutions
PRECISION_LATENT_TOL = 1e-2


def precision_phase(torch, np, model, seeds, seeds_batch, counters, failures, card) -> dict:
    """generate's --matmul_precision on the card: `set_matmul_precision`
    (as `generate.main` sets it) before the unroll is built, then
    unroll_phase of the f32 flythrough, PRECISION_FRAMES frames at batch 1
    and at SCENES scenes, in each of PRECISION_MODES. Reports ms/frame, the
    profile's conv ms a frame and its conv kernels' names, the launches, and
    for the first frame the max |diff| of `default`'s pre-quant latents, RGB
    and depth against `float32`'s, and how many of its codeword indices
    differ (argmin in f32 on the CPU of each mode's latents). Gates: finite
    frames and the launches (unroll_phase), TF32 conv kernels in `default`
    and no kernel named tf32 in `float32`, the latents within
    PRECISION_LATENT_TOL. The mode is `float32` again afterwards."""
    import re

    from sgam_neurips22_tpu_torch.core.device import set_matmul_precision
    from sgam_neurips22_tpu_torch.ops.vq import nearest_codeword_plain
    from sgam_neurips22_tpu_torch.pipeline.scene_generation import InfiniteSceneGeneration, SceneGenConfig

    cfg = SceneGenConfig(dataset="clevr-infinite", output_dim=(PRECISION_FRAMES + 1, 1), topk=1,
                         image_resolution=(H, W))
    codebook = model.codebook.detach().cpu()
    rep = {"frames": PRECISION_FRAMES, "card": card}
    try:
        for case, scenes in (("batch1", 1), (f"scenes{SCENES}", SCENES)):
            first, rep[case] = {}, {}
            for mode in PRECISION_MODES:
                set_matmul_precision(mode)
                gen = InfiniteSceneGeneration(model, cfg, seeds, device="cuda")
                if scenes == 1:
                    unroll, prepare = gen.scene_expansion, gen.reset
                else:
                    unroll, prepare = (lambda: gen.scene_expansion_batched(seeds_batch)), (lambda: None)
                want = {"zbuffer_min": PRECISION_FRAMES, "nearest_codeword": PRECISION_FRAMES,
                        "flash_attention_fwd": 0 if scenes == 1 else 7 * PRECISION_FRAMES,
                        "flash_attention_dq": 0, "flash_attention_dkv": 0}
                latents = []  # the first quant_conv output: the first frame's pre-quant latents
                hook = model.quant_conv.register_forward_hook(
                    lambda mod, inp, out: latents.append(out.detach().cpu()) if not latents else None)
                try:
                    (rgb, depth), run, _ = unroll_phase(torch, unroll, scenes * PRECISION_FRAMES, counters, want,
                                                        failures, f"generate_precision {case} {mode}", prepare,
                                                        per_step=scenes)
                finally:
                    hook.remove()
                z = latents[0].permute(0, 2, 3, 1).reshape(-1, codebook.shape[1])
                first[mode] = {"latents": latents[0], "indices": nearest_codeword_plain(z, codebook)[0],
                               "rgb": (rgb[1] if scenes == 1 else rgb[:, 1]).cpu(),
                               "depth": (depth[1] if scenes == 1 else depth[:, 1]).cpu()}
                conv = run.get("conv_kernels", [])
                run["conv_ms_per_frame"] = (run["ms_per_frame_by_layer"] or {}).get("conv (cuDNN: implicit GEMM, FFT)")
                run["tf32_conv_kernels"] = [k for k in conv if re.search("tf32", k, re.I)]
                run["names_ok"] = (bool(run["tf32_conv_kernels"]) if mode == "default"
                                   else not any(re.search("tf32", k, re.I) for k in conv))
                if not run["names_ok"]:
                    failures.append(f"generate_precision {case} {mode}: conv kernels {conv}")
                rep[case][mode] = run
                del gen, rgb, depth
            a, b = first["default"], first["float32"]
            diff = {k: float((a[k] - b[k]).abs().max()) for k in ("latents", "rgb", "depth")}
            rep[case]["first_frame"] = {
                **{f"{k}_max_abs_diff": v for k, v in diff.items()},
                "latents_max_abs": float(b["latents"].abs().max()),
                "index_mismatches": int((a["indices"] != b["indices"]).sum()), "indices": int(a["indices"].numel()),
                "latent_tol": PRECISION_LATENT_TOL}
            if not diff["latents"] <= PRECISION_LATENT_TOL:
                failures.append(f"generate_precision {case}: first frame's latents {diff} "
                                f"(tolerance {PRECISION_LATENT_TOL})")
            torch.cuda.empty_cache()
    finally:
        set_matmul_precision("float32")
    return rep


# ---------------------------------------------------------------- the trainer
# (the repository's configs at full width, on datasets written below from a seed)
CODEBOOK_YAML = "configs/codebooks/clevr-infinite.yaml"
CONDITIONAL_YAML = "configs/conditional_generation/clevr-infinite.yaml"
DATA_SCENES, DATA_FRAMES = 8, 18  # train split: 8 scenes x 18 frames (9 batches of 16); val: 1 scene
PAETH_EVERY = 2  # every second PNG of the dataset is hand-encoded with the Paeth filter
# the codebook run's overrides besides dataset_dir: a buffer of 8 steps, full
# after step 8, and a timeout of one step, so that the refresh fires at step 8
# with every codeword batch element 0 did not use at step 7 inactive (8 steps
# of 256 latents are the fewest rows that k-means of 2048 codewords takes)
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


def run_train_cli(argv: list, lpips_weights: str = ""):
    """The port's train CLI (`sgam_neurips22_tpu_torch.train.main`) in this
    process, with `--lpips_weights` (none: seeded random LPIPS); the
    signal handlers it installs are put back afterwards."""
    import signal

    from sgam_neurips22_tpu_torch import train as train_cli

    saved = {s: signal.getsignal(s) for s in (signal.SIGUSR1, signal.SIGUSR2, signal.SIGTERM)}
    try:
        return train_cli.main([*argv, "--no_wandb", "--lpips_weights", lpips_weights, "--device", "cuda",
                               "--n_devices", "1"])
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
    finite frames, one z-buffer and one codeword launch a frame, and no
    flash attention although the run's YAML asks for it (the batch-1
    unroll strips the field, as JAX's does)."""
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
                   "--resolution", str(H), "--device", "cuda", "--matmul_precision", "float32"])
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
                 and launches["nearest_codeword"] == 3 and launches["flash_attention_fwd"] == 0)
    if not rep["ok"]:
        failures.append(f"generate_config: {rep}")
    return rep


PARITY_TRAINER_RES = 64  # parity_trainer's images: the full-width model on a small input


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


PACK_RES = (128, 128)  # pack_dataset's resolution: the trainer dataset's 256^2 PNGs are LANCZOS-resized


def train_batch1(torch, np, counters, failures, card) -> dict:
    """The conditional training step at batch 1 with flash attention on
    (train_config: the YAML's field, as a rank holding one image of a YAML
    run, or a single process at batch 1, runs it): a warm-up step, then
    TRAIN_STEPS counted steps, whose launches a step must be the batch-16
    step's (z-buffer 1, codeword 1, flash forward 12, dQ 7, dK/dV 7: the
    kernels at [1, 4096, 256] and [1, 256, 512]); finite logs, every
    trainable parameter moved; ms/step."""
    from sgam_neurips22_tpu_torch.training.lpips import random_lpips
    from sgam_neurips22_tpu_torch.training.train_step import create_train_state, split_params, train_step

    cfg = train_config(torch, 1)
    state = create_train_state(cfg, seed=SEED, device="cuda")
    lpips = random_lpips(SEED + 2).cuda()
    batch = train_batch(torch, np, 1, "cuda")
    trainable = split_params(state.model, cfg.phase)[0]
    before = {n: p.detach().clone() for n, p in trainable}
    train_step(state, batch, lpips, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        _, logs = train_step(state, batch, lpips, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    totals = {fn.__name__: fn.launches for fn in counters}
    logs = {k: float(v) for k, v in logs.items()}
    want = {"zbuffer_min": 1, "nearest_codeword": 1, "flash_attention_fwd": 12, "flash_attention_dq": 7,
            "flash_attention_dkv": 7}
    rep = {"batch": 1, "flash_attention": cfg.model.ddconfig.flash_attention, "steps": TRAIN_STEPS,
           "ms_per_step": dt / TRAIN_STEPS * 1e3, "launches": totals,
           "launches_per_step": {k: v / TRAIN_STEPS for k, v in totals.items()},
           "finite": all(np.isfinite(v) for v in logs.values()), "logs": logs,
           "trainable_unmoved": [n for n, p in trainable if torch.equal(p.detach(), before[n])],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card}
    rep["ok"] = rep["launches_per_step"] == want and rep["finite"] and not rep["trainable_unmoved"]
    if not rep["ok"]:
        failures.append(f"train_batch1: {rep} (launches a step wanted {want})")
    del state, lpips, batch, before
    return rep


def lpips_torch_files(torch, np, root: Path) -> tuple:
    """A torchvision-layout VGG16 state_dict (`features.N.weight` and
    `.bias`, OIHW, He-scaled normals) and an LPIPS heads file
    (`lin{i}.model.1.weight`) from numpy seed SEED + 13, written with
    torch.save as root/vgg16.pth and root/vgg.pth: the inputs of
    convert_lpips. Returns (paths, the two state dicts)."""
    from sgam_neurips22_tpu_torch.training.lpips import LPIPS_CHANNELS, VGG16_CONVS

    rng = np.random.default_rng(SEED + 13)
    vgg = {}
    for idx, cin, cout in VGG16_CONVS:
        vgg[f"features.{idx}.weight"] = torch.from_numpy(
            (rng.standard_normal((cout, cin, 3, 3)) * np.sqrt(2.0 / (9 * cin))).astype(np.float32))
        vgg[f"features.{idx}.bias"] = torch.from_numpy(rng.uniform(-0.1, 0.1, cout).astype(np.float32))
    lin = {f"lin{i}.model.1.weight": torch.from_numpy(rng.uniform(0, 0.1, (1, c, 1, 1)).astype(np.float32))
           for i, c in enumerate(LPIPS_CHANNELS)}
    paths = (root / "vgg16.pth", root / "vgg.pth")
    torch.save(vgg, paths[0])
    torch.save(lin, paths[1])
    return paths, vgg, lin


def tools_phase(torch, np, root: Path, counters, failures, card) -> dict:
    """The port's JAX-free tools on the trainer's dataset (root/data):
    `pack_dataset` (its CLI's main) packs the train split at PACK_RES from
    the 256^2 PNGs (the LANCZOS branch), and its records must equal the PNG
    path's examples at PACK_RES bit for bit (the first, a middle and the
    last); `convert_lpips` (its CLI's main) converts synthetic VGG16 and
    LPIPS-head .pth files; then the train CLI runs two steps of the codebook
    YAML at PACK_RES (k-means off: its buffer is sized for 256^2 latents)
    from the packed loader, with --lpips_weights the converted file: the
    trainer's LPIPS must equal `lpips_from_torch` of the two files, its
    loader be the packed one at PACK_RES, its logs finite and its kernels
    launched."""
    from sgam_neurips22_tpu_torch import convert_lpips, pack_dataset
    from sgam_neurips22_tpu_torch.training.data.codebook_dataset import CodebookDataset
    from sgam_neurips22_tpu_torch.training.data.packed import PackedCodebookDataset

    data = str(root / "data")
    h, w = PACK_RES
    t0 = time.perf_counter()
    shard = pack_dataset.main(["--dataset_dir", data, "--dataset", "clevr-infinite", "--resolution", str(h), str(w),
                               "--splits", "train"])[0]
    pack_s = time.perf_counter() - t0
    packed, png = PackedCodebookDataset(shard), CodebookDataset("train", data, "clevr-infinite", PACK_RES)
    picks = sorted({0, len(png) // 2, len(png) - 1})
    records_equal = len(packed) == len(png) and all(
        np.array_equal(packed[i]["image"], png[i]["image"]) for i in picks)
    packed.close()
    t0 = time.perf_counter()
    (vgg_path, lin_path), vgg, lin = lpips_torch_files(torch, np, root)
    weights = str(root / "lpips.pkl")
    convert_lpips.main(["--vgg", str(vgg_path), "--lin", str(lin_path), "--out", weights])
    convert_s = time.perf_counter() - t0
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    tr = run_train_cli(["--base", CODEBOOK_YAML, "-l", str(root / "logs_tools"), "-n", "packed", "--max_steps", "1",
                        f"data.params.dataset_dir={data}", f"data.params.image_resolution=[{h},{w}]",
                        "model.params.online_kmeans_config.do_online_kmeans_clustering=false"], lpips_weights=weights)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    want_lp = convert_lpips.lpips_from_torch(vgg, lin).state_dict()
    got_lp = tr.lpips.state_dict()
    metrics = [json.loads(x) for x in open(os.path.join(tr.logdir, "metrics.jsonl"))]
    train_logs = [m for m in metrics if any(k.startswith("train/") for k in m)]
    rep = {"pack_resolution": list(PACK_RES), "pack_seconds": pack_s, "records": len(png),
           "records_equal_png_path": records_equal, "convert_seconds": convert_s,
           "lpips_equal_converted": set(got_lp) == set(want_lp) and all(
               torch.equal(got_lp[k].cpu(), v) for k, v in want_lp.items()),
           "packed_loader": isinstance(tr.data.train_ds, PackedCodebookDataset)
           and (tr.data.train_ds.height, tr.data.train_ds.width) == PACK_RES,
           "steps": tr.state.step, "train_seconds": train_s, "launches": launches,
           "finite_logs": bool(train_logs) and all(np.isfinite(v) for m in train_logs for k, v in m.items()
                                                   if k.startswith("train/")), "card": card}
    tr.close()
    rep["ok"] = (records_equal and rep["lpips_equal_converted"] and rep["packed_loader"] and rep["steps"] == 2
                 and rep["finite_logs"] and launches["nearest_codeword"] > 0 and launches["flash_attention_fwd"] > 0)
    if not rep["ok"]:
        failures.append(f"tools: {rep}")
    return rep


def trainer_phases(torch, np, counters, failures, card, paths: dict, report: dict) -> None:
    """The trainer's phases, each emitted as it ends: loader,
    train_codebook_cli, train_conditional_cli, generate_config,
    parity_trainer and tools."""
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
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        tools = tools_phase(torch, np, root, counters, failures, card)
        tools["phase_seconds"] = time.perf_counter() - t0
        paths["tools_train_step"] = tools["launches"]
        report["tools"] = tools
        emit({"phase": "tools", **tools})


# ---------------------------------------------------------- data parallel
# (the port's parallel/: the step as one rank of a process group, and the
# scene-sharded unroll; the rank functions live in studies/data_parallel.py)
DP_REHEARSAL_BATCH = 4  # dp_two_ranks_one_card: two gloo ranks x 2 rows on one card
DP_STEP_WANT = {"zbuffer_min": 1, "nearest_codeword": 1, "flash_attention_fwd": 7, "flash_attention_dq": 7,
                "flash_attention_dkv": 7}  # launches a step of the conditional YAML (no remat)


def dp_world1(torch, np, failures, card) -> dict:
    """The conditional YAML's step at batch 16, f32, through the data-parallel
    path in one spawned rank over NCCL (its all-reduces run, on one rank),
    against the plain one-process train_step from the same seeded state,
    at parity_train's gates and each trainable gradient within 3e-2 of
    its tensor's largest (`studies.data_parallel.hold_step`); beside it the
    same distance between two plain steps on the card (cuDNN's backward is
    not bit-reproducible: the floor). The rank's launches a step, its NCCL
    kernels' device time, its ms/step; this process frees its cached
    memory before the spawn, and both peaks are reported."""
    import tempfile

    from sgam_neurips22_tpu_torch.parallel import distributed
    from sgam_neurips22_tpu_torch.studies import data_parallel as dp

    cfg = dp.train_cfg(TRAIN_BATCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    plain = [dp.run_step(torch, np, cfg, TRAIN_BATCH, 0) for _ in range(2)]
    plain_s = time.perf_counter() - t0
    parent_peak = torch.cuda.max_memory_allocated() / 1e9
    floor = dp.hold_step(torch, plain[1], plain[0], grads=True)
    gc.collect()  # the plain steps' states, before this process gives the card's memory back
    torch.cuda.empty_cache()
    parent_reserved = torch.cuda.memory_reserved() / 1e9
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        distributed.launch(dp.rank_train_step, 1, args=({"bs": TRAIN_BATCH, "out": tmp},))
        rank = torch.load(Path(tmp) / "train_rank0.pt", weights_only=False)
    rank_s = time.perf_counter() - t0
    gate = dp.hold_step(torch, rank, plain[0], grads=True)
    rep = {"batch": TRAIN_BATCH, "backend": "nccl", "ranks": 1, "plain_seconds": plain_s, "rank_seconds": rank_s,
           "vs_plain": gate, "plain_vs_plain_floor": floor, "launches_per_step": rank["launches_per_step"],
           "ms_per_step": rank["ms_per_step"], "images_per_s": rank["images_per_s"],
           "collective_ms": rank["collective_ms"], "device_idle_share": rank["device_idle_share"],
           "rank_ms_by_layer": rank["ms_by_layer"], "peak_mem_gb": {"parent": parent_peak, "rank": rank["peak_mem_gb"]},
           "parent_reserved_gb_at_spawn": parent_reserved,
           "card": card}
    rep["ok"] = gate["ok"] and rank["launches_per_step"] == DP_STEP_WANT
    if not rep["ok"]:
        failures.append(f"dp_world1: {rep}")
    return rep


PROFILE_KEYS = ("device_idle_share", "device_busy_ms", "device_kernel_ms", "lost_launches")


def idle_in_unit(prof: dict) -> bool:
    """A rank's idle share (1 - busy / its timed wall, busy the union of the
    card's record intervals) lies in [0, 1], or its trace lost launches
    (then it is not given, and not gated)."""
    share = prof["device_idle_share"]
    return bool(prof["lost_launches"]) or (share is not None and 0.0 <= share <= 1.0)


def rel_err(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def dp_two_ranks_one_card(torch, np, failures, card, seeds_batch, cpu_model, keep) -> tuple:
    """Two gloo ranks on this card (`studies.data_parallel.rank_rehearsal`),
    DP_REHEARSAL_BATCH / 2 rows each, f32, the conditional YAML's step with
    the k-means bookkeeping on, on a batch whose halves differ in kind
    (`global_batch(mixed=True)`: rank 1's rows are flat walls): the first
    step against the one-process step at batch DP_REHEARSAL_BATCH
    (`hold_step`: logs with d_weight, the applied update, the running
    statistics), which both planted faults must fail: BatchNorm on local
    statistics, and the adaptive weight from local gradients (on a batch of
    random images alike the halves' mean d_weight lay 2.4e-4 from the whole
    batch's on an H100, inside the 1e-3 gate; halves of two kinds have
    gradients of different directions, which the mean of their ratios does
    not average out); after a second step and a k-means refresh from a
    generator of each rank's own seed, the two ranks' parameters, buffers,
    Adam moments and k-means state bit-equal. gloo takes card tensors as
    they are on this torch build (no copy through the host).

    Then scenes_sharded, in the same two ranks: the 8-scene unrolls split
    4 a rank against the unsharded unroll on this card: one f32 step (grid
    2 x 1) within 1e-5 relative (rgb and depth); the same step of 2 scenes,
    one a rank, against the unsharded 2-scene step (bit-equality and the
    largest difference reported, within 1e-5 relative), each rank
    launching the flash forward in all 7 attention blocks at batch 1, as
    the whole batch of 2 takes flash; the bf16 splat unroll's
    frames (FRAMES a scene) as PSNR per scene against unroll_batched_bf16's
    (not gated: the batch size changes cuDNN's algorithm, and the model's
    random weights turn rounding into other frames); the bf16 map unroll
    (MAP_BATCH_GRID) with the stats summed over the ranks, whose recycled
    slots must equal the ranks' per-scene sum, against unroll_tsdf_batched's
    stats (reported). Each rank also times and profiles one more training
    step and the f32 step of its 4 scenes (`data_parallel.profile_step`):
    its idle share, 1 - busy (the union of the card's record intervals)
    / the timed wall, must lie in [0, 1] unless its trace lost launches."""
    import tempfile

    from sgam_neurips22_tpu_torch.parallel import distributed
    from sgam_neurips22_tpu_torch.studies import data_parallel as dp

    cfg = dp.train_cfg(DP_REHEARSAL_BATCH, kmeans=True)
    t0 = time.perf_counter()
    one = dp.run_step(torch, np, cfg, DP_REHEARSAL_BATCH, 0, mixed=True)
    gen = dp.scene_gen(copy.deepcopy(cpu_model), (2, 1), seeds_batch, False)
    with torch.inference_mode():
        step_ref = [x.cpu() for x in gen.scene_expansion_batched(seeds_batch)]
        step2_ref = [x.cpu() for x in gen.scene_expansion_batched(seeds_batch[:2])]
    del gen
    torch.cuda.empty_cache()
    parent_s = time.perf_counter() - t0
    cases = {"step_f32": ("float32", (2, 1), False, True, True),
             "step_f32_one_a_rank": ("float32", (2, 1), False, False, True, 2),
             "splat_bf16": ("bfloat16", (FRAMES + 1, 1), False, False, True),
             "map_bf16": ("bfloat16", MAP_BATCH_GRID, True, False, False)}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        spec = {"bs": DP_REHEARSAL_BATCH, "out": tmp, "mixed": True,
                "scenes": {"cases": cases, "seeds": seeds_batch}}
        distributed.launch(dp.rank_rehearsal, 2, args=(spec,), backend="gloo")
        ranks = [torch.load(Path(tmp) / f"rehearsal_rank{r}.pt", weights_only=False) for r in range(2)]
    ranks_s = time.perf_counter() - t0
    runs = ranks[0]["runs"]
    clean = dp.hold_step(torch, runs["clean"], one)
    faults = {f: dp.hold_step(torch, runs[f], one) for f in ("local_batchnorm", "local_d_weight")}
    dp_rep = {"ranks": 2, "backend": ranks[0]["backend"], "devices": [r["device"] for r in ranks],
              "global_batch": DP_REHEARSAL_BATCH, "batch_halves": "random | flat walls", "vs_one_process": clean,
              "planted_faults": {f: {"ok": g["ok"], "logs_ok": g["logs_ok"], "running_stats_ok": g["running_stats_ok"],
                                     "update_ok": g["update"]["ok"], "d_weight": g["d_weight"],
                                     "d_weight_rel_err": g["log_rel_err"].get("train/d_weight"),
                                     "running_stats_max_abs_err": g["running_stats_max_abs_err"]}
                                 for f, g in faults.items()},
              "refreshed_codewords": [r["refreshed"] for r in ranks],
              "bit_equal": {k: ranks[0]["checksums"][k] == ranks[1]["checksums"][k] for k in ranks[0]["checksums"]},
              "logs_equal_across_ranks": ranks[0]["runs"]["clean"]["logs"] == ranks[1]["runs"]["clean"]["logs"],
              "moved_from_init": ranks[0]["moved_from_init"], "parent_seconds": parent_s, "ranks_seconds": ranks_s,
              "step_profile": [{k: r["step_profile"][k] for k in PROFILE_KEYS} for r in ranks], "card": card}
    dp_rep["ok"] = (clean["ok"] and not faults["local_batchnorm"]["ok"] and not faults["local_d_weight"]["ok"]
                    and all(dp_rep["bit_equal"].values())
                    and dp_rep["logs_equal_across_ranks"] and dp_rep["refreshed_codewords"] == [dp.REFRESHED] * 2
                    and all(idle_in_unit(p) for p in dp_rep["step_profile"]))
    if not dp_rep["ok"]:
        failures.append(f"dp_two_ranks_one_card: {dp_rep}")
    sc = [r["scenes"] for r in ranks]
    step = sc[0]["step_f32"]
    one_a_rank = sc[0]["step_f32_one_a_rank"]
    frames16 = sc[0]["splat_bf16"]["rgb"]
    summed = [float(x) for x in sc[0]["map_bf16"]["stats"]]
    per_scene = sum(s["pool_recycled"] for r in sc for s in r["map_bf16"]["scenes_pool"])
    unsharded = keep["unroll_tsdf_batched"]
    sc_rep = {"ranks": 2, "scenes_a_rank": SCENES // 2,
              "step_f32": {"rgb_rel_err": rel_err(torch, step["rgb"], step_ref[0]),
                           "depth_rel_err": rel_err(torch, step["depth"], step_ref[1])},
              "step_f32_one_a_rank": {
                  "scenes": 2, "bit_equal": torch.equal(one_a_rank["rgb"], step2_ref[0])
                  and torch.equal(one_a_rank["depth"], step2_ref[1]),
                  "rgb_max_abs_diff": float((one_a_rank["rgb"] - step2_ref[0]).abs().max()),
                  "depth_max_abs_diff": float((one_a_rank["depth"] - step2_ref[1]).abs().max()),
                  "rgb_rel_err": rel_err(torch, one_a_rank["rgb"], step2_ref[0]),
                  "depth_rel_err": rel_err(torch, one_a_rank["depth"], step2_ref[1]),
                  "flash_fwd_launches_per_rank": [r["step_f32_one_a_rank"]["launches"]["flash_attention_fwd"]
                                                  for r in sc]},
              "splat_bf16": {"frames_per_scene": sc[0]["splat_bf16"]["frames_per_scene"],
                             "psnr_db_per_scene_vs_unsharded": [
                                 float(np.mean(psnr(torch, a[1:], b[1:])))
                                 for a, b in zip(frames16, keep["unroll_batched_bf16_rgb"])],
                             "seconds": [r["splat_bf16"]["seconds"] for r in sc]},
              "map_bf16": {"frames_per_scene": sc[0]["map_bf16"]["frames_per_scene"], "summed_stats": summed,
                           "ranks_per_scene_recycled": per_scene, "unsharded_stats": unsharded["stats"],
                           "stats_rel_diff_vs_unsharded": [abs(a - b) / max(abs(b), 1.0)
                                                          for a, b in zip(summed, unsharded["stats"])],
                           "seconds": [r["map_bf16"]["seconds"] for r in sc]},
              "finite": all(r[c]["finite"] for r in sc for c in cases),
              "step_f32_profile": [{k: r["step_f32"][k] for k in PROFILE_KEYS} for r in sc], "card": card}
    sc_rep["ok"] = (all(sc_rep[c][e] <= 1e-5 for c in ("step_f32", "step_f32_one_a_rank")
                        for e in ("rgb_rel_err", "depth_rel_err"))
                    and sc_rep["step_f32_one_a_rank"]["flash_fwd_launches_per_rank"] == [7, 7]
                    and sc_rep["finite"] and summed[3] == per_scene and summed[0] > 0
                    and all(idle_in_unit(p) for p in sc_rep["step_f32_profile"]))
    if not sc_rep["ok"]:
        failures.append(f"scenes_sharded: {sc_rep}")
    return dp_rep, sc_rep


def data_parallel_phases(torch, np, failures, card, paths: dict, report: dict, seeds_batch, cpu_model,
                         keep: dict) -> None:
    """dp_world1, then dp_two_ranks_one_card and scenes_sharded (one
    launch of two ranks), each emitted as it ends."""
    t0 = time.perf_counter()
    rep = dp_world1(torch, np, failures, card)
    rep["seconds"] = time.perf_counter() - t0
    paths["dp_world1"] = rep["launches_per_step"]
    report["dp_world1"] = rep
    emit({"phase": "dp_world1", **rep})
    t0 = time.perf_counter()
    dp_rep, sc_rep = dp_two_ranks_one_card(torch, np, failures, card, seeds_batch, cpu_model, keep)
    dp_rep["seconds"] = sc_rep["seconds"] = time.perf_counter() - t0
    report.update(dp_two_ranks_one_card=dp_rep, scenes_sharded=sc_rep)
    emit({"phase": "dp_two_ranks_one_card", **dp_rep})
    emit({"phase": "scenes_sharded", **sc_rep})


# ---------------------------------------------------------------- trace tools
# (the port's parse_trace and roofline on traces written by utils/profiling.trace)
TRACE_MAP_GRID = (5, 1)  # trace_tools' map re-query: 4 frames of CLEVR at batch 1
TRACE_SAME_CALL_ITERS = 10  # calls of a hand op in its own trace, and in device_ms, for the 5% gate
TRACE_SAME_CALL_TOL = 0.05


class HandCalls:
    """A spy on torch.ops.sgam's six ops inside a `with` block: `calls`
    holds the inputs of the first call of each (op, input shapes), cloned
    before the op runs (grid_accumulate adds into its grid)."""

    def __init__(self, torch):
        self.torch, self.calls, self.originals = torch, {}, {}

    class Spy:
        """Calls through to the op packet, keeping the first call's inputs
        of each shape; its attributes (`.default`, ...) are the packet's."""

        def __init__(self, owner, op, packet):
            self.owner, self.op, self.packet = owner, op, packet

        def __call__(self, *args):
            torch = self.owner.torch
            key = (self.op, tuple(tuple(a.shape) if torch.is_tensor(a) else () for a in args))
            if key not in self.owner.calls:
                self.owner.calls[key] = tuple(a.detach().clone() if torch.is_tensor(a) else a for a in args)
            return self.packet(*args)

        def __getattr__(self, name):
            return getattr(self.packet, name)

    def __enter__(self):
        for op in HAND_OPS:
            name = op.split("::")[1]
            packet = self.originals[name] = getattr(self.torch.ops.sgam, name)
            setattr(self.torch.ops.sgam, name, self.Spy(self, op, packet))
        return self

    def __exit__(self, *exc):
        for name, orig in self.originals.items():
            setattr(self.torch.ops.sgam, name, orig)


def hand_call_work(torch, op: str, args):
    """roofline.hand_work of one call from its tensors' shapes and its
    scalars."""
    dims = [list(a.shape) if torch.is_tensor(a) else [] for a in args]
    return hand_work(op, dims, ["" if torch.is_tensor(a) else str(a) for a in args])


def read_trace(path: Path, frames=None) -> dict:
    """The trace under `path` (written by utils/profiling.trace) through the
    reader, parse_trace and roofline: what the two tools print (their
    `report`, the top rows), the hand ops' kernels by the link to their op,
    the largest shares of a bound, and the lost launches."""
    import contextlib
    import io

    from sgam_neurips22_tpu_torch import parse_trace, roofline
    from sgam_neurips22_tpu_torch.utils import trace_events as te

    t0 = time.perf_counter()
    trace = te.from_file(te.newest(str(path)))
    read_s = time.perf_counter() - t0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        parse_trace.report(trace, 8, frames)
        roofline.report(trace, 8, frames)
    table, unmodelled = roofline.rows(trace, 0)
    hand = {op: {"records": 0, "links": {}, "kernels_elsewhere": 0} for op in HAND_OPS}
    for r in trace.records:
        label = te.group_of(r.name)
        if label.startswith("ours: "):  # a hand kernel: is it under its op?
            op = "sgam::" + label[len("ours: "):]
            if op in {o.name for o in r.ops}:
                hand[op]["records"] += 1
                hand[op]["links"][r.link] = hand[op]["links"].get(r.link, 0) + 1
            else:
                hand[op]["kernels_elsewhere"] += 1
    shares = sorted(((row.bound_s / row.time_s if row.time_s else float("inf")), row.op, [list(d) for d in row.dims])
                    for row in table)
    # a hand op is held at its whole bound, every other op at the L2 floor (roofline.Row.under)
    over = [(row.op, [list(d) for d in row.dims], row.under) for row in table
            if row.under == "UNDER FLOOR" or (row.op in HAND_OPS and row.under)]
    busy = te.busy_us(trace, 0)
    return {"rows": table, "read_seconds": read_s, "tools_seconds": time.perf_counter() - t0 - read_s,
            "tools": buf.getvalue().splitlines(), "hand": hand,
            "launches": trace.launches, "lost_launches": trace.lost, "records_without_launch": trace.orphans,
            "kernel_ms": te.kernel_us(trace, 0) / 1e3, "busy_ms": None if busy is None else busy / 1e3,
            "no_model_ms": sum(t for t, _ in unmodelled.values()) * 1e3, "modelled_rows": len(table),
            "largest_shares": shares[-5:], "l2_rows": sum(row.under == "L2" for row in table), "over": over,
            "card": trace.metadata.get("card"),
            "matmul_precision": trace.metadata.get("matmul_precision")}


def same_call(torch, op: str, args, root: Path) -> dict:
    """One hand op's call TRACE_SAME_CALL_ITERS times in a trace of its own
    (utils/profiling.trace, read by the roofline's rows) against device_ms
    of the same call: the reader's time a call within TRACE_SAME_CALL_TOL,
    where the trace lost no launch."""
    from sgam_neurips22_tpu_torch.roofline import rows
    from sgam_neurips22_tpu_torch.utils import profiling
    from sgam_neurips22_tpu_torch.utils import trace_events as te

    fn = getattr(torch.ops.sgam, op.split("::")[1])
    run = [a.clone() if torch.is_tensor(a) else a for a in args]
    for _ in range(3):
        fn(*run)
    torch.cuda.synchronize()
    with profiling.trace(str(root)):
        for _ in range(TRACE_SAME_CALL_ITERS):
            fn(*run)
    trace = te.from_file(te.newest(str(root)))
    mine = [r for r in rows(trace, 0)[0] if r.op == op]
    trace_ms = sum(r.time_s for r in mine) * 1e3 / TRACE_SAME_CALL_ITERS
    dev_ms = device_ms(torch, lambda: fn(*run), iters=TRACE_SAME_CALL_ITERS, warmup=1)
    out = {"op": op, "shapes": [list(a.shape) if torch.is_tensor(a) else a for a in args], "trace_ms": trace_ms,
           "device_ms": dev_ms, "lost_launches": trace.lost, "calls_in_trace": sum(r.calls for r in mine)}
    out["ratio"] = trace_ms / dev_ms if dev_ms else None
    out["ok"] = bool(trace.lost or (out["ratio"] is not None and abs(out["ratio"] - 1) <= TRACE_SAME_CALL_TOL
                                    and out["calls_in_trace"] == TRACE_SAME_CALL_ITERS))
    return out


def trace_tools_phase(torch, np, cpu_model16, seeds, failures, card) -> dict:
    """The port's trace tools on the card (`utils/profiling.trace`,
    `parse_trace`, `roofline`, over `utils/trace_events`): one bf16
    training step at TRAIN_BATCH (the forward, dQ, dK/dV, zbuffer_min and
    nearest_codeword) and 4 frames of bf16 CLEVR map re-query at batch 1
    (grid_accumulate, zbuffer_min, nearest_codeword), each traced after an
    untraced run whose hand-op inputs are kept (HandCalls). It fails unless
    all six hand ops appear with their kernels under them, each hand row's
    modelled work is roofline.hand_work at the kept inputs times its calls,
    no hand row's time is under its bound and no other row's under its L2
    floor (`roofline.Row.under`; the card's L2 holds at least the floor's
    L2_BYTES), and (where no launch was lost) each
    kept call's time in a trace of its own is within 5% of device_ms of
    the same call (each op's first kept call). Lost launches are counted
    and printed, never gated."""
    import tempfile

    from sgam_neurips22_tpu_torch.pipeline.scene_generation import InfiniteSceneGeneration
    from sgam_neurips22_tpu_torch.training.lpips import random_lpips
    from sgam_neurips22_tpu_torch.training.train_step import create_train_state, train_step
    from sgam_neurips22_tpu_torch.utils import profiling

    rep, captured = {"card": card}, {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        cfg = train_config(torch, TRAIN_BATCH, "bfloat16")
        state = create_train_state(cfg, seed=SEED, device="cuda")
        lpips = random_lpips(SEED + 2).cuda()
        batch = train_batch(torch, np, TRAIN_BATCH, "cuda")
        with HandCalls(torch) as spy:
            train_step(state, batch, lpips, cfg)
            torch.cuda.synchronize()
        captured.update(spy.calls)
        t0 = time.perf_counter()
        with profiling.trace(str(root / "train")):
            train_step(state, batch, lpips, cfg)
        rep["train_trace_seconds"] = time.perf_counter() - t0
        del state, lpips, batch
        torch.cuda.empty_cache()
        gen = InfiniteSceneGeneration(copy.deepcopy(cpu_model16), map_config("clevr-infinite", TRACE_MAP_GRID), seeds,
                                      device="cuda")
        with HandCalls(torch) as spy:
            gen.reset()
            gen.scene_expansion()
            torch.cuda.synchronize()
        captured.update(spy.calls)
        t0 = time.perf_counter()
        with profiling.trace(str(root / "map")):
            gen.reset()
            gen.scene_expansion()
        rep["map_trace_seconds"] = time.perf_counter() - t0
        del gen
        torch.cuda.empty_cache()
        traces = {"train": read_trace(root / "train"),
                  "map": read_trace(root / "map", TRACE_MAP_GRID[0] * TRACE_MAP_GRID[1] - 1)}
        work_ok, modelled = True, []
        for name, tr in traces.items():
            for row in tr["rows"]:
                if row.op not in HAND_OPS:
                    continue
                args = captured.get((row.op, row.dims))
                want = hand_call_work(torch, row.op, args) if args is not None else None
                ok = want is not None and (row.work.flops, row.work.bytes) == (want.flops * row.calls,
                                                                               want.bytes * row.calls)
                work_ok &= ok
                modelled.append({"trace": name, "op": row.op, "shapes": [list(d) for d in row.dims],
                                 "calls": row.calls, "ms": row.time_s * 1e3, "bound_ms": row.bound_s * 1e3,
                                 "bound_tc_ms": row.tc_bound_s * 1e3, "flops": row.work.flops,
                                 "bytes": row.work.bytes, "work_equals_formula": ok})
        rep["hand_rows"] = modelled
        present = {m["op"] for m in modelled}
        under = {op: sum(tr["hand"][op]["records"] for tr in traces.values()) for op in HAND_OPS}
        elsewhere = {op: sum(tr["hand"][op]["kernels_elsewhere"] for tr in traces.values()) for op in HAND_OPS}
        rep["hand_links"] = {op: [tr["hand"][op]["links"] for tr in traces.values()] for op in HAND_OPS}
        rep["attributed"] = {op: under[op] > 0 and elsewhere[op] == 0 for op in HAND_OPS}
        over = [(n, *x) for n, tr in traces.items() for x in tr["over"]]
        rep["l2_cache_bytes"] = torch.cuda.get_device_properties(0).L2_cache_size
        rep["traces"] = {n: {k: v for k, v in tr.items() if k not in ("rows", "hand")} for n, tr in traces.items()}
        first = {}  # each hand op's first kept call
        for (op, _), args in captured.items():
            first.setdefault(op, args)
        rep["same_call"] = [same_call(torch, op, args, root / f"same_{i}") for i, (op, args) in enumerate(first.items())]
    lost = {n: tr["lost_launches"] for n, tr in traces.items()}
    rep["lost_launches"] = {**lost, "same_call": sum(c["lost_launches"] for c in rep["same_call"])}
    rep["ok"] = (present == set(HAND_OPS) and all(rep["attributed"].values()) and work_ok and not over
                 and rep["l2_cache_bytes"] >= L2_BYTES and all(c["ok"] for c in rep["same_call"]))
    if not rep["ok"]:
        failures.append(f"trace_tools: ops present {sorted(present)}, attributed {rep['attributed']}, "
                        f"work equals the formula {work_ok}, rows under their bound {over}, the card's L2 "
                        f"{rep['l2_cache_bytes']} bytes (the floor's {L2_BYTES}), same-call "
                        f"{[(c['op'], c['shapes'], c['ratio'], c['lost_launches']) for c in rep['same_call']]}")
    return rep


# ---------------------------------------------------------------- serving
# (the port's serving layers and its offline evaluation through their entry points)
SERVE_GRID = (5, 5)  # serve.py's docstring example: --rows 5 --cols 5, 24 frames a request
SERVE_MAP_GRID = (3, 3)  # the map server: bench.py --config integration's grid, 8 frames a request
INCEPTION_FRAMES = 8
METRIC_RTOL = 1e-9  # float64 PSNR / SSIM, the card against the CPU
LPIPS_SCALE = 2.5  # VGG kernels scaled from random_lpips's, so that relu5_3 keeps its scale (~1e-6 unscaled)


def want_launches(frames: int) -> dict:
    """One z-buffer and one codeword launch a batch-1 frame, no flash attention."""
    return {"zbuffer_min": frames, "nearest_codeword": frames, "flash_attention_fwd": 0, "flash_attention_dq": 0,
            "flash_attention_dkv": 0}


def inference_step_phase(torch, counters, failures) -> dict:
    """`serving.build_inference_step` at the flagship width (f32, batch 1,
    256^2, 5 sources), given the config with flash_attention on as a
    training YAML sets it: one call on the card whose launches are counted
    (one z-buffer, one codeword, no flash attention: the step strips the
    field, as JAX's does), finite outputs, the time a call (CUDA events),
    and the same step on the CPU through the plain paths (TF32 off) under
    parity_step's gates: RGB at atol 1e-3, metric depth at 1e-3 relative
    (of max(depth, 1))."""
    import dataclasses

    from sgam_neurips22_tpu_torch.serving import build_inference_step, flagship_config

    cfg = flagship_config("clevr-infinite")
    cfg = dataclasses.replace(cfg, ddconfig=dataclasses.replace(cfg.ddconfig, flash_attention=True))
    fn, (model, batch, gen) = build_inference_step(cfg, device="cuda")
    fn(model, batch, gen)  # warm-up: cuDNN's algorithm search
    torch.cuda.synchronize()
    for f in counters:
        f.launches = 0
    rgb, depth = fn(model, batch, gen)
    torch.cuda.synchronize()
    launches = {f.__name__: f.launches for f in counters}
    ms = cuda_ms(torch, lambda: fn(model, batch, gen), iters=10, warmup=1)
    cpu_model = copy.deepcopy(model).cpu()
    t0 = time.perf_counter()
    rgb_c, depth_c = fn(cpu_model, {k: v.cpu() for k, v in batch.items()}, torch.Generator())
    cpu_s = time.perf_counter() - t0
    rep = {"shape": [list(rgb.shape), list(depth.shape)], "launches": launches, "ms": ms, "cpu_seconds": cpu_s,
           "finite": bool(torch.isfinite(rgb).all() and torch.isfinite(depth).all()),
           "rgb_max_abs_err": float((rgb.cpu() - rgb_c).abs().max()),
           "depth_max_rel_err": float(((depth.cpu() - depth_c).abs() / depth_c.abs().clamp(min=1.0)).max())}
    rep["ok"] = (rep["finite"] and launches == want_launches(1) and rep["rgb_max_abs_err"] <= 1e-3
                 and rep["depth_max_rel_err"] <= 1e-3)
    if not rep["ok"]:
        failures.append(f"inference_step: {rep}")
    return rep


# the fresh process of export_step: load the artifact with the model code
# unimportable, call it twice (warm-up, counted call), keep its outputs
EXPORT_BLOCKED = ("jax", "jaxlib", "sgam_neurips22_tpu", "sgam_neurips22_tpu_torch.models",
                  "sgam_neurips22_tpu_torch.pipeline", "sgam_neurips22_tpu_torch.serving",
                  "sgam_neurips22_tpu_torch.training")
EXPORT_LOAD_SIDE = """
import sys


class Blocked:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in {blocked!r}):
            raise ImportError(f"{{name}} is blocked")
        return None


sys.meta_path.insert(0, Blocked())
import time
import torch
from sgam_neurips22_tpu_torch.export_aot import load_step
from sgam_neurips22_tpu_torch.ops import attention, vq, zbuffer
path, root, device = sys.argv[1:]
t0 = time.perf_counter()
step = load_step(path, device=device)
load_s = time.perf_counter() - t0
inputs = [x.to(device) for x in torch.load(root + "/inputs.pt")]
step(*inputs)
if device == "cuda":
    torch.cuda.synchronize()
counters = (zbuffer.zbuffer_min, vq.nearest_codeword, attention.flash_attention_fwd, attention.flash_attention_dq,
            attention.flash_attention_dkv)
for f in counters:
    f.launches = 0
t0 = time.perf_counter()
rgb, depth = step(*inputs)
if device == "cuda":
    torch.cuda.synchronize()
call_s = time.perf_counter() - t0
imported = [m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in {blocked!r})]
torch.save({{"rgb": rgb.cpu(), "depth": depth.cpu(), "load_seconds": load_s, "call_seconds": call_s,
            "imported": imported, "launches": {{f.__name__: f.launches for f in counters}}}},
           root + "/fresh_" + device + ".pt")
"""
OVERHEAD_CALLS, OVERHEAD_ROUNDS = 200, 5


def op_overhead(torch) -> dict:
    """Host microseconds a call at the flythrough's shapes (z-buffer pix,
    key [1, 327680] over 256^2; codeword z [256, 256] against [16384,
    256]): `direct`, straight into the op's CUDA implementation (the
    launch path the wrapper called before the ops), and `op`, the public
    wrapper through `torch.ops.sgam`, in turns (direct, op, op, direct) x
    OVERHEAD_ROUNDS; each the host clock over OVERHEAD_CALLS calls after a
    synchronize and before the next (the host, not the card, bounds these
    loops). `op_us` is the median of op less that of direct."""
    from sgam_neurips22_tpu_torch.ops import vq, zbuffer

    g = torch.Generator(device="cuda").manual_seed(SEED)
    pix = torch.randint(0, H * W, (1, 5 * H * W), generator=g, device="cuda", dtype=torch.int32)
    key = torch.randint(0, 2**30, (1, 5 * H * W), generator=g, device="cuda", dtype=torch.int32)
    z = torch.randn((256, 256), generator=g, device="cuda")
    cb = torch.randn((16384, 256), generator=g, device="cuda")
    calls = {"zbuffer_min": (lambda: zbuffer.zbuffer_min_cuda(pix, key, H, W),
                             lambda: zbuffer.zbuffer_min(pix, key, H, W)),
             "nearest_codeword": (lambda: vq.nearest_codeword_cuda(z, cb), lambda: vq.nearest_codeword(z, cb))}
    out = {}
    for name, (direct, op) in calls.items():
        times = {"direct": [], "op": []}
        for _ in range(OVERHEAD_ROUNDS):
            for side, fn in (("direct", direct), ("op", op), ("op", op), ("direct", direct)):
                fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(OVERHEAD_CALLS):
                    fn()
                times[side].append((time.perf_counter() - t0) / OVERHEAD_CALLS * 1e6)
                torch.cuda.synchronize()
        med = {side: float(sorted(v)[len(v) // 2]) for side, v in times.items()}
        out[name] = {"direct_us": med["direct"], "op_us_total": med["op"], "op_us": med["op"] - med["direct"],
                     "direct_us_all": times["direct"], "op_us_all": times["op"]}
    zbuffer.zbuffer_min.launches = vq.nearest_codeword.launches = 0
    return out


def fresh_report(torch, fresh: dict, rgb, depth) -> dict:
    """A fresh process's outputs against (rgb, depth) on the CPU."""
    return {"load_seconds": fresh["load_seconds"], "call_seconds": fresh["call_seconds"],
            "launches": fresh["launches"], "imported": fresh["imported"],
            "bit_equal": bool(torch.equal(fresh["rgb"], rgb) and torch.equal(fresh["depth"], depth)),
            "rgb_max_abs_err": float((fresh["rgb"] - rgb).abs().max()),
            "depth_max_rel_err": float(((fresh["depth"] - depth).abs() / depth.abs().clamp(min=1.0)).max())}


def export_step_phase(torch, counters, failures) -> dict:
    """`export_aot.export_step` of the flagship clevr-infinite step (f32,
    256^2, 5 sources) traced on the card for the platforms cuda and cpu
    into a temporary directory (the artifact, ~290 MB, is not kept), loaded
    in this process and in two fresh ones that cannot import
    EXPORT_BLOCKED, one on the card and one on the CPU, each called after a
    warm-up call with its launches counted (on the card one z-buffer, one
    codeword, no flash attention; on the CPU none). In-process the program
    must equal the eager step bit for bit; the fresh processes' outputs
    must meet inference_step_phase's gates (RGB atol 1e-3, depth 1e-3
    relative of max(depth, 1)) against the eager step on their device (on
    the CPU: `build_inference_step(device="cpu")`, the same weights and
    batch), and whether they are bit-equal is reported (cuDNN may pick
    other algorithms in another process); the fresh processes load while
    this one does, and end before anything is timed. Also: export, load
    and fresh seconds, the artifact's MB, the graph's calls (and its dtype asserts),
    ms a call by CUDA events of the eager step, the loaded program and the
    loaded program under inference mode (as the eager step runs) in turns,
    the device time a call of the loaded program and of the eager step
    (device_ms), and the custom ops' host overhead (op_overhead)."""
    import tempfile

    from sgam_neurips22_tpu_torch.export_aot import INPUTS, export_step, load_step
    from sgam_neurips22_tpu_torch.serving import build_inference_step, flagship_config

    cfg = flagship_config("clevr-infinite")
    fn, (model, batch, gen) = build_inference_step(cfg, image_size=cfg.ddconfig.resolution * 4, device="cuda")
    inputs = [batch[name] for name in INPUTS]
    rgb_e, depth_e = fn(model, batch, gen)
    torch.cuda.synchronize()
    rep = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "flagship_step.pt2")
        t0 = time.perf_counter()
        exported = export_step(cfg, path, device="cuda", platforms=("cuda", "cpu"))
        rep["export_seconds"] = time.perf_counter() - t0
        rep["artifact_mb"] = os.path.getsize(path) / 1e6
        targets = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
        rep["graph_calls"] = len(targets)
        rep["graph_metadata_asserts"] = targets.count("aten._assert_tensor_metadata.default")
        del exported
        torch.save([x.cpu() for x in inputs], os.path.join(tmp, "inputs.pt"))
        # the fresh process loads while this one does (both mostly host
        # work); it is done before anything here is timed
        t_fresh = time.perf_counter()
        procs = {device: subprocess.Popen([sys.executable, "-c", EXPORT_LOAD_SIDE.format(blocked=EXPORT_BLOCKED),
                                           path, tmp, device], cwd=Path(__file__).resolve().parent,
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for device in ("cuda", "cpu")}
        try:
            fn_c, (model_c, batch_c, gen_c) = build_inference_step(cfg, image_size=cfg.ddconfig.resolution * 4,
                                                                   device="cpu")
            t0 = time.perf_counter()
            rgb_ce, depth_ce = fn_c(model_c, batch_c, gen_c)  # the CPU eager step
            rep["cpu_eager_seconds"] = time.perf_counter() - t0
            del model_c
            t0 = time.perf_counter()
            step = load_step(path)
            rep["load_seconds"] = time.perf_counter() - t0
            step(*inputs)  # warm-up
            torch.cuda.synchronize()
            for f in counters:
                f.launches = 0
            rgb, depth = step(*inputs)
            torch.cuda.synchronize()
            rep["launches"] = {f.__name__: f.launches for f in counters}
            rep["bit_equal"] = bool(torch.equal(rgb, rgb_e) and torch.equal(depth, depth_e))
            rep["finite"] = bool(torch.isfinite(rgb).all() and torch.isfinite(depth).all())
            errs = {device: proc.communicate(timeout=600)[1] for device, proc in procs.items()}
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        rep["fresh_seconds"] = time.perf_counter() - t_fresh
        bad = {device: (proc.returncode, errs[device][-3000:]) for device, proc in procs.items() if proc.returncode}
        if bad:
            failures.append(f"export_step: fresh processes failed: {bad}")
            return rep
        fresh = {device: torch.load(os.path.join(tmp, f"fresh_{device}.pt")) for device in procs}

        def inference_mode_call():
            with torch.inference_mode():
                return step(*inputs)

        calls = {"eager": lambda: fn(model, batch, gen), "exported": lambda: step(*inputs),
                 "exported_inference_mode": inference_mode_call}
        turns = {side: [] for side in calls}
        for side in ("eager", "exported", "exported_inference_mode", "exported_inference_mode", "exported", "eager"):
            turns[side].append(cuda_ms(torch, calls[side], iters=10, warmup=1))
        rep.update(ms=sum(turns["exported"]) / 2, eager_ms=sum(turns["eager"]) / 2,
                   inference_mode_ms=sum(turns["exported_inference_mode"]) / 2, ms_turns=turns,
                   device_ms=device_ms(torch, calls["exported"], iters=5, warmup=1),
                   eager_device_ms=device_ms(torch, calls["eager"], iters=5, warmup=1))
        del step
    rep["platforms"] = ["cuda", "cpu"]
    rep["fresh"] = fresh_report(torch, fresh["cuda"], rgb_e.cpu(), depth_e.cpu())
    rep["fresh_cpu"] = fresh_report(torch, fresh["cpu"], rgb_ce, depth_ce)
    rep["op_overhead"] = op_overhead(torch)
    no_launches = {name: 0 for name in want_launches(1)}
    rep["ok"] = (rep["finite"] and rep["bit_equal"] and rep["launches"] == want_launches(1)
                 and rep["fresh"]["launches"] == want_launches(1) and rep["fresh_cpu"]["launches"] == no_launches
                 and all(not f["imported"] and f["rgb_max_abs_err"] <= 1e-3 and f["depth_max_rel_err"] <= 1e-3
                         for f in (rep["fresh"], rep["fresh_cpu"])))
    if not rep["ok"]:
        failures.append(f"export_step: {rep}")
    return rep


def http(method: str, port: int, path: str, body=None) -> tuple:
    """(status, JSON body, seconds) of one request to the local server."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method)
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read()), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), time.perf_counter() - t0


def serve_argv(root: Path, grid, *flags) -> list:
    return ["--template_dir", str(root / "templates"), "--output_root", str(root / "serve_out"), "--rows",
            str(grid[0]), "--cols", str(grid[1]), "--resolution", str(H), *flags]


def serve_phase(torch, np, root: Path, counters, failures) -> dict:
    """The serve CLI's server (`serve.build_server`: the flagship model in
    bf16, the serving default, seeded random weights; clevr-infinite on
    serve.py's 5 x 5 example grid, 24 frames a request, from a seed template
    written as write_template does) behind `run_http_server` on
    127.0.0.1:0, driven over HTTP: /healthz; /warmup; two /generate
    without export and with rng_seed 3, whose depth checksums must be
    bit-equal, 24 frames and 24 z-buffer and codeword launches each; one
    with an output_dir under output_root (im_*.png and merged_pcds.ply);
    one whose output_dir escapes (500 naming output_root); an unknown path
    each way (404); /metrics counting the requests. Then one more request,
    profiled, for the device's idle share."""
    import threading

    from sgam_neurips22_tpu_torch import serve
    from sgam_neurips22_tpu_torch.serving import run_http_server

    write_template(np, np.random.default_rng(SEED + 13), root / "templates")
    t0 = time.perf_counter()
    server = serve.build_server(serve.parse_args(serve_argv(root, SERVE_GRID)))
    rep: dict = {"grid": list(SERVE_GRID), "dtype": server.model.cfg.ddconfig.compute_dtype,
                 "build_seconds": time.perf_counter() - t0}
    httpd = run_http_server(server, host="127.0.0.1", port=0, warmup=False)
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    checks, runs = {}, []
    out = root / "serve_out" / "exported"
    try:
        code, health, _ = http("GET", port, "/healthz")
        checks["healthz"] = code == 200 and health["status"] == "ok" and health["backend"] == "cuda"
        code, warm, rep["warmup_wall_seconds"] = http("POST", port, "/warmup", {})
        checks["warmup"] = code == 200
        rep["warmup_seconds"] = warm.get("warmup_seconds")
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            for f in counters:
                f.launches = 0
            code, res, wall = http("POST", port, "/generate", {"export": False, "rng_seed": 3})
            runs.append({"code": code, **res, "wall_seconds": wall,
                         "launches": {f.__name__: f.launches for f in counters}})
        rep["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        rep["requests"] = runs
        rep["launches"] = runs[0]["launches"]
        checks["generate"] = all(r["code"] == 200 and r["frames"] == FRAMES
                                 and r["launches"] == want_launches(FRAMES) for r in runs)
        checks["checksums_bit_equal"] = runs[0].get("depth_checksum") == runs[1].get("depth_checksum")
        rep["seconds_per_request"] = [r.get("seconds") for r in runs]
        rep["frames_per_s"] = [r.get("frames_per_second") for r in runs]
        code, res, wall = http("POST", port, "/generate", {"output_dir": str(out), "rng_seed": 3})
        files = sorted(os.listdir(out)) if out.is_dir() else []
        rep["export"] = {"code": code, "wall_seconds": wall, "unroll_seconds": res.get("seconds"),
                         "export_seconds": wall - res.get("seconds", 0.0), "files": len(files)}
        checks["export"] = (code == 200 and sum(f.startswith("im_") and f.endswith(".png") for f in files)
                            == SERVE_GRID[0] * SERVE_GRID[1] and "merged_pcds.ply" in files)
        code, err, _ = http("POST", port, "/generate", {"output_dir": str(root / "escape")})
        checks["escape_500"] = code == 500 and "output_root" in err.get("error", "")
        checks["unknown_404"] = http("GET", port, "/nope")[0] == 404 and http("POST", port, "/nope", {})[0] == 404
        code, metrics, _ = http("GET", port, "/metrics")
        rep["metrics"] = metrics
        # the warm-up, two requests, the export and the escape (which ran its unroll)
        checks["metrics"] = code == 200 and metrics["requests"] == 5 and metrics["frames"] == 4 * FRAMES
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    timed = min((r.get("seconds") or float("inf")) for r in runs) if runs else float("inf")
    prof = profile_unroll(torch, lambda: server.generate({"export": False}), FRAMES, timed)
    rep.update({k: v for k, v in prof.items() if k != "top"})
    rep["checks"] = checks
    rep["ok"] = all(checks.values())
    if not rep["ok"]:
        failures.append(f"serve: {checks} {rep}")
    rep["export_dir"] = str(out)
    return rep


def serve_map_phase(torch, np, root: Path, counters, failures) -> dict:
    """A map-requery server (`--use_rgbd_integration`, CLEVR 3 x 3, bf16):
    a warm-up, then two requests whose checksums must be equal (reset
    rebuilds the map for each), 8 z-buffer and codeword launches and 9 grid
    accumulations (the seed's and a frame's each) each."""
    from sgam_neurips22_tpu_torch import serve
    from sgam_neurips22_tpu_torch.ops.grid_accumulate import grid_accumulate

    counters = (*counters, grid_accumulate)
    server = serve.build_server(serve.parse_args(serve_argv(root, SERVE_MAP_GRID, "--use_rgbd_integration")))
    frames = SERVE_MAP_GRID[0] * SERVE_MAP_GRID[1] - 1
    want = {**want_launches(frames), "grid_accumulate": frames + 1}  # reset fuses the seed frame
    rep = {"grid": list(SERVE_MAP_GRID), "warmup": server.warmup()}
    runs = []
    for _ in range(2):
        for f in counters:
            f.launches = 0
        res = server.generate({"export": False})
        runs.append({**res, "launches": {f.__name__: f.launches for f in counters}})
    rep.update(requests=runs, launches=runs[0]["launches"], seconds_per_request=[r["seconds"] for r in runs],
               frames_per_s=[r["frames_per_second"] for r in runs])
    rep["ok"] = (runs[0]["depth_checksum"] == runs[1]["depth_checksum"]
                 and all(r["frames"] == frames and r["launches"] == want for r in runs))
    if not rep["ok"]:
        failures.append(f"serve_map: {rep}")
    return rep


def lpips_pickle(torch, np, path: Path) -> None:
    """A pickle of the JAX `init_lpips` tree layout (numpy leaves, HWIO
    kernels) of random_lpips(SEED)'s weights, the VGG kernels scaled by
    LPIPS_SCALE."""
    import pickle

    from sgam_neurips22_tpu_torch.training.lpips import random_lpips

    lp = random_lpips(SEED)

    def hwio(w):
        return w.detach().permute(2, 3, 1, 0).numpy()

    tree = {"convs": [{"weight": hwio(c.weight) * np.float32(LPIPS_SCALE), "bias": c.bias.detach().numpy()}
                      for c in lp.convs],
            "lins": [{"weight": hwio(lin.weight)} for lin in lp.lins]}
    with open(path, "wb") as f:
        pickle.dump(tree, f)


def evaluate_phase(torch, np, root: Path, gen_dir: str, failures) -> dict:
    """The evaluate CLI (`sgam_neurips22_tpu_torch.evaluate.main`) in-process
    on the frames that `serve` exported against a seeded noisy copy, with
    masks (one a frame, the first empty) and --fid (VGG weights from a
    pickle, lpips_pickle): on the card, then without --fid on the CPU; the
    card's PSNR, SSIM and their visible variants equal the CPU's within
    METRIC_RTOL, fid_vgg finite. Then InceptionV3's features of
    INCEPTION_FRAMES frames on the card against the CPU at rtol 5e-3 and
    atol 2e-4 (random weights drawn N(0, 2 / fan_in), so that each conv
    keeps its input's scale: init_inception's 0.1 N(0, 1) grows the
    features to ~1e11, where f32 rounding alone breaks an absolute gate)."""
    import math

    from sgam_neurips22_tpu_torch import evaluate
    from sgam_neurips22_tpu_torch.pipeline.png import write_png
    from sgam_neurips22_tpu_torch.training.data.io import load_rgb_u8
    from sgam_neurips22_tpu_torch.utils import fid, inception

    rng = np.random.default_rng(SEED + 17)
    gt_dir, mask_dir = root / "eval_gt", root / "eval_masks"
    gt_dir.mkdir()
    mask_dir.mkdir()
    names = sorted(n for n in os.listdir(gen_dir) if n.startswith("im_") and n.endswith(".png"))
    for i, name in enumerate(names):
        img = load_rgb_u8(os.path.join(gen_dir, name)).astype(np.float64)
        write_png(str(gt_dir / name), np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8))
        np.save(mask_dir / (name[:-4] + ".npy"), (rng.uniform(size=(H, W)) > 0.3) & (i > 0))
    lpips_pickle(torch, np, root / "lpips.pkl")
    args = [gen_dir, str(gt_dir), "--masks", str(mask_dir)]
    t0 = time.perf_counter()
    on_card = evaluate.main(args + ["--fid", "--lpips_weights", str(root / "lpips.pkl"), "--device", "cuda"])
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = evaluate.main(args + ["--device", "cpu"])
    cpu_s = time.perf_counter() - t0
    keys = ("psnr", "ssim", "psnr_visible", "ssim_visible")
    rel = {k: abs(on_card[k] - on_cpu[k]) / abs(on_cpu[k]) for k in keys}
    rep = {"frames": len(names), "on_card": on_card, "on_cpu": on_cpu, "rel_err_card_vs_cpu": rel,
           "card_seconds_with_fid": card_s, "cpu_seconds_without_fid": cpu_s}
    t0 = time.perf_counter()
    model = inception.init_inception(torch.Generator().manual_seed(SEED))
    g = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.Conv2d):
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=g) * math.sqrt(2.0 / mod.weight[0].numel()))
    frames = fid.load_image_dir(gen_dir)[:INCEPTION_FRAMES]
    feats_card = inception.inception_feature_fn(copy.deepcopy(model).cuda())(frames)
    torch.cuda.synchronize()
    rep["inception_card_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    feats_cpu = inception.inception_feature_fn(model)(frames)
    rep["inception_cpu_seconds"] = time.perf_counter() - t0
    rep["inception"] = {"shape": list(feats_card.shape), "max_abs": float(np.abs(feats_cpu).max()),
                        "max_abs_err": float(np.abs(feats_card - feats_cpu).max()),
                        "close": bool(np.allclose(feats_card, feats_cpu, rtol=5e-3, atol=2e-4))}
    rep["ok"] = (all(r <= METRIC_RTOL for r in rel.values()) and on_card["n_frames"] == on_cpu["n_frames"] == len(names)
                 and on_card["n_frames_visible"] == len(names) - 1 and math.isfinite(on_card["fid_vgg"])
                 and rep["inception"]["close"] and feats_card.shape == (INCEPTION_FRAMES, 2048))
    if not rep["ok"]:
        failures.append(f"evaluate: {rep}")
    return rep


def serving_phases(torch, np, counters, failures, card, paths: dict, report: dict) -> None:
    """inference_step, export_step, serve, evaluate (on serve's export) and
    serve_map, each emitted as it ends."""
    import tempfile

    t0 = time.perf_counter()
    step = inference_step_phase(torch, counters, failures)
    step.update(seconds=time.perf_counter() - t0, card=card)
    paths["inference_step"] = step["launches"]
    report["inference_step"] = step
    emit({"phase": "inference_step", **step})
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    exp = export_step_phase(torch, counters, failures)
    exp.update(seconds=time.perf_counter() - t0, card=card)
    paths["export_step"] = exp["launches"]
    report["export_step"] = exp
    emit({"phase": "export_step", **exp})
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        srv = serve_phase(torch, np, root, counters, failures)
        srv.update(seconds=time.perf_counter() - t0, card=card)
        paths["serve"] = srv["launches"]
        report["serve"] = srv
        emit({"phase": "serve", **srv})
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ev = evaluate_phase(torch, np, root, srv["export_dir"], failures)
        ev.update(seconds=time.perf_counter() - t0, card=card)
        report["evaluate"] = ev
        emit({"phase": "evaluate", **ev})
        t0 = time.perf_counter()
        smap = serve_map_phase(torch, np, root, counters, failures)
        smap.update(seconds=time.perf_counter() - t0, card=card)
        paths["serve_map"] = smap["launches"]
        report["serve_map"] = smap
        emit({"phase": "serve_map", **smap})
    torch.cuda.empty_cache()


# ------------------------------------------------------- the checkpoint tools
# (the port's parity_check and convert_exr through their CLIs' entry points)
PARITY_POOL_IMAGES = 64  # other seeded inputs whose latents (256 each) fill the k-means buffer beside the frame's
PARITY_OUTPUT_PEAK = 0.9  # the frame's largest decoded |RGB-D| after parity_weights scales decoder.conv_out
PARITY_FAULT = "decoder.conv_in.weight"  # the planted fault: this tensor scaled by 1.01 in a copy of the .ckpt
PARITY_WANT = {"zbuffer_min": 1, "nearest_codeword": 2, "flash_attention_fwd": 0, "flash_attention_dq": 0,
               "flash_attention_dkv": 0}  # a run on the card: the splat stage; the indices stage and the frame
DECODER_STAGES = {"decode", "frame_rgb", "frame_depth"}


def tie_margins(torch, z, cb) -> dict:
    """How near the latents z [P, D] lie to an f32 tie of their two nearest
    codewords in cb [K, D], in float64 on the card: each row's gap between
    its two best scores ||e||^2 - 2 z.e over the scale of their f32 sums
    (||e||^2 + 2 sum |z e|, ops.vq.near_ties_ok's), in units of 1e-6, the
    width near_ties_ok calls a tie."""
    z64, e64 = z.cuda().double(), cb.cuda().double()
    score = (e64 * e64).sum(1)[None] - 2 * z64 @ e64.T
    vals, idx = torch.topk(-score, 2, dim=1)
    (s1, s2), (i1, i2) = -vals.T, idx.T
    scale = torch.maximum(*((e64[i] ** 2).sum(1) + 2 * (z64 * e64[i]).abs().sum(1) for i in (i1, i2)))
    gap = ((s2 - s1) / scale / 1e-6).cpu()
    return {"rows": len(gap), "near_tie_rows": int((gap <= 1).sum()), "rows_within_10": int((gap <= 10).sum()),
            "min_gap": float(gap.min()), "median_gap": float(gap.median())}


def parity_weights(torch, np, cpu_model) -> tuple:
    """(state_dict, report): the seeded weights with two tensors set as a
    trained model's would be, for the tool's input frame (its seed-0
    random input).

    The codebook: rows of the model's own pre-quant latents, drawn by the
    trainer's k-means init (`training.kmeans.kmeans_init`) from a buffer
    that holds the frame's latents and those of PARITY_POOL_IMAGES other
    uniform inputs, as a codebook trained on data that holds the frame:
    each of the frame's latents lies on its codeword, as a trained model's
    sit near theirs. The report gives the frame's tie margins
    (`tie_margins`) on it and on a codebook drawn from the other inputs
    alone, where the latents lie between codewords (on an H100 a CPU
    recording then failed --compare on the card: one of 256 rows was an
    f32 near-tie). (The init codebook, uniform(+-1/16384), makes nearly
    every row a near-tie once ||z||^2 is in the sum, as in the oracle's.)

    decoder.conv_out, weight and bias, scaled so that the frame's decoded
    RGB-D lies within +-PARITY_OUTPUT_PEAK, inside the depth codec's [-1,
    1] as a trained decoder's disparity is: the seeded conv_out put
    disparity below -1, where the codec's 1 / x sent depth past 100 m and
    magnified f32 rounding past frame_depth's tolerance on an H100. The
    report gives the seeded layer's peak and depth range, and the scale."""
    from sgam_neurips22_tpu_torch.geometry.codec import get_codec
    from sgam_neurips22_tpu_torch.training.kmeans import kmeans_init

    model = copy.deepcopy(cpu_model).cuda().eval()
    rng = np.random.default_rng(SEED + 21)
    k, d = model.codebook.shape
    frame = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (1, H, W, 4)).astype(np.float32)).cuda()
    with torch.inference_mode():
        z = model.encode_prequant(frame).reshape(-1, d).cpu()
        rows = [model.encode_prequant(torch.from_numpy(rng.uniform(-1, 1, (16, H, W, 4)).astype(np.float32)).cuda())
                .reshape(-1, d).cpu() for _ in range(PARITY_POOL_IMAGES // 16)]
    others = torch.cat(rows)
    gen = torch.Generator().manual_seed(SEED)
    codebook = kmeans_init(torch.cat([z, others[:k - len(z)]]), k, gen).contiguous()
    rep = {"tie_margins": {"frame_in_buffer": tie_margins(torch, z, codebook),
                           "other_inputs_only": tie_margins(torch, z, kmeans_init(others, k, gen))}}
    with torch.no_grad():
        model.codebook.copy_(codebook)
    with torch.inference_mode():
        xr = model(frame, extrapolation_mask=torch.zeros((1, H, W, 1), dtype=torch.bool, device=frame.device),
                   topk=1).xrec[:, 0]
        depth = get_codec("clevr-infinite").decode(xr[..., 3])
    del model
    peak = float(xr.abs().max())
    scale = min(1.0, PARITY_OUTPUT_PEAK / peak)
    rep["conv_out"] = {"seeded_peak": peak, "seeded_frame_depth_range": [float(depth.min()), float(depth.max())],
                       "scale": scale}
    sd = {n: v.detach().clone() for n, v in cpu_model.state_dict().items()}
    sd["quantize.embedding.weight"] = codebook
    for n in ("decoder.conv_out.weight", "decoder.conv_out.bias"):
        sd[n] = sd[n] * scale
    return sd, rep


def parity_check_phase(torch, np, root: Path, cpu_model, counters, failures) -> dict:
    """`python -m sgam_neurips22_tpu_torch.parity_check` (its `run`) on a
    flagship-width .ckpt of `parity_weights` (the seeded weights with a
    latent-drawn codebook and an output layer in the codec's range, both
    reported): --record on the CPU, then on the card
    --compare against that recording, the default cross-check (the
    torch-functional oracle on the CPU), and --compare of a copy with
    PARITY_FAULT perturbed. Gates: the record, the compare and the
    cross-check exit 0, the planted fault exits 1 on decoder-side stages
    only (encode, pre_quant and indices within tolerance), and each card
    run launches PARITY_WANT. Each stage's max |diff| stands beside its
    largest magnitude."""
    from sgam_neurips22_tpu_torch import parity_check

    t0 = time.perf_counter()
    sd, weights = parity_weights(torch, np, cpu_model)
    ckpt, planted = root / "parity.ckpt", root / "planted.ckpt"
    torch.save({"state_dict": sd}, ckpt)
    sd[PARITY_FAULT] = sd[PARITY_FAULT] * 1.01
    torch.save({"state_dict": sd}, planted)
    del sd
    rep = {"setup_seconds": time.perf_counter() - t0, "planted_fault": f"{PARITY_FAULT} x 1.01", **weights,
           "runs": {}}
    golden = str(root / "golden.npz")
    for name, path, flags, want_code in (("record_cpu", ckpt, ["--record", golden, "--device", "cpu"], 0),
                                         ("compare", ckpt, ["--compare", golden], 0),
                                         ("cross_check", ckpt, [], 0),
                                         ("planted_compare", planted, ["--compare", golden], 1)):
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        code, out = parity_check.run([str(path), *flags])
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counters}
        stages = {stage: {"max_abs_diff": diff, "tol": tol, "ok": ok, "magnitude": out["magnitude"][stage]}
                  for stage, diff, tol, ok in out.get("rows", [])}
        run = {"exit_code": code, "seconds": time.perf_counter() - t0, "launches": launches, "stages": stages,
               "index_rows_differ": out.get("index_rows_differ"), "index_near_ties": out.get("index_near_ties")}
        failed = {s for s, r in run["stages"].items() if not r["ok"]}
        on_card = name != "record_cpu"
        run["ok"] = code == want_code and launches == (PARITY_WANT if on_card else dict.fromkeys(launches, 0))
        if name == "planted_compare":
            run["ok"] &= "decode" in failed and failed <= DECODER_STAGES
        rep["runs"][name] = run
        if not run["ok"]:
            failures.append(f"parity_check {name}: {run}")
    rep["ok"] = all(r["ok"] for r in rep["runs"].values())
    return rep


EXR_SIDE = 256
EXR_CASES = (("half_zip", "ZIP", "float16"), ("half_none", "NONE", "float16"), ("float_zip", "ZIP", "float32"),
             ("float_none", "NONE", "float32"))  # (file, compression, pixel type): Blender multilayer renders


def write_exr(np, path: Path, channels: dict, zip_lines: bool) -> None:
    """A scanline OpenEXR file (NONE, or ZIP in 16-line chunks) of
    {name: [H, W] float16 / float32}, from the file layout, independent of
    the port's reader."""
    import struct
    import zlib

    names = sorted(channels)
    h, w = channels[names[0]].shape
    kinds = {np.dtype("float16"): 1, np.dtype("float32"): 2}

    def attr(name, kind, value):
        return name.encode() + b"\0" + kind.encode() + b"\0" + struct.pack("<i", len(value)) + value

    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    chlist = b"".join(n.encode() + b"\0" + struct.pack("<iB3xii", kinds[channels[n].dtype], 0, 1, 1)
                      for n in names) + b"\0"
    header = (attr("channels", "chlist", chlist) + attr("compression", "compression", bytes([3 if zip_lines else 0]))
              + attr("dataWindow", "box2i", box) + attr("displayWindow", "box2i", box)
              + attr("lineOrder", "lineOrder", b"\0") + attr("pixelAspectRatio", "float", struct.pack("<f", 1))
              + attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
              + attr("screenWindowWidth", "float", struct.pack("<f", 1)) + b"\0")
    lines = 16 if zip_lines else 1
    chunks = []
    for y in range(0, h, lines):
        raw = b"".join(channels[n][r].astype(channels[n].dtype.newbyteorder("<")).tobytes()
                       for r in range(y, min(y + lines, h)) for n in names)
        if zip_lines:  # byte split, delta predictor, deflate (stored raw where that does not shrink it)
            b = np.frombuffer(raw, np.uint8)
            t = np.concatenate([b[0::2], b[1::2]]).astype(np.int64)
            t[1:] = (np.diff(t) + 384) % 256
            packed = zlib.compress(t.astype(np.uint8).tobytes())
            raw = packed if len(packed) < len(raw) else raw
        chunks.append(struct.pack("<ii", y, len(raw)) + raw)
    head = struct.pack("<ii", 20000630, 2) + header
    offsets, pos = [], len(head) + 8 * len(chunks)
    for c in chunks:
        offsets.append(pos)
        pos += len(c)
    path.write_bytes(head + struct.pack(f"<{len(chunks)}Q", *offsets) + b"".join(chunks))


EXR_CV2_CASES = (  # (file, compression, pixel type, rows, content): written by cv2 (OpenEXR inside), 256 wide
    ("piz_half", "PIZ", "HALF", 256, "smooth"), ("piz_float", "PIZ", "FLOAT", 200, "ramp"),
    ("pxr24_half", "PXR24", "HALF", 200, "smooth"), ("pxr24_float", "PXR24", "FLOAT", 256, "smooth"),
    # B44 and B44A: 203 rows end with a chunk of 11 and a row of 4x4 blocks with 3; "flat" has whole blocks of
    # one value (B44A's 3-byte blocks); "plinear" is the file cv2 wrote with each channel's pLinear flag set
    ("b44_half", "B44", "HALF", 203, "smooth"), ("b44a_half", "B44A", "HALF", 256, "flat"),
    ("b44_float", "B44", "FLOAT", 200, "smooth"), ("b44a_half_plinear", "B44A", "HALF", 203, "plinear"))


def float24(np, a):
    """OpenEXR's PXR24 rounding of float32 (floatToFloat24), as float32:
    the significand to 15 bits, half up in magnitude, truncated where that
    would overflow (these arrays hold no NaN or infinity)."""
    u = a.view(np.uint32).astype(np.int64)
    e, m = u & 0x7F800000, u & 0x007FFFFF
    i = ((e | m) + (m & 0x80)) >> 8
    i = np.where(i >= 0x7F8000, (e | m) >> 8, i)
    return ((((u & 0x80000000) >> 8) | i) << 8).astype(np.uint32).view(np.float32)


def exr_chunks(np, path: Path) -> list:
    """(first row, stored bytes, raw bytes) of each chunk of a scanline EXR."""
    import struct

    from sgam_neurips22_tpu_torch.pipeline import exr

    data = path.read_bytes()
    buf = exr._Bytes(data, str(path))
    hdr = exr.read_header(buf)
    x0, y0, x1, y1 = hdr.data_window
    w, h, lines = x1 - x0 + 1, y1 - y0 + 1, exr.LINES[hdr.compression]
    n = (h + lines - 1) // lines
    out = []
    for off in struct.unpack(f"<{n}Q", buf.take(8 * n)):
        y, size = struct.unpack_from("<ii", data, off)
        rows = min(lines, h - (y - y0))
        out.append((y - y0, size, rows * w * sum(c.dtype.itemsize for c in hdr.channels)))
    return out


def with_plinear(data: bytes) -> bytes:
    """The EXR file `data` with every channel's pLinear flag set in its
    header's channel list (name, then pixel type, pLinear, 3 reserved
    bytes and the two samplings)."""
    out = bytearray(data)
    at = data.index(b"channels\0chlist\0") + len(b"channels\0chlist\0") + 4
    while out[at]:
        at = out.index(b"\0", at) + 1
        out[at + 4] = 1
        at += 16
    return bytes(out)


# DWAA / DWAB files, 256 wide: (file, compression, channels, pixel type, rows, level, pLinear); the rows end in
# a partial chunk (DWAA's 32 lines, DWAB's 256) and a partial row of 8x8 blocks; level 20000 leaves most blocks
# DC-only, as a high dwaCompressionLevel does
EXR_DWA_CASES = (
    ("dwaa_y_half", "DWAA", "Y", "HALF", 203, 45, False),
    ("dwaa_y_half_plinear", "DWAA", "Y", "HALF", 203, 45, True),
    ("dwaa_bgr_half", "DWAA", "BGR", "HALF", 203, 45, False),
    ("dwaa_bgra_half", "DWAA", "BGRA", "HALF", 203, 45, False),
    ("dwaa_bgr_float", "DWAA", "BGR", "FLOAT", 200, 45, False), ("dwab_bgr_half", "DWAB", "BGR", "HALF", 300, 45, False),
    ("dwab_bgra_half_high", "DWAB", "BGRA", "HALF", 300, 20000, False))
DWA_ZIGZAG = (0, 1, 5, 6, 14, 15, 27, 28, 2, 4, 7, 13, 16, 26, 29, 42, 3, 8, 12, 17, 25, 30, 41, 43, 9, 11, 18, 24,
              31, 40, 44, 53, 10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60, 21, 34, 37, 47, 50, 56,
              59, 61, 35, 36, 48, 49, 57, 58, 62, 63)  # zig-zag index of [row * 8 + col]


def huffman_stream(np, words) -> bytes:
    """OpenEXR's Huffman coding of 16-bit words (ImfHuf's hufCompress):
    code lengths of a Huffman code over the words and a run symbol one
    past the largest, canonical codes (longer codes lower), the lengths
    packed 6 bits each (59-62 and 63 + 8 bits for runs of zero lengths),
    then the codes MSB first, a word repeated 2-255 times more sent once
    with the run symbol and an 8-bit count where that is shorter."""
    import heapq
    import struct

    values, counts = np.unique(np.asarray(words, np.int64), return_counts=True)
    im, run = int(values[0]), int(values[-1]) + 1
    freq = dict(zip(values.tolist(), counts.tolist())) | {run: 1}
    heap = [(f, i, [sym]) for i, (sym, f) in enumerate(sorted(freq.items()))]
    heapq.heapify(heap)
    length, tie = dict.fromkeys(freq, 0), len(heap)
    while len(heap) > 1:
        f1, _, a = heapq.heappop(heap)
        f2, _, b = heapq.heappop(heap)
        for sym in a + b:
            length[sym] += 1
        heapq.heappush(heap, (f1 + f2, tie, a + b))
        tie += 1
    n_of = [0] * 60
    for n in length.values():
        n_of[n] += 1
    start, c = [0] * 60, 0
    for n in range(58, 0, -1):
        start[n], c = c, (c + n_of[n]) >> 1
    code = {}
    for sym in sorted(length):
        code[sym] = (start[length[sym]], length[sym])
        start[length[sym]] += 1

    class Bits:
        def __init__(self):
            self.acc, self.n, self.out = 0, 0, bytearray()

        def put(self, v, n):
            self.acc, self.n = (self.acc << n) | v, self.n + n
            while self.n >= 8:
                self.n -= 8
                self.out.append((self.acc >> self.n) & 0xFF)
            self.acc &= (1 << self.n) - 1

        def bytes(self):
            return bytes(self.out) + (bytes([(self.acc << (8 - self.n)) & 0xFF]) if self.n else b"")

    table, sym = Bits(), im
    while sym <= run:
        if sym in length:
            table.put(length[sym], 6)
            sym += 1
            continue
        k = 1
        while sym + k <= run and sym + k not in length and k < 261:
            k += 1
        if k == 1:
            table.put(0, 6)
        elif k < 6:
            table.put(59 + k - 2, 6)
        else:
            table.put(63, 6)
            table.put(k - 6, 8)
        sym += k
    data, seq, i = Bits(), np.asarray(words).tolist(), 0
    while i < len(seq):
        j = i
        while j + 1 < len(seq) and seq[j + 1] == seq[i] and j - i < 255:
            j += 1
        (cw, n), (rc, rn), reps = code[seq[i]], code[run], j - i
        if n + rn + 8 < n * reps:
            data.put(cw, n)
            data.put(rc, rn)
            data.put(reps, 8)
        else:
            for _ in range(reps + 1):
                data.put(cw, n)
        i = j + 1
    n_bits = len(data.out) * 8 + data.n
    tab = table.bytes()
    return struct.pack("<5I", im, run, len(tab), n_bits, 0) + tab + data.bytes()


def dwa_chunk(np, planes: dict, level: float, plinear: bool) -> bytes:
    """A DWA chunk (OpenEXR's DwaCompressor layout, version 2 with its
    default rules) of `planes` {name: [n, w] float16 / float32}, names Y
    or B, G, R (lossy) and A (run-length coded): each lossy channel taken
    to OpenEXR's nonlinear form (x^(1/2.2) to 1, 1 + ln(x) / 2.2 past it)
    unless a Y channel is pLinear, R, G, B to Y'CbCr (Rec. 709), 8x8 blocks
    (edges repeated) through a float64 DCT, the AC rounded to steps of
    level * 1e-4 * (1 + u + v) and all to half (no -0); AC words run-length and
    Huffman-coded, DC words byte-split, delta-predicted and deflated, A's
    byte planes run-length coded and deflated."""
    import struct
    import zlib

    names = sorted(planes)
    n, w = planes[names[0]].shape
    lossy = [c for c in ("R", "G", "B") if c in planes] or ["Y"]

    def nonlinear(x):
        x = x.astype(np.float16).astype(np.float64)
        a = np.abs(x)
        with np.errstate(divide="ignore"):
            return np.sign(x) * np.where(a <= 1, a ** (1 / 2.2), 1 + np.log(np.maximum(a, 1)) / 2.2)

    comps = [planes["Y"].astype(np.float16).astype(np.float64) if plinear else nonlinear(planes["Y"])] \
        if lossy == ["Y"] else [nonlinear(planes[c]) for c in "RGB"]
    if len(comps) == 3:
        r, g, b = comps
        y = 0.2126 * r + 0.7152 * g + 0.0722 * b
        comps = [y, (b - y) / 1.8556, (r - y) / 1.5747]
    nby, nbx = -(-n // 8), -(-w // 8)
    k = np.arange(8)
    basis = np.where(k[:, None] == 0, np.sqrt(1 / 8), 0.5 * np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16))
    step = level * 1e-4 * (1 + k[:, None] + k[None, :])
    zig = np.empty(64, np.int64)
    zig[list(DWA_ZIGZAG)] = np.arange(64)
    blocks = []
    for comp in comps:
        pad = np.pad(comp, ((0, nby * 8 - n), (0, nbx * 8 - w)), mode="edge").reshape(nby, 8, nbx, 8)
        coef = np.einsum("ux,axby,vy->abuv", basis, pad, basis)
        q = (np.where((k[:, None] + k[None, :]) == 0, coef, np.round(coef / step) * step) + 0.0).astype(np.float16)
        blocks.append(q.reshape(nby * nbx, 64)[:, zig].view(np.uint16))  # zig-zag order
    ac = []
    for i in range(nby * nbx):  # block after block, each block's channels in turn; OpenEXR's rleAc
        for comp in blocks:
            bits, j = comp[i].tolist(), 1
            while j < 64:
                if bits[j]:
                    ac.append(bits[j])
                    j += 1
                    continue
                run = 1
                while j + run < 64 and not bits[j + run]:
                    run += 1
                ac.append(0 if run == 1 else 0xFF00 if j + run == 64 else 0xFF00 | run)
                j += run
    dc = np.concatenate([comp[:, 0] for comp in blocks]).astype("<u2").view(np.uint8)
    t = np.concatenate([dc[0::2], dc[1::2]]).astype(np.int64)
    t[1:] = (np.diff(t) + 384) % 256
    dc_bytes = zlib.compress(t.astype(np.uint8).tobytes())
    ac_bytes = huffman_stream(np, ac)
    raw_rle = b"".join(np.ascontiguousarray(planes[c]).view(np.uint8).reshape(-1, planes[c].dtype.itemsize).T
                       .tobytes() for c in names if c == "A")
    rle = bytearray()
    i = 0
    while i < len(raw_rle):  # runs of 3-128 equal bytes as (n - 1, byte), other stretches as (-n, bytes)
        j = i
        while j + 1 < len(raw_rle) and raw_rle[j + 1] == raw_rle[i] and j + 1 - i < 128:
            j += 1
        if j - i >= 2:
            rle += struct.pack("bB", j - i, raw_rle[i])
            i = j + 1
            continue
        j = i
        while j < len(raw_rle) and j - i < 127 and not (j + 2 < len(raw_rle) and raw_rle[j] == raw_rle[j + 1] ==
                                                          raw_rle[j + 2]):
            j += 1
        rle += struct.pack("b", i - j) + raw_rle[i:j]
        i = j
    rle_bytes = zlib.compress(bytes(rle)) if raw_rle else b""
    rules = b"".join(f.encode() + b"\0" + bytes([((c + 1) << 4) | (s << 2), t]) for f, s, t, c in (
        [(f, 1, t, i) for i, f in enumerate("RGB") for t in (1, 2)] + [(f, 1, t, -1) for f in ("Y", "BY", "RY")
                                                                      for t in (1, 2)]
        + [("A", 2, t, -1) for t in (0, 1, 2)]))
    counts = struct.pack("<11Q", 2, 0, 0, len(ac_bytes), len(dc_bytes), len(rle_bytes), len(rle) if raw_rle else 0,
                         len(raw_rle), len(ac), len(dc) // 2, 0)
    return counts + struct.pack("<H", len(rules) + 2) + rules + ac_bytes + dc_bytes + rle_bytes


def write_dwa(np, path: Path, planes: dict, compression: str, level: float, plinear: bool) -> None:
    """A scanline DWAA (32-line chunks) or DWAB (256) file of `planes`
    ({name: [H, W] float16 / float32}), every channel pLinear where
    `plinear`; a chunk that does not shrink is stored raw, as OpenEXR does."""
    import struct

    names = sorted(planes)
    h, w = planes[names[0]].shape
    kinds = {np.dtype("float16"): 1, np.dtype("float32"): 2}

    def attr(name, kind, value):
        return name.encode() + b"\0" + kind.encode() + b"\0" + struct.pack("<i", len(value)) + value

    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    chlist = b"".join(c.encode() + b"\0" + struct.pack("<iB3xii", kinds[planes[c].dtype], int(plinear), 1, 1)
                      for c in names) + b"\0"
    header = (attr("channels", "chlist", chlist) + attr("compression", "compression", bytes([8 if compression ==
                                                                                              "DWAA" else 9]))
              + attr("dataWindow", "box2i", box) + attr("displayWindow", "box2i", box)
              + attr("lineOrder", "lineOrder", b"\0") + attr("pixelAspectRatio", "float", struct.pack("<f", 1))
              + attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
              + attr("screenWindowWidth", "float", struct.pack("<f", 1)) + b"\0")
    lines = 32 if compression == "DWAA" else 256
    chunks = []
    for y in range(0, h, lines):
        part = {c: planes[c][y:y + lines] for c in names}
        raw = b"".join(part[c][r].tobytes() for r in range(len(part[names[0]])) for c in names)
        data = dwa_chunk(np, part, level, plinear)
        data = data if len(data) < len(raw) else raw
        chunks.append(struct.pack("<ii", y, len(data)) + data)
    head = struct.pack("<ii", 20000630, 2) + header
    offsets, pos = [], len(head) + 8 * len(chunks)
    for c in chunks:
        offsets.append(pos)
        pos += len(c)
    path.write_bytes(head + struct.pack(f"<{len(chunks)}Q", *offsets) + b"".join(chunks))


def dwa_chunk_data(np, path: Path) -> list:
    """The stored bytes of each chunk of a scanline single-part file
    (b"" where its offset is 0, as for a chunk never written)."""
    import struct

    from sgam_neurips22_tpu_torch.pipeline import exr

    data = path.read_bytes()
    buf = exr._Bytes(data, str(path))
    hdr = exr.read_header(buf)
    n = -(-(hdr.data_window[3] - hdr.data_window[1] + 1) // exr.LINES[hdr.compression])
    out = []
    for off in struct.unpack(f"<{n}Q", buf.take(8 * n)):
        size = struct.unpack_from("<i", data, off + 4)[0] if off else 0
        out.append(data[off + 8:off + 8 + size] if off else b"")
    return out


def dwa_block_stats(np, path: Path) -> dict:
    """Blocks of the file's lossy channels, and how many carry no AC (the
    DC-only shortcut), from the AC words of each compressed chunk."""
    import struct
    import zlib

    from sgam_neurips22_tpu_torch.pipeline import exr

    out = {"blocks": 0, "dc_only": 0}
    for c, (_, size, raw) in zip(dwa_chunk_data(np, path), exr_chunks(np, path)):
        if size >= raw:
            continue
        counts = struct.unpack_from("<11Q", c)
        at = 88 + struct.unpack_from("<H", c, 88)[0] + counts[2]
        n_dc = len(zlib.decompress(c[at + counts[3]:at + counts[3] + counts[4]])) // 2
        _, last, _ = exr._dwa_ac_blocks(exr.huf_words(c[at:at + counts[3]], counts[8]), 0, n_dc, str(path))
        out["blocks"] += n_dc
        out["dc_only"] += int((last == 0).sum())
    return out


def cv2_dwa_cases(np, root: Path, failures) -> dict:
    """EXR_DWA_CASES, written by `write_dwa` (this machine's cv2 writes
    DWA files with no chunks: its OpenEXR 2.3.0 leaves the offset table
    zero, which is probed and recorded) and read by OpenEXR's own decoder
    (cv2.imread) and by the port's `read_exr` with both Huffman decoders:
    bit-equal, every chunk stored compressed, and DC-only blocks present
    at the high level. A cv2 that cannot read the files fails the phase.
    Then the seconds of `read_exr` on a 256^2 BGRA HALF file as DWAA
    (written here), ZIP and PIZ (written by cv2), recorded, not gated."""
    import struct

    os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
    import cv2

    from sgam_neurips22_tpu_torch.pipeline import exr

    exr._piz_lib()  # built before anything is timed
    rng = np.random.default_rng(SEED + 31)
    out = {"cases": {}}
    probe = root / "cv2_dwaa.exr"
    cv2.imwrite(str(probe), np.ones((64, 64, 3), np.float32), [cv2.IMWRITE_EXR_COMPRESSION,
                                                              cv2.IMWRITE_EXR_COMPRESSION_DWAA])
    try:  # OpenCV 4.13's OpenEXR 2.3.0 returns True and leaves every chunk offset 0
        out["cv2_writes_dwaa"] = all(dwa_chunk_data(np, probe))
    except (ValueError, struct.error) as e:
        out["cv2_writes_dwaa"] = f"no ({e})"
    for name, compression, chans, ptype, rows, level, plinear in EXR_DWA_CASES:
        yy, xx = np.mgrid[0:rows, 0:EXR_SIDE]
        planes = {}
        for i, c in enumerate(chans):  # smooth fields with noise, past 1 (the log branch), a dark corner
            f = 0.6 + 0.5 * np.sin(yy / (6.0 + i) + i) * np.cos(xx / (9.0 - i)) + rng.uniform(0, 0.02, (rows, EXR_SIDE))
            f = f * np.where((yy < 40) & (xx < 60), 0.01, 1.0) * (1.5 if c == "R" else 1.0)
            planes[c] = np.clip(f, 0, 1).astype(np.float16) if c == "A" else f.astype(
                np.float16 if ptype == "HALF" else np.float32)
        path = root / f"{name}.exr"
        write_dwa(np, path, planes, compression, level, plinear)
        theirs = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        case = {"compression": compression, "channels": chans, "pixel_type": ptype, "rows": rows, "level": level,
                "bytes": path.stat().st_size, "cv2_read": theirs is not None}
        for native in (True, False):
            t0 = time.perf_counter()
            hdr, got = exr.read_exr(str(path), native=native)
            case["native_seconds" if native else "numpy_seconds"] = time.perf_counter() - t0
            ours = got["Y"].astype(np.float32) if chans == "Y" else np.stack(
                [got[c].astype(np.float32) for c in chans], axis=2)
            case["equal_cv2" if native else "numpy_equal_cv2"] = bool(
                theirs is not None and hdr.compression == compression
                and np.array_equal(ours.view(np.uint32), theirs.view(np.uint32)))
        chunks = exr_chunks(np, path)
        case["chunks"], case["compressed_chunks"] = len(chunks), sum(size < raw for _, size, raw in chunks)
        case["plinear_channels"] = sum(c.linear for c in hdr.channels)
        case.update(dwa_block_stats(np, path))
        case["max_abs_vs_written"] = float(np.max(np.abs(ours - (planes["Y"] if chans == "Y" else np.stack(
            [planes[c] for c in chans], axis=2)).astype(np.float32))))
        case["ok"] = bool(case["equal_cv2"] and case["numpy_equal_cv2"] and case["compressed_chunks"] == len(chunks)
                          and case["plinear_channels"] == len(chans) * plinear
                          and (level < 1000 or case["dc_only"] > case["blocks"] // 2))
        out["cases"][name] = case
    yy, xx = np.mgrid[0:EXR_SIDE, 0:EXR_SIDE]
    img = np.stack([0.6 + 0.5 * np.sin(yy / (6.0 + i) + i) * np.cos(xx / 9.0) for i in range(4)], axis=2)
    img = (img + rng.uniform(0, 0.02, img.shape)).astype(np.float32)
    img[..., 3] = np.clip(img[..., 3], 0, 1)
    write_dwa(np, root / "time_dwaa.exr", {c: img[..., i].astype(np.float16) for i, c in enumerate("BGRA")},
              "DWAA", 45, False)
    for codec in ("ZIP", "PIZ"):
        cv2.imwrite(str(root / f"time_{codec.lower()}.exr"), img, [
            cv2.IMWRITE_EXR_TYPE, cv2.IMWRITE_EXR_TYPE_HALF, cv2.IMWRITE_EXR_COMPRESSION,
            getattr(cv2, f"IMWRITE_EXR_COMPRESSION_{codec}")])
    out["read_seconds_256_bgra_half"] = {}
    for codec in ("dwaa", "zip", "piz"):
        for native in (True, False):  # the C++ Huffman decoder's best of 3, the numpy one's once
            best = float("inf")
            for _ in range(3 if native else 1):
                t0 = time.perf_counter()
                exr.read_exr(str(root / f"time_{codec}.exr"), native=native)
                best = min(best, time.perf_counter() - t0)
            out["read_seconds_256_bgra_half"][f"{codec}{'' if native else '_numpy'}"] = best
        out["read_seconds_256_bgra_half"][f"{codec}_bytes"] = (root / f"time_{codec}.exr").stat().st_size
    out["ok"] = all(c["ok"] for c in out["cases"].values()) and len(out["cases"]) == len(EXR_DWA_CASES)
    return out


def cv2_exr_cases(np, root: Path, failures) -> dict:
    """EXR_CV2_CASES written by cv2.imwrite and read by the port
    (`read_exr`, native and numpy PIZ decoders) against cv2.imread. Every
    chunk of a HALF file is stored compressed, and none of a B44 FLOAT
    file (B44 keeps FLOAT raw, which does not shrink a chunk)."""
    os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
    import cv2

    from sgam_neurips22_tpu_torch.pipeline import exr

    exr._piz_lib()  # built before anything is timed
    rng = np.random.default_rng(SEED + 29)
    out = {}
    for name, compression, ptype, rows, content in EXR_CV2_CASES:
        if content == "ramp":  # consecutive float bit patterns: more than 2^14 words a chunk, and they compress
            a = (0x3F800000 + np.arange(rows * EXR_SIDE * 3, dtype=np.uint32)).view(np.float32)
            a = a.reshape(rows, EXR_SIDE, 3)
        else:
            yy, xx = np.mgrid[0:rows, 0:EXR_SIDE]
            a = np.stack([0.5 + 0.4 * np.sin(yy / (5.0 + c) + c) * np.cos(xx / 7.0) for c in range(3)], axis=2)
            a = (a + rng.uniform(0, 0.01, a.shape)).astype(np.float32)
            if content == "flat":
                a[:64, :128], a[128:192, 64:256] = 0.75, 0.25
        path = root / f"{name}.exr"
        if not cv2.imwrite(str(path), a, [cv2.IMWRITE_EXR_TYPE, getattr(cv2, f"IMWRITE_EXR_TYPE_{ptype}"),
                                          cv2.IMWRITE_EXR_COMPRESSION,
                                          getattr(cv2, f"IMWRITE_EXR_COMPRESSION_{compression}")]):
            failures.append(f"convert_exr: cv2 could not write {name}")
            continue
        if content == "plinear":
            path.write_bytes(with_plinear(path.read_bytes()))
        theirs = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        case = {"compression": compression, "pixel_type": ptype, "rows": rows, "bytes": path.stat().st_size}
        for native in (True, False):
            t0 = time.perf_counter()
            hdr, planes = exr.read_exr(str(path), native=native)
            case["native_seconds" if native else "numpy_seconds"] = time.perf_counter() - t0
            ours = np.stack([planes[c].astype(np.float32) for c in "BGR"], axis=2)
            case["equal_cv2" if native else "numpy_equal_cv2"] = bool(
                hdr.compression == compression and np.array_equal(ours.view(np.uint32), theirs.view(np.uint32)))
        case["plinear_channels"] = sum(c.linear for c in hdr.channels)
        chunks = exr_chunks(np, path)
        case["chunks"], case["compressed_chunks"] = len(chunks), sum(size < raw for _, size, raw in chunks)
        if compression.startswith("B44"):  # HALF chunks all shrink; B44 keeps FLOAT raw, so none shrinks
            shrunk = case["compressed_chunks"] == (len(chunks) if ptype == "HALF" else 0)
        else:
            shrunk = case["compressed_chunks"] > 0
        ok = (case["equal_cv2"] and case["numpy_equal_cv2"] and shrunk
              and case["plinear_channels"] == 3 * (content == "plinear"))
        if ptype == "FLOAT" and compression == "PXR24":
            case["equal_float24"] = bool(np.array_equal(theirs.view(np.uint32), float24(np, a).view(np.uint32)))
            ok = ok and case["equal_float24"]
        if compression == "PIZ":  # the modular wavelet runs where a chunk holds more than 2^14 distinct words
            words = a.astype(np.float16 if ptype == "HALF" else np.float32).view(np.uint16).reshape(rows, -1)
            case["modular_compressed_chunks"] = sum(
                size < raw and len(np.union1d(words[y:y + 32], [0])) > 1 << 14 for y, size, raw in chunks)
            ok = ok and (content != "ramp" or case["modular_compressed_chunks"] > 0)
        case["ok"] = bool(ok)
        out[name] = case
    return out


def convert_exr_phase(np, root: Path, failures) -> dict:
    """`python -m sgam_neurips22_tpu_torch.convert_exr` (its main) on this
    machine's host: EXR_CASES, each a 256^2 Blender multilayer render
    ("View Layer.Combined.R/G/B/A", "View Layer.Depth.Z", "View
    Layer.IndexOB.X") from seeded arrays, written by `write_exr`; the
    outputs read back must equal the arrays (FLOAT bit for bit, HALF as
    np.float16 rounds them) and the PNGs `linear_to_srgb` of them. Whether
    this machine has the OpenEXR package or an EXR-capable cv2 is probed,
    and where one is there the port's reader is held against it."""
    from sgam_neurips22_tpu_torch import convert_exr
    from sgam_neurips22_tpu_torch.pipeline.exr import read_exr
    from sgam_neurips22_tpu_torch.pipeline.png import read_png

    src, out = root / "renders", root / "converted"
    src.mkdir()
    rng = np.random.default_rng(SEED + 23)
    arrays = {}
    for name, compression, dtype in EXR_CASES:
        ch = {f"View Layer.Combined.{c}": rng.uniform(0, 1.2, (EXR_SIDE, EXR_SIDE)) for c in "RGB"}
        ch["View Layer.Combined.A"] = np.ones((EXR_SIDE, EXR_SIDE))
        ch["View Layer.Depth.Z"] = rng.uniform(7, 16, (EXR_SIDE, EXR_SIDE))
        ch["View Layer.IndexOB.X"] = rng.integers(0, 9, (EXR_SIDE, EXR_SIDE)).astype(np.float64)
        arrays[name] = {k: v.astype(dtype) for k, v in ch.items()}
        write_exr(np, src / f"{name}.exr", arrays[name], compression == "ZIP")
    t0 = time.perf_counter()
    convert_exr.main([str(src), "--out", str(out)])
    rep = {"files": [c[0] for c in EXR_CASES], "side": EXR_SIDE, "convert_seconds": time.perf_counter() - t0,
           "cases": {}}
    for i, (name, compression, dtype) in enumerate(sorted(EXR_CASES)):
        a = {k.split(".", 1)[1]: v.astype(np.float32) for k, v in arrays[name].items()}
        rgb = np.stack([a[f"Combined.{c}"] for c in "RGB"], axis=2)
        srgb = np.clip(convert_exr.linear_to_srgb(rgb) * 255.0, 0, 255).astype(np.uint8)
        case = {"compression": compression, "pixel_type": dtype,
                "depth_equal": np.array_equal(np.load(out / f"dm_{i:05d}.npy"), a["Depth.Z"]),
                "instance_equal": np.array_equal(np.load(out / f"in_{i:05d}.npy"), a["IndexOB.X"]),
                "png_equal": np.array_equal(read_png(str(out / f"im_{i:05d}.png")), srgb)}
        case["ok"] = case["depth_equal"] and case["instance_equal"] and case["png_equal"]
        rep["cases"][name] = case
    probe = src / f"{EXR_CASES[0][0]}.exr"
    _, ours = read_exr(str(probe))
    try:
        import Imath
        import OpenEXR

        f = OpenEXR.InputFile(str(probe))
        flt = Imath.PixelType(Imath.PixelType.FLOAT)
        rep["openexr"] = all(np.array_equal(np.frombuffer(f.channel(n, flt), np.float32).reshape(EXR_SIDE, EXR_SIDE),
                                            v.astype(np.float32)) for n, v in ours.items())
    except ImportError:
        rep["openexr"] = "not installed"
    plain = {c: ours[f"View Layer.Combined.{c}"] for c in "RGB"}  # OpenCV reads single-layer files only
    write_exr(np, root / "probe_rgb.exr", plain, True)
    try:
        os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
        import cv2

        img = cv2.imread(str(root / "probe_rgb.exr"), cv2.IMREAD_UNCHANGED)
        rep["cv2_exr"] = ("no EXR codec" if img is None else
                          bool(np.array_equal(img, np.stack([plain[c].astype(np.float32) for c in "BGR"], axis=2))))
        rep["cv2_cases"] = cv2_exr_cases(np, root, failures)
        rep["dwa"] = cv2_dwa_cases(np, root, failures)
    except ImportError:
        rep["cv2_exr"] = "cv2 not installed"
    except Exception as e:  # an OpenCV build without the codec raises from imread or imwrite
        rep["cv2_exr"] = f"no EXR codec ({type(e).__name__}: {e})"
    cv2_ok = [c["ok"] for c in rep.get("cv2_cases", {}).values()]
    rep["ok"] = (all(c["ok"] for c in rep["cases"].values()) and rep["openexr"] in (True, "not installed")
                 and rep["cv2_exr"] is True and len(cv2_ok) == len(EXR_CV2_CASES) and all(cv2_ok)
                 and rep.get("dwa", {}).get("ok", False))
    if not rep["ok"]:
        failures.append(f"convert_exr: {rep}")
    return rep


def checkpoint_tools_phases(torch, np, cpu_model, counters, failures, card, paths: dict, report: dict) -> None:
    """parity_check and convert_exr, each emitted as it ends."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        rep = parity_check_phase(torch, np, root, cpu_model, counters, failures)
        rep.update(seconds=time.perf_counter() - t0, card=card)
        paths.update({f"parity_check_{name}": r["launches"] for name, r in rep["runs"].items()
                      if name != "record_cpu"})
        report["parity_check"] = rep
        emit({"phase": "parity_check", **rep})
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rep = convert_exr_phase(np, root, failures)
        rep.update(seconds=time.perf_counter() - t0, card=card)
        report["convert_exr"] = rep
        emit({"phase": "convert_exr", **rep})


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
    from sgam_neurips22_tpu_torch.ops.grid_accumulate import grid_accumulate
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
                             "flash_attention_dkv", "grid_accumulate")
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
    # 2b. the port's trace tools on the card: a bf16 training step and 4
    #     frames of bf16 map re-query traced by utils/profiling.trace, read
    #     by parse_trace and roofline, gated (trace_tools_phase); early in
    #     the process, where sessions lose fewest records (PERF.md §7)
    t0 = time.perf_counter()
    report["trace_tools"] = trace_tools_phase(torch, np, cpu_model16, seeds, failures, card)
    report["trace_tools"]["seconds"] = time.perf_counter() - t0
    emit({"phase": "trace_tools", **report["trace_tools"]})
    torch.cuda.empty_cache()

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
    cfg_b = SceneGenConfig(dataset="clevr-infinite", output_dim=(BATCHED_F32_FRAMES + 1, 1), topk=1,
                           image_resolution=(H, W))
    gen_b = InfiniteSceneGeneration(gen.model, cfg_b, seeds_batch[0], device="cuda")
    want_b32 = {"zbuffer_min": BATCHED_F32_FRAMES, "nearest_codeword": BATCHED_F32_FRAMES,
                "flash_attention_fwd": 7 * BATCHED_F32_FRAMES, "flash_attention_dq": 0, "flash_attention_dkv": 0}
    (rgb_b, _), batched, report["profile_batched"] = unroll_phase(
        torch, lambda: gen_b.scene_expansion_batched(seeds_batch), SCENES * BATCHED_F32_FRAMES, counters, want_b32,
        failures, "unroll_batched", per_step=SCENES)
    scenes_differ = not torch.equal(rgb_b[0, 1], rgb_b[1, 1])
    batched.update(scenes=SCENES, frames_per_scene=BATCHED_F32_FRAMES, scenes_0_1_differ_at_frame_1=scenes_differ,
                   card=card, model_tflop_per_s=gflop * SCENES * BATCHED_F32_FRAMES / batched["seconds"] / 1e3)
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

    # 6b. generate's --matmul_precision: the f32 flythrough at batch 1 and
    #     at SCENES scenes in float32 (TF32 off) and default (TF32) mode
    t0 = time.perf_counter()
    report["generate_precision"] = precision_phase(torch, np, gen.model, seeds, seeds_batch, counters, failures,
                                                   card)
    report["generate_precision"]["seconds"] = time.perf_counter() - t0
    paths["generate_precision"] = report["generate_precision"]["batch1"]["default"]["launches"]
    emit({"phase": "generate_precision", **report["generate_precision"]})

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
    want_b = {"zbuffer_min": FRAMES, "nearest_codeword": FRAMES, "flash_attention_fwd": 7 * FRAMES,
              "flash_attention_dq": 0, "flash_attention_dkv": 0}
    (rgb16_b, _), batched16, report["profile_batched_bf16"] = unroll_phase(
        torch, lambda: gen16_b.scene_expansion_batched(seeds_batch), SCENES * FRAMES, counters, want_b, failures,
        "unroll_batched_bf16", per_step=SCENES)
    batched16.update(scenes=SCENES, frames_per_scene=FRAMES, card=card, f32_ms_per_frame=batched["ms_per_frame"],
                     f32_ms_per_frame_by_layer=batched["ms_per_frame_by_layer"])
    keep = {"unroll_batched_bf16_rgb": rgb16_b.cpu()}  # for scenes_sharded
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
    grid_cases = {"map_clevr_last_step": tsdf_rep.pop("grid_inputs")}
    emit({"phase": "unroll_tsdf", **tsdf_rep})
    emit({"phase": "map_ms", "unroll_tsdf": tsdf_rep["map_ms"], "card": card})

    # 13. google_earth's map re-query at bf16 (bench.py --config google_earth
    #     --rgbd_integration): 13 x 1, GE_MAP_FRAMES frames (cut from 100), 3
    #     sources, codebook 4096, seed depth U(0.5, 4.0), a 2^20-slot pool
    ge_seeds = seed_frames(np, rng, (0.5, 4.0))
    gen_ge_map = InfiniteSceneGeneration(ge_model, map_config("google_earth", (GE_MAP_FRAMES + 1, 1)), ge_seeds,
                                         device="cuda")
    ge_tsdf_rep, report["profile_unroll_tsdf_ge"], map_keys["map_google_earth_last_frame"] = map_phase(
        torch, np, gen_ge_map, GE_MAP_FRAMES, counters, failures, "unroll_tsdf_ge", card)
    paths["unroll_tsdf_ge"] = ge_tsdf_rep["launches"]
    grid_cases["map_google_earth_last_step"] = ge_tsdf_rep.pop("grid_inputs")
    emit({"phase": "unroll_tsdf_ge", **ge_tsdf_rep})

    # 14. the same with coherent_plane_depth: every frame's depth, the seed's
    #     too, is one world plane's (bench.py --coherent)
    gen_coh = InfiniteSceneGeneration(ge_model, map_config("google_earth", (GE_MAP_FRAMES + 1, 1), coherent=True),
                                      ge_seeds, device="cuda")
    gen_coh.reset([((0, 0), ge_seeds[0][1], gen_coh.plane_depth_at(0))])
    coh_rep, report["profile_unroll_tsdf_ge_coherent"], _ = map_phase(
        torch, np, gen_coh, GE_MAP_FRAMES, counters, failures, "unroll_tsdf_ge_coherent", card)
    paths["unroll_tsdf_ge_coherent"] = coh_rep["launches"]
    del coh_rep["grid_inputs"]
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
    grid_cases["map_clevr_stride2_last_step"] = s2_rep.pop("grid_inputs")
    paths["integration_clevr_stride2"] = s2_rep["launches"]
    emit({"phase": "integration_clevr_stride2", **s2_rep})
    del gen_s2

    # 14c. map re-query for SCENES scenes at once at bf16 (bench.py's
    #      batched_8_scenes_tsdf: --batch_scenes 8 --frames 48
    #      --rgbd_integration; MAP_BATCH_GRID, cut from 7x7): CLEVR 5x5, 5
    #      sources, each scene its own
    #      seed frame (depth U(8, 14)), their maps in one batched volume
    t0 = time.perf_counter()
    gen_mb = InfiniteSceneGeneration(gen_map.model, map_config("clevr-infinite", MAP_BATCH_GRID), seeds,
                                     device="cuda")
    mb_frames = gen_mb.grid.size - 1
    want_mb = {"zbuffer_min": mb_frames, "nearest_codeword": mb_frames, "flash_attention_fwd": 7 * mb_frames,
               "flash_attention_dq": 0, "flash_attention_dkv": 0,
               "grid_accumulate": mb_frames + 1}  # seeded_volume fuses the 8 seeds in one call
    (rgb_mb, depth_mb), mb_rep, report["profile_unroll_tsdf_batched"] = unroll_phase(
        torch, lambda: gen_mb.scene_expansion_batched(seeds_batch), SCENES * mb_frames, (*counters, grid_accumulate),
        want_mb, failures,
        "unroll_tsdf_batched", per_step=SCENES)
    grid_cases["map_clevr_8_scenes_last_step"] = capture_grid_inputs_batched(torch, gen_mb, depth_mb)
    del depth_mb
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
    keep["unroll_tsdf_batched"] = {"stats": gen_mb.batched_volume.stats.cpu().tolist(),
                                   "pool_recycled": mb_rep["pool_recycled"]}
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
    t0 = time.perf_counter()
    kernels.append(check_grid_accumulate(torch, grid_cases, failures))
    emit({"phase": "grid_accumulate", "seconds": time.perf_counter() - t0, "shapes": kernels[-1]["shapes"]})
    del grid_cases
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

    # 15c. serving: build_inference_step; the serve CLI's server over HTTP
    #      (bf16, 5 x 5); the evaluate CLI on its export; a map-requery server
    serving_phases(torch, np, counters, failures, card, paths, report)

    # 15d. the checkpoint tools: parity_check on a flagship .ckpt (record on
    #      the CPU, compare, cross-check and a planted fault on the card);
    #      convert_exr on seeded Blender-layout EXRs
    checkpoint_tools_phases(torch, np, cpu_model, counters, failures, card, paths, report)

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

    # 18b. the training step at batch 1 with flash attention on (the
    #      config's choice, whatever the batch)
    t0 = time.perf_counter()
    train1 = train_batch1(torch, np, counters, failures, card)
    train1["seconds"] = time.perf_counter() - t0
    paths["train_batch1"] = train1["launches"]
    emit({"phase": "train_batch1", **train1})
    torch.cuda.empty_cache()

    # 19. the trainer through its entry points: the loader's rates, the
    #     codebook and conditional YAMLs at full width through the train
    #     CLI, generate --config on the trained run, and two Trainer steps
    #     on the card against the CPU
    trainer_phases(torch, np, counters, failures, card, paths, report)

    # 20. data parallelism on this card: the conditional YAML's step in one
    #     spawned NCCL rank against the plain step; two gloo ranks sharing
    #     the card against the one-process step, with planted faults; the
    #     8-scene unrolls sharded over the two ranks
    data_parallel_phases(torch, np, failures, card, paths, report, seeds_batch, cpu_model, keep)

    main_path = {"zbuffer_min": "unroll", "nearest_codeword": "unroll", "flash_attention_fwd": "unroll_batched",
                 "flash_attention_dq": "train", "flash_attention_dkv": "train", "grid_accumulate": "unroll_tsdf"}
    for k in kernels:
        k["launches"] = paths[main_path[k["name"]]][k["name"]]
        k["launches_by_path"] = {path: counts[k["name"]] for path, counts in paths.items() if k["name"] in counts}
        k["kernel_ms"] = k["ms"]
    report.update(kernels=kernels, unroll=unroll_rep, parity=parity, unroll_batched=batched,
                  parity_batched=parity_b, unroll_bf16=bf16_rep, parity_bf16=parity16,
                  unroll_batched_bf16=batched16, parity_batched_bf16=parity16_b, stride2=stride2, topk=topk,
                  google_earth=ge_rep, unroll_tsdf=tsdf_rep, unroll_tsdf_ge=ge_tsdf_rep,
                  unroll_tsdf_ge_coherent=coh_rep, integration_clevr_stride2=s2_rep, unroll_tsdf_batched=mb_rep,
                  map_parity=parity_map, parity_map_batched=parity_map_b, generate=gen_rep, train=train,
                  parity_train=parity_t,
                  train_bf16=train16, parity_train_bf16=parity_t16, train_batch1=train1,
                  profiler_misses=PROFILER_MISSES, failures=failures,
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
