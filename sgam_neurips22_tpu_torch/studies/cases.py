"""The inputs and readings that chip_smoke.py and the studies share.

chip_smoke's seeded cases, kept in the package so that a study
(`studies/*.py`) reruns a phase's case without importing the root script:
the flagship unrolls' sizes (H, W, FRAMES, SCENES, the map grids), seeded
source frames, the map-requery configuration and its pool telemetry, the
z-buffer callers' inputs (`zbuffer_cases`, `collision_case`), the grid
accumulation's captured inputs, their statistics and its first route, the
conditional training step's configuration and batch, the bf16
training-step parity (`parity_train_bf16`), the Adam update's gate
(`update_gap`), PSNR and nvcc's register report. Functions take torch and
numpy as arguments, as chip_smoke's do.
"""
from __future__ import annotations

import time

SEED = 0
H = W = 256
FRAMES = 24  # frames generated per unroll: the flythrough grid is (FRAMES + 1) x 1
SCENES = 8  # scenes of the batched unroll, as bench.py's batched_8_scenes
# the z-buffer merge's map-requery pool splat: one call merges 2 sub-chunks of
# 2^18 slots for each of 8 scenes (sgam_neurips22_tpu/mapping/tsdf.py:123,
# 139, 929-940); keys carry a 20-bit slot; CLEVR's pool (near, far) from
# auto_config (depth range (7, 16), sdf_trunc 0.5); ring recycling
# interleaves runs of POOL_RUN slots
POOL_ROWS, POOL_P, POOL_IDX_BITS, POOL_RUN, POOL_INVALID = 16, 1 << 18, 20, 256, 0.3
POOL_NEAR_FAR = (0.8 * 7.0 - 0.5, 1.2 * 16.0 + 0.5)
ZB_LARGE = 1024  # the side of an image whose window would hold too few rows: the l2 route
TRAIN_BATCH = 16  # bench.py --config train_conditional
TRAIN_LR = 1e-4  # bench.py bench_train
MAP_GRID = (3, 3)  # bench.py --config integration: 8 frames on a 3x3 grid
MAP_BATCH_GRID = (5, 5)  # bench.py batched_8_scenes_tsdf (--frames 48 on a 7x7 grid), cut to 24 frames for time
MAP_STRIDE2_GRID = (2, 2)  # integration_clevr_stride2, cut from 3x3 (8 frames) to 3 frames for time
GE_MAP_FRAMES = 12  # google_earth's two map phases: a (GE_MAP_FRAMES + 1) x 1 trajectory, cut from 100 for time
UPDATE_FLOOR = 1e-2  # the update gate's elements: CPU first moment at least this share of its tensor's largest


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


def psnr(torch, a, b) -> list:
    """PSNR in dB of each frame of rgb a against b ([G, H, W, 3] in [-1, 1],
    so a peak-to-peak range of 2)."""
    mse = ((a.float() - b.float()) ** 2).flatten(1).mean(1)
    return [float(x) for x in 10 * torch.log10(4.0 / mse.clamp(min=1e-20))]


def train_config(torch, bs: int, dtype: str = "float32"):
    """The conditional-generation training configuration of `bench.py
    --config train_conditional` on the flagship model (phase
    conditional_generation, n_embed 16384, depth_range (7, 16), as JAX's
    flagship_config): remat, flash attention (`flash_attention=True`, as
    bench.py sets it: every attention block takes it, at any batch),
    LossConfig(disc_start=0), LR 1e-4; with dtype "bfloat16",
    `--train_dtype bfloat16` (train_conditional_bf16)."""
    import dataclasses

    from sgam_neurips22_tpu_torch.serving import flagship_config
    from sgam_neurips22_tpu_torch.training.losses import LossConfig
    from sgam_neurips22_tpu_torch.training.train_step import TrainConfig

    model = flagship_config(compute_dtype=dtype)
    model = dataclasses.replace(model, ddconfig=dataclasses.replace(model.ddconfig, remat=True, flash_attention=True))
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


def last_step(torch, gen) -> dict:
    """Device inputs of the trajectory's last step (its target pose, its
    sources and their transforms) and that frame's depth, for timing the
    map's functions at the phase's shapes."""
    src, _, _, _, t2s, w2c = gen._step_inputs_host(gen.order[-1], len(gen.order) - 1)
    tgt = gen.grid.index(*gen.order[-1])
    dev = gen.device
    return {"src": torch.as_tensor(src, device=dev), "t2s": torch.as_tensor(t2s, device=dev),
            "w2c": torch.as_tensor(w2c, device=dev), "depth": gen.depth_buf[tgt]}


def capture_grid_inputs(torch, gen) -> dict:
    """The grid accumulation's inputs as integrate builds them at the
    phase's last step (one more integrate into a copy of the volume): the
    grid before, the int32 voxel ids and the f32 values."""
    from sgam_neurips22_tpu_torch.mapping import tsdf

    vol, st, keep, orig = gen.volume.to(gen.device), last_step(torch, gen), {}, tsdf.grid_accumulate

    def spy(grid, idx, vals):
        keep.update(grid=grid.clone(), idx=idx.clone(), vals=vals.clone())
        return orig(grid, idx, vals)

    tsdf.grid_accumulate = spy
    try:
        tsdf.integrate(vol, gen.tsdf_cfg, st["depth"], None, gen.ks[0], st["w2c"])
    finally:
        tsdf.grid_accumulate = orig
    torch.cuda.synchronize()
    return keep


def capture_grid_inputs_batched(torch, gen, depth) -> dict:
    """capture_grid_inputs for the batched map: one more integrate of the
    plan's last step, every scene's frame at once (depth [S, G, H, W] from
    scene_expansion_batched), into a copy of `batched_volume`."""
    from sgam_neurips22_tpu_torch.mapping import tsdf

    plan = gen.build_plan()
    t = len(plan["tgt"]) - 1
    vol, keep, orig = gen.batched_volume.to(gen.device), {}, tsdf.grid_accumulate

    def spy(grid, idx, vals):
        keep.update(grid=grid.clone(), idx=idx.clone(), vals=vals.clone())
        return orig(grid, idx, vals)

    tsdf.grid_accumulate = spy
    try:
        tsdf.integrate(vol, gen.tsdf_cfg, depth[:, plan["tgt"][t]], None, gen.ks[0], plan["tgt_w2c"][t])
    finally:
        tsdf.grid_accumulate = orig
    torch.cuda.synchronize()
    return keep


def grid_input_stats(torch, grid, idx, vals) -> dict:
    """What shapes the grid accumulation's work: the samples, the key bits
    the grid's size needs, the touched voxels, the zero addends (integrate's
    masked samples add 0.0 at voxel 0), voxel 0's run and the longest run
    of any other voxel."""
    keys, counts = torch.unique(idx, return_counts=True)
    other = counts[keys != 0]
    return {"samples": idx.numel(), "voxels": grid.numel(), "key_bits": max(1, (grid.numel() - 1).bit_length()),
            "touched_voxels": int(keys.numel()), "zero_addends": int((vals == 0).sum()),
            "zero_addends_at_key_0": int(((vals == 0) & (idx == 0)).sum()), "key_0_run": int((idx == 0).sum()),
            "longest_other_run": int(other.max()) if other.numel() else 0}


def grid_accumulate_sorted(torch, grid, idx, vals) -> None:
    """The grid accumulation's first CUDA route, timed beside the
    op as old_ms: torch.sort of the keys, a gather of the values, then
    csrc/grid_accumulate.cu's grid_accumulate_sorted_launch, one thread
    walking each key's run."""
    from sgam_neurips22_tpu_torch.ops import cuda_build
    from sgam_neurips22_tpu_torch.ops import grid_accumulate as acc

    keys, order = torch.sort(idx, stable=True)
    ordered = vals[order]
    lib = cuda_build.library("grid_accumulate", acc._SIGNATURES)
    rc = lib.grid_accumulate_sorted_launch(keys.data_ptr(), ordered.data_ptr(), grid.data_ptr(), keys.numel(),
                                           torch.cuda.current_stream().cuda_stream)
    cuda_build.check(rc, "grid_accumulate_sorted")


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


def seed_frames(np, rng, depth_range=(8, 14)) -> list:
    """One scene's seeds: a random frame at grid (0, 0), depths uniform in
    depth_range (bench.py's: (8, 14) for clevr-infinite, (0.5, 4.0) for
    google_earth)."""
    return [((0, 0), rng.uniform(-1, 1, (H, W, 3)).astype(np.float32),
             rng.uniform(*depth_range, (H, W)).astype(np.float32))]


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
