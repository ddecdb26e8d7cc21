"""Data-parallel training and the scene-sharded unroll on several cards.

    python3 -m sgam_neurips22_tpu_torch.studies.data_parallel [--out DIR]

From the repository root, on a machine with 4 cards (its phases need 4; a
run on fewer exits non-zero). It builds the five hand kernels of the
training step once, then, each phase in ranks of its own
(`parallel.distributed.launch`, NCCL, one rank a card):

- train_1, train_2, train_4: the conditional YAML's training step
  (configs/conditional_generation/clevr-infinite.yaml at full width, f32,
  seeded random weights and LPIPS, the LR of its global batch) at global
  batch 16 on 1, 2 and 4 cards: one step from the seeded state, then
  TIMED_STEPS timed steps, then one profiled step; ms/step and images/s,
  peak memory per card, the all-reduce's device time (NCCL kernels in the
  profile), the device's idle share, launches per step of the five
  kernels, and a checksum of every rank's parameters, buffers, Adam
  moments after the last step (bit-equal across ranks). The first step's
  logs and applied update on 2 and 4 cards are held to the 1-card step's
  within chip_smoke's parity_train gates (`hold_step`);
- kernels: on each of cuda:1..3, the five kernels against their plain
  versions at a training shape (`check_kernels`);
- scenes_1, scenes_4: the 8-scene bf16 splat unroll (FRAMES frames a
  scene) and the 8-scene bf16 map re-query unroll (CLEVR 7x7, 48 frames)
  on one card and sharded 2 scenes a card over 4 cards: aggregate
  ms/frame, each rank's idle share, frames per scene, and the 4-card
  frames' PSNR per scene against the 1-card frames;
- train_cli: `python -m sgam_neurips22_tpu_torch.train --n_devices 4` on a
  seeded CLEVR-style dataset, CLI_STEPS steps, a checkpoint, then `-r`
  for one more step: one run directory.

Every line carries the cards' name and power limit (nvidia-smi). chip_smoke's
one-card data-parallel phases run the rank functions of this module
(`rank_train_step`, `rank_rehearsal`) with one rank over NCCL and with two
gloo ranks on one card. --out DIR writes the details to
DIR/data_parallel.json.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time
from pathlib import Path

from sgam_neurips22_tpu_torch.studies import cases
from sgam_neurips22_tpu_torch.utils import trace_events as te
from sgam_neurips22_tpu_torch.utils.trace_events import card_line

YAML = "configs/conditional_generation/clevr-infinite.yaml"
SEED = 0
GLOBAL_BATCH = 16  # the conditional YAML's batch_size
TIMED_STEPS = 3
REFRESHED = 64  # codewords set inactive before the rehearsal's k-means refresh
KERNELS = ("zbuffer_min", "nearest_codeword", "flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv")
FRAMES = 24  # frames a scene of the sharded splat unroll (chip_smoke's FRAMES)
MAP_GRID = (7, 7)  # the 8-scene map unroll's grid (bench.py's batched_8_scenes_tsdf)
SCENES = 8
CLI_STEPS = 2  # --max_steps of the train CLI phase: 3 steps, then one more after -r




def train_cfg(bs: int, kmeans: bool = False, yaml: str = YAML):
    """The conditional YAML's TrainConfig (or another YAML's) at global
    batch `bs`, with the trainer's LR (batch x base); with `kmeans`, the
    online k-means bookkeeping on (a buffer of 2 steps, the YAML's word
    timeout)."""
    from dataclasses import replace

    from sgam_neurips22_tpu_torch.core.config import load_configs
    from sgam_neurips22_tpu_torch.training.trainer import train_config_from_yaml

    cfg = train_config_from_yaml(load_configs([yaml]))
    cfg = replace(cfg, learning_rate=bs * cfg.learning_rate)
    if kmeans:
        cfg = replace(cfg, online_kmeans=replace(cfg.online_kmeans, do_online_kmeans_clustering=True,
                                                 train_feature_buffer_size=2))
    return cfg


def global_batch(bs: int, seed: int = 2, res: int = 256, mixed: bool = False) -> dict:
    """cases.train_batch's conditional batch (n_src 2, res^2; 256^2 is
    chip_smoke's) as numpy arrays, the whole global batch: every rank draws
    it and keeps its rows. With `mixed`, the rows of the second half are of
    another kind: flat walls (each row's images one colour, its depths one
    value), so that two ranks' halves of the batch differ in kind."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n, h, w = 2, res, res
    f = 355.5555 * res / 256
    k = np.array([[f, 0, res / 2], [0, f, res / 2], [0, 0, 1.0]], np.float32)
    arrays = {
        "dst_img": rng.uniform(-1, 1, (bs, h, w, 3)), "dst_depth": rng.uniform(8, 14, (bs, h, w)),
        "src_imgs": rng.uniform(-1, 1, (bs, n, h, w, 3)), "src_depths": rng.uniform(8, 14, (bs, n, h, w)),
        "Ks": np.broadcast_to(k, (bs, n, 3, 3)), "R_rels": np.broadcast_to(np.eye(3), (bs, n, 3, 3)),
        "t_rels": np.zeros((bs, n, 3)), "src_masks": np.ones((bs, n)),
    }
    if mixed:
        flat = slice(bs // 2, bs)
        colour, depth = rng.uniform(-1, 1, (bs - bs // 2, 3)), rng.uniform(8, 14, bs - bs // 2)
        arrays["dst_img"][flat] = colour[:, None, None, :]
        arrays["src_imgs"][flat] = colour[:, None, None, None, :]
        arrays["dst_depth"][flat] = depth[:, None, None]
        arrays["src_depths"][flat] = depth[:, None, None, None]
    return {key: np.ascontiguousarray(v, np.float32) for key, v in arrays.items()}


def counters():
    from sgam_neurips22_tpu_torch.ops.attention import flash_attention_dkv, flash_attention_dq, flash_attention_fwd
    from sgam_neurips22_tpu_torch.ops.vq import nearest_codeword
    from sgam_neurips22_tpu_torch.ops.zbuffer import zbuffer_min

    return zbuffer_min, nearest_codeword, flash_attention_fwd, flash_attention_dq, flash_attention_dkv


def state_tensors(state) -> dict:
    """Every tensor a rank must hold bit-equal: parameters and buffers of
    the model and the discriminator, both Adam states, the k-means state."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    out.update({f"disc.{k}": v for k, v in state.disc.state_dict().items()})
    for name, opt in (("opt_ae", state.opt_ae), ("opt_disc", state.opt_disc)):
        for i, st in enumerate(opt.state.values()):
            out.update({f"{name}.{i}.{k}": v for k, v in st.items() if hasattr(v, "shape")})
    if state.kmeans is not None:
        out.update({"kmeans.timeout": state.kmeans.timeout, "kmeans.buffer": state.kmeans.buffer})
    return out


def checksum(tensors: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def host(t):
    """A host copy of t (never a view of it, on the CPU too)."""
    return t.detach().to("cpu", copy=True)


def first_step(torch, state, cfg, w0: dict) -> dict:
    """A step's record for `hold_step`: the trainable weights' applied
    update and first moments, their gradients, and the discriminator's
    running statistics, on the CPU."""
    from sgam_neurips22_tpu_torch.training.train_step import split_params

    trainable = split_params(state.model, cfg.phase)[0]
    return {"update": {n: host(p) - w0[n] for n, p in trainable},
            "m": {n: host(state.opt_ae.state[p]["exp_avg"]) for n, p in trainable},
            "grads": {n: host(p.grad) for n, p in trainable},
            "stats": {n: host(b) for n, b in state.disc.named_buffers()}}


def hold_step(torch, rec: dict, ref: dict, grads: bool = False) -> dict:
    """A data-parallel step's record against a reference step's, at
    chip_smoke's parity_train gates: every log at rtol 1e-4 + atol 1e-6
    (d_weight at rtol 1e-3); the discriminator's running statistics at
    rtol 1e-4, atol 1e-6; the applied update by cases.update_gap (the
    sign of the update agrees on all but 1e-3 of the elements whose
    reference first moment is at least 1e-2 of its tensor's largest, and
    its L2 distance is within 2e-2), as parity_trainer holds it: a tensor
    whose reference first moment stays below 1e-5 of the largest (a bias
    that GroupNorm cancels: its gradient is f32 noise, whose sign Adam
    turns into a whole step) is held only to stay below that floor; with
    `grads`, each other trainable gradient's max error within 3e-2 of the
    tensor's largest (the card against the CPU bound)."""
    logs, ref_logs = rec["logs"], ref["logs"]
    rtol = {k: 1e-3 if k.endswith("d_weight") else 1e-4 for k in ref_logs}
    log_err = {k: abs(logs[k] - ref_logs[k]) / max(abs(ref_logs[k]), 1e-30) for k in ref_logs}
    logs_ok = set(logs) == set(ref_logs) and all(
        abs(logs[k] - ref_logs[k]) <= rtol[k] * abs(ref_logs[k]) + 1e-6 for k in ref_logs)
    stats_err = max(float((rec["stats"][n] - s).abs().max()) for n, s in ref["stats"].items())
    stats_ok = all(torch.allclose(rec["stats"][n], s, rtol=1e-4, atol=1e-6) for n, s in ref["stats"].items())
    floor = 1e-5 * max(float(m.abs().max()) for m in ref["m"].values())
    noise = sorted(n for n, m in ref["m"].items() if float(m.abs().max()) < floor)
    noise_ok = all(float(rec["m"][n].abs().max()) < floor for n in noise)
    zero = {n: torch.zeros(()) for n in ref["update"]}
    upd = cases.update_gap(torch, zero, rec["update"], zero, ref["update"], ref["m"], noise)
    out = {"log_rel_err": log_err, "logs_ok": logs_ok, "d_weight": [logs.get("train/d_weight"),
                                                                      ref_logs.get("train/d_weight")],
           "running_stats_max_abs_err": stats_err, "running_stats_ok": stats_ok, "update": upd,
           "noise_tensors": noise, "noise_ok": noise_ok}
    out["ok"] = logs_ok and stats_ok and upd["ok"] and noise_ok
    if grads:
        rel = {n: float((rec["grads"][n] - g).abs().max() / g.abs().max().clamp_min(1e-30))
               for n, g in ref["grads"].items() if n not in noise}
        worst = max(rel, key=rel.get)
        out["grad_worst"] = [worst, rel[worst]]
        out["grads_ok"] = rel[worst] <= 3e-2
        out["ok"] = out["ok"] and out["grads_ok"]
    return out


def profile_step(torch, fn, wall_s: float) -> dict:
    """`trace_events.profile_unroll` over one call of fn(): device ms by
    layer (NCCL's kernels as "collectives (NCCL)", on a stream beside
    compute), busy ms (the union of the card's record intervals, so that
    overlapping streams count once) beside kernel ms (their sum), the idle
    share against wall_s, and the launches the trace lost (with any, every
    time and the idle share are None)."""
    prof = te.profile_unroll(torch, fn, 1, wall_s)
    layers = prof["ms_per_frame_by_layer"]
    return {"device_busy_ms": prof["device_busy_ms_per_frame"], "device_kernel_ms": prof["device_kernel_ms_per_frame"],
            "device_idle_share": prof["device_idle_share"], "lost_launches": prof["lost_launches"],
            "collective_ms": None if layers is None else layers.get("collectives (NCCL)", 0.0), "ms_by_layer": layers}


def _launches(fns, steps: int) -> dict:
    return {fn.__name__: fn.launches / steps for fn in fns}


def _sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_step(torch, np, cfg, bs: int, steps: int, device: str = "cuda", res: int = 256, mixed: bool = False) -> dict:
    """One rank's share of the data-parallel step (or a plain process's):
    the seeded state, this rank's rows of the global batch (`global_batch`,
    `mixed` as there), a first step (its record on rank 0), then `steps`
    timed steps and one profiled step where `steps` > 0. On the card;
    `device="cpu"` rehearses it there."""
    from sgam_neurips22_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from sgam_neurips22_tpu_torch.training.lpips import random_lpips
    from sgam_neurips22_tpu_torch.training.train_step import create_train_state, split_params, train_step

    mesh = make_mesh(device=device)
    on_card = mesh.device.type == "cuda"
    fns = counters()
    t0 = time.perf_counter()
    state = create_train_state(cfg, seed=SEED, device=mesh.device)
    lpips = random_lpips(SEED + 2).to(mesh.device)
    batch = shard_batch({k: torch.from_numpy(v) for k, v in global_batch(bs, res=res, mixed=mixed).items()}, mesh)
    setup_s = time.perf_counter() - t0
    w0 = {n: host(p) for n, p in split_params(state.model, cfg.phase)[0]}
    if on_card:
        torch.cuda.reset_peak_memory_stats(mesh.device)
    _, logs = train_step(state, batch, lpips, cfg)
    _sync(torch, mesh.device)
    rec = {"logs": {k: float(v) for k, v in logs.items()}, "rank": mesh.rank, "ranks": mesh.size,
           "device": str(mesh.device), "local_batch": int(batch["dst_img"].shape[0]), "setup_seconds": setup_s}
    if mesh.rank == 0:
        rec.update(first_step(torch, state, cfg, w0))
    if steps:
        for fn in fns:
            fn.launches = 0
        _sync(torch, mesh.device)
        t0 = time.perf_counter()
        for _ in range(steps):
            train_step(state, batch, lpips, cfg)
        _sync(torch, mesh.device)
        dt = time.perf_counter() - t0
        rec.update(ms_per_step=dt / steps * 1e3, images_per_s=bs * steps / dt,
                   launches_per_step=_launches(fns, steps))
        if on_card:
            rec.update(profile_step(torch, lambda: train_step(state, batch, lpips, cfg), dt / steps))
    _sync(torch, mesh.device)
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated(mesh.device) / 1e9 if on_card else None
    rec["checksum"] = checksum(state_tensors(state))
    return rec


def rank_train_step(spec: dict) -> None:
    """A rank of `launch`: run_step at spec's global batch (spec's "yaml",
    "res" and "device" rehearse it small on the CPU); writes its record to
    spec["out"]/train_rank{r}.pt."""
    import numpy as np
    import torch

    from sgam_neurips22_tpu_torch.core.device import resolve_device
    from sgam_neurips22_tpu_torch.parallel import distributed

    device = resolve_device(spec.get("device", "cuda"))
    rec = run_step(torch, np, train_cfg(spec["bs"], yaml=spec.get("yaml", YAML)), spec["bs"],
                   spec.get("steps", TIMED_STEPS), str(device), spec.get("res", 256))
    rec["card"] = card_line(torch.cuda.current_device()) if device.type == "cuda" else "cpu"
    torch.save(rec, Path(spec["out"]) / f"train_rank{distributed.process_index()}.pt")


# ---------------------------------------------------------- two ranks, one card
def planted(fault):
    """Context: a planted fault of the data-parallel step, "local_batchnorm"
    (BatchNorm on each rank's own statistics) or "local_d_weight" (the
    adaptive weight from each rank's own gradients), or none."""
    import contextlib

    import torch

    from sgam_neurips22_tpu_torch.training import discriminator, losses

    @contextlib.contextmanager
    def ctx():
        saved = discriminator.stats_group, losses.adaptive_gradients
        if fault == "local_batchnorm":
            discriminator.stats_group = lambda: None
        elif fault == "local_d_weight":
            losses.adaptive_gradients = lambda nll, g, w: [torch.autograd.grad(v, w, retain_graph=True)[0]
                                                           for v in (nll, g)]
        try:
            yield
        finally:
            discriminator.stats_group, losses.adaptive_gradients = saved

    return ctx()


def rank_rehearsal(spec: dict) -> None:
    """A rank of two gloo ranks on one card (chip_smoke's
    dp_two_ranks_one_card and scenes_sharded): the conditional YAML's step
    with the k-means bookkeeping on, at spec["bs"] global rows
    (`global_batch`, with spec["mixed"] its halves of two kinds); the first
    step's record (rank 0), a second step, a k-means refresh of REFRESHED
    codewords drawn from a generator of this rank's own seed, and the
    checksum of every tensor; on a card, one more step timed and one
    profiled (`profile_step`: this rank's busy time and idle share); then the first step again under each planted
    fault; then, with spec["scenes"], the sharded unrolls (`sharded_scenes`)."""
    import numpy as np
    import torch

    from sgam_neurips22_tpu_torch.core.device import resolve_device
    from sgam_neurips22_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from sgam_neurips22_tpu_torch.training.kmeans import refresh_codebook
    from sgam_neurips22_tpu_torch.training.lpips import random_lpips
    from sgam_neurips22_tpu_torch.training.train_step import (
        create_train_state,
        make_optimizers,
        split_params,
        train_step,
    )

    mesh = make_mesh(device=resolve_device(spec.get("device", "cuda")))
    out = Path(spec["out"])
    cfg = train_cfg(spec["bs"], kmeans=True, yaml=spec.get("yaml", YAML))
    t0 = time.perf_counter()
    state = create_train_state(cfg, seed=SEED, device=mesh.device)
    init = {k: v.detach().clone() for k, v in state_tensors(state).items()}
    lpips = random_lpips(SEED + 2).to(mesh.device)
    batch = shard_batch({k: torch.from_numpy(v) for k, v in
                         global_batch(spec["bs"], res=spec.get("res", 256), mixed=spec.get("mixed", False)).items()},
                        mesh)
    w0 = {n: host(p) for n, p in split_params(state.model, cfg.phase)[0]}
    rec = {"rank": mesh.rank, "backend": torch.distributed.get_backend(), "device": str(mesh.device)}
    runs = {}
    for fault in (None, "local_batchnorm", "local_d_weight"):
        if fault:  # the seeded state again: its weights, fresh optimizers and k-means state
            state.model.load_state_dict({k[len("model."):]: v for k, v in init.items() if k.startswith("model.")})
            state.disc.load_state_dict({k[len("disc."):]: v for k, v in init.items() if k.startswith("disc.")})
            state.opt_ae, state.opt_disc = make_optimizers(cfg.learning_rate, state.opt_ae.param_groups[0]["params"],
                                                           state.disc.parameters())
            state.kmeans.timeout.copy_(init["kmeans.timeout"])
            state.kmeans.buffer.copy_(init["kmeans.buffer"])
            state.kmeans.ptr, state.step = 0, 0
        with planted(fault):
            _, logs = train_step(state, batch, lpips, cfg)
        run = {"logs": {k: float(v) for k, v in logs.items()}, **first_step(torch, state, cfg, w0)}
        runs[fault or "clean"] = run if mesh.rank == 0 else {"logs": run["logs"], "stats": run["stats"]}
        if fault is None:
            train_step(state, batch, lpips, cfg)
            km = cfg.online_kmeans
            state.kmeans.timeout[:REFRESHED] = 0  # the same inactive rows on every rank
            rec["refreshed"] = refresh_codebook(state.model.codebook, state.kmeans, km.online_kmeans_word_timeout,
                                                torch.Generator().manual_seed(SEED + 7 + mesh.rank))
            tensors = state_tensors(state)
            rec["checksums"] = {group: checksum({k: v for k, v in tensors.items() if k.startswith(group)})
                                for group in ("model.", "disc.", "opt_ae.", "opt_disc.", "kmeans.")}
            rec["moved_from_init"] = sorted({k.split(".")[0] for k, v in tensors.items()
                                             if k in init and not torch.equal(v, init[k])})
            rec["two_step_seconds"] = time.perf_counter() - t0
            if mesh.device.type == "cuda":  # one more step timed, then one profiled: this rank's idle share
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                train_step(state, batch, lpips, cfg)
                torch.cuda.synchronize()
                rec["step_profile"] = profile_step(torch, lambda: train_step(state, batch, lpips, cfg),
                                                   time.perf_counter() - t1)
    rec["runs"] = runs
    if spec.get("scenes"):
        rec["scenes"] = sharded_scenes(torch, np, spec["scenes"], mesh)
    torch.save(rec, out / f"rehearsal_rank{mesh.rank}.pt")


# ------------------------------------------------------------ the sharded unroll
def flagship_model(dtype: str):
    from sgam_neurips22_tpu_torch.core.state_dict import load_into, random_state_dict
    from sgam_neurips22_tpu_torch.models.vqgan.model import VQModel
    from sgam_neurips22_tpu_torch.serving import flagship_config

    model = VQModel(flagship_config(compute_dtype=dtype))
    f32 = VQModel(flagship_config())
    load_into(model, random_state_dict(f32, SEED))  # chip_smoke's weights, whatever the dtype
    return model.eval()


def scene_gen(model, grid, seeds_batch, map_mode: bool):
    from sgam_neurips22_tpu_torch.pipeline.scene_generation import InfiniteSceneGeneration, SceneGenConfig

    cfg = (cases.map_config("clevr-infinite", grid) if map_mode else
           SceneGenConfig(dataset="clevr-infinite", output_dim=grid, topk=1, image_resolution=(256, 256)))
    return InfiniteSceneGeneration(model, cfg, seeds_batch[0], device="cuda")


def sharded_scenes(torch, np, spec: dict, mesh) -> dict:
    """The scene-sharded unrolls of one rank (every rank of `mesh` calls
    it): for each case of spec["cases"] (name -> (dtype, grid, map mode,
    profiled, frames kept[, scenes])), scene_expansion_batched of
    spec["seeds"] (its first `scenes`, where given) over the mesh (after a
    warm-up call where profiled), its seconds, this rank's kernel launches,
    the gathered frames (rank 0, to the CPU, where kept), this rank's idle
    share from a profile of one more call where profiled, and under map
    re-query this rank's per-scene telemetry and the stats summed over the
    ranks."""
    out = {}
    models = {}
    fns = counters()
    for name, (dtype, grid, map_mode, profiled, keep, *scenes) in spec["cases"].items():
        seeds = spec["seeds"][:scenes[0]] if scenes else spec["seeds"]
        if dtype not in models:
            models[dtype] = flagship_model(dtype)
        gen = scene_gen(models[dtype], tuple(grid), seeds, map_mode)
        run = lambda: gen.scene_expansion_batched(seeds, mesh=mesh)  # noqa: E731
        if profiled:
            run()  # warm-up: cuDNN's plans, the plan's upload
        torch.cuda.synchronize()
        for fn in fns:
            fn.launches = 0
        t0 = time.perf_counter()
        rgb, depth = run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        frames = (gen.grid.size - 1) * len(seeds)
        res = {"seconds": dt, "frames": frames, "aggregate_ms_per_frame": dt / frames * 1e3,
               "frames_per_scene": gen.grid.size - 1, "scenes_here": len(seeds) // mesh.size,
               "launches": {fn.__name__: fn.launches for fn in fns},
               "finite": bool(torch.isfinite(rgb).all() and torch.isfinite(depth).all())}
        if map_mode:
            tel = cases.batched_pool_telemetry(np, gen)
            res.update(scenes_pool=tel["scenes_pool"], stats=gen.batched_volume.stats.cpu().tolist())
        if profiled:
            res.update(profile_step(torch, run, dt))
            if res["ms_by_layer"] is not None:
                res["ms_by_layer"] = {k: v / frames for k, v in res["ms_by_layer"].items()}
        if mesh.rank == 0 and keep:
            res["rgb"], res["depth"] = rgb.cpu(), depth.cpu()
        out[name] = res
        del gen, rgb, depth
        torch.cuda.empty_cache()
    return out


def rank_scenes(spec: dict) -> None:
    import numpy as np
    import torch

    from sgam_neurips22_tpu_torch.core.device import resolve_device
    from sgam_neurips22_tpu_torch.parallel import distributed
    from sgam_neurips22_tpu_torch.parallel.mesh import make_mesh

    resolve_device("cuda")
    mesh = make_mesh(device="cuda")
    rec = sharded_scenes(torch, np, spec, mesh)
    rec["card"] = card_line(torch.cuda.current_device())
    torch.save(rec, Path(spec["out"]) / f"scenes_rank{distributed.process_index()}.pt")


# ------------------------------------------------------------------- kernels
def check_kernels(torch) -> dict:
    """The five kernels on this rank's card against their plain versions,
    at a training shape each: the z-buffer at [16, 131072] (bit-exact),
    the codeword search at P = 4096 against K = 16384 (the plain version's
    index, or a near tie of it by ops.vq.near_ties_ok), the attention
    forward, dQ and dK/dV at [16, 256, 512] and [16, 4096, 256] (chip_smoke's
    tolerances: out 1e-4 absolute, lse 1e-5 relative; each gradient within
    1e-4 of its largest)."""
    from sgam_neurips22_tpu_torch.ops import attention as A
    from sgam_neurips22_tpu_torch.ops.vq import near_ties_ok, nearest_codeword, nearest_codeword_plain
    from sgam_neurips22_tpu_torch.ops.zbuffer import zbuffer_min, zbuffer_min_plain

    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(SEED)
    res = {"device": str(dev)}
    pix = torch.randint(0, 256 * 256, (16, 131072), generator=g, device=dev, dtype=torch.int32)
    key = torch.randint(0, 1 << 30, (16, 131072), generator=g, device=dev, dtype=torch.int32)
    res["zbuffer_min"] = {"ok": torch.equal(zbuffer_min(pix, key, 256, 256).cpu(),
                                            zbuffer_min_plain(pix.cpu(), key.cpu(), 256, 256))}
    z = torch.randn((4096, 256), generator=g, device=dev)
    cb = torch.randn((16384, 256), generator=g, device=dev)
    idx = nearest_codeword(z, cb)[0]
    ref = nearest_codeword_plain(z, cb)[0]
    mismatched, ok = near_ties_ok(z, cb, idx, ref)
    res["nearest_codeword"] = {"ok": ok, "index_mismatches": mismatched}
    worst = {"flash_attention_fwd": 0.0, "flash_attention_dq": 0.0, "flash_attention_dkv": 0.0}
    ok_fwd = ok_bwd = True
    for b, s, c in ((16, 256, 512), (16, 4096, 256)):
        q, k, v, do = (torch.randn((b, s, c), generator=g, device=dev) for _ in range(4))
        out, lse = A.flash_attention_fwd(q, k, v)
        pout, plse = A.flash_attention_plain(q, k, v)
        err = float((out - pout).abs().max())
        ok_fwd &= err <= 1e-4 and float(((lse - plse).abs() / plse.abs()).max()) <= 1e-5
        worst["flash_attention_fwd"] = max(worst["flash_attention_fwd"], err)
        args = (q, k, v, do, plse, (do * pout).sum(-1))
        for name, got, want in (("flash_attention_dq", (A.flash_attention_dq(*args),), (A.flash_attention_dq_plain(*args),)),
                                ("flash_attention_dkv", A.flash_attention_dkv(*args), A.flash_attention_dkv_plain(*args))):
            rel = max(float((x - r).abs().max() / r.abs().max()) for x, r in zip(got, want))
            ok_bwd &= rel <= 1e-4
            worst[name] = max(worst[name], rel)
        del q, k, v, do, out, lse, pout, plse, args
    res["flash_attention_fwd"] = {"ok": ok_fwd, "max_abs_err": worst["flash_attention_fwd"]}
    for name in ("flash_attention_dq", "flash_attention_dkv"):
        res[name] = {"ok": ok_bwd, "max_rel_err": worst[name]}
    res["launched_here"] = {fn.__name__: fn.launches for fn in counters()}
    res["ok"] = all(res[k]["ok"] for k in KERNELS) and all(n > 0 for n in res["launched_here"].values())
    return res


def rank_kernels(spec: dict) -> None:
    import torch

    from sgam_neurips22_tpu_torch.core.device import resolve_device
    from sgam_neurips22_tpu_torch.parallel import distributed

    resolve_device("cuda")
    rec = check_kernels(torch)
    rec["card"] = card_line(torch.cuda.current_device())
    torch.save(rec, Path(spec["out"]) / f"kernels_rank{distributed.process_index()}.pt")


# ---------------------------------------------------------------------- main
def _load(out: Path, stem: str, n: int) -> list:
    import torch

    return [torch.load(out / f"{stem}_rank{r}.pt", weights_only=False) for r in range(n)]


def _emit(obj) -> None:
    print(json.dumps(obj, default=str), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    from sgam_neurips22_tpu_torch.ops import cuda_build
    from sgam_neurips22_tpu_torch.parallel import distributed
    from sgam_neurips22_tpu_torch.parallel.mesh import make_mesh

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < 4:
        print(f"data_parallel: {cards} card(s); this study needs 4", file=sys.stderr)
        return 1
    lines = [card_line(i) for i in range(cards)]
    report, failures = {"cards": lines, "torch": torch.__version__, "cuda": torch.version.cuda}, []
    _emit({"phase": "cards", "cards": lines})
    t0 = time.perf_counter()
    cuda_build.build(*KERNELS, "grid_accumulate")
    report["build_seconds"] = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    seeds_batch = [cases.seed_frames(np, rng) for _ in range(SCENES)]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # the step on 1, 2 and 4 cards
        for n in (1, 2, 4):
            t0 = time.perf_counter()
            d = tmp / f"train_{n}"
            d.mkdir()
            distributed.launch(rank_train_step, n, args=({"bs": GLOBAL_BATCH, "out": str(d)},))
            ranks = _load(d, "train", n)
            rep = {"cards": n, "global_batch": GLOBAL_BATCH, "seconds": time.perf_counter() - t0,
                   "ranks": [{k: r[k] for k in ("device", "card", "local_batch", "ms_per_step", "images_per_s",
                                                "peak_mem_gb", "collective_ms", "device_busy_ms",
                                                "device_kernel_ms", "lost_launches", "device_idle_share",
                                                "launches_per_step", "setup_seconds")}
                             for r in ranks],
                   "bit_equal_across_ranks": len({r["checksum"] for r in ranks}) == 1}
            rep["ms_per_step"] = max(r["ms_per_step"] for r in ranks)
            rep["images_per_s"] = GLOBAL_BATCH / rep["ms_per_step"] * 1e3
            if n == 1:
                ref = ranks[0]
            else:
                rep["vs_1_card"] = hold_step(torch, ranks[0], ref)
                if not rep["vs_1_card"]["ok"]:
                    failures.append(f"train_{n}: step against the 1-card step {rep['vs_1_card']}")
            if not rep["bit_equal_across_ranks"]:
                failures.append(f"train_{n}: ranks' state differs")
            report[f"train_{n}"] = rep
            _emit({"phase": f"train_{n}", **{k: v for k, v in rep.items()}})
            del ranks
        # the kernels on cuda:1..3 (and 0) and the sharded unroll, in one launch of 4 ranks
        t0 = time.perf_counter()
        d = tmp / "kernels"
        d.mkdir()
        distributed.launch(rank_kernels, 4, args=({"out": str(d)},))
        kern = _load(d, "kernels", 4)
        report["kernels"] = kern
        if not all(k["ok"] for k in kern):
            failures.append(f"kernels on cuda:0..3: {kern}")
        _emit({"phase": "kernels", "seconds": time.perf_counter() - t0, "ranks": kern})
        scene_cases = {"splat_bf16": ("bfloat16", (FRAMES + 1, 1), False, True, True),
                       "map_bf16": ("bfloat16", MAP_GRID, True, True, True)}
        one = sharded_scenes(torch, np, {"cases": scene_cases, "seeds": seeds_batch}, make_mesh(device="cuda"))
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        d = tmp / "scenes"
        d.mkdir()
        distributed.launch(rank_scenes, 4, args=({"cases": scene_cases, "seeds": seeds_batch, "out": str(d)},))
        four = _load(d, "scenes", 4)
        for name in scene_cases:
            rep = {"one_card": {k: v for k, v in one[name].items() if k != "rgb"},
                   "four_cards": [{k: v for k, v in r[name].items() if k != "rgb"} for r in four]}
            rep["four_cards_aggregate_ms_per_frame"] = max(r[name]["aggregate_ms_per_frame"] for r in four)
            rep["psnr_per_scene_db"] = [float(np.mean(cases.psnr(torch, a[1:], b[1:])))
                                        for a, b in zip(four[0][name]["rgb"], one[name]["rgb"])]
            if name.startswith("map"):
                summed = np.sum([[s["pool_recycled"] for s in r[name]["scenes_pool"]] for r in four])
                rep["summed_stats_match_scenes"] = float(four[0][name]["stats"][3]) == float(summed)
                rep["one_card_stats"] = one[name]["stats"]
                if not rep["summed_stats_match_scenes"]:
                    failures.append(f"{name}: summed stats {four[0][name]['stats']} against per-scene {summed}")
            if not all(r[name]["finite"] for r in four):
                failures.append(f"{name}: frames not finite")
            report[name] = rep
            _emit({"phase": name, "seconds": time.perf_counter() - t0, **rep})
        del one, four
        # the train CLI on 4 cards
        report["train_cli"] = train_cli_phase(torch, np, tmp, failures)
        _emit({"phase": "train_cli", **report["train_cli"]})
    report["failures"] = failures
    if args.out:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "data_parallel.json").write_text(json.dumps(report, indent=1, default=str))
    for f in failures:
        print(f"data_parallel: FAILED {f}", file=sys.stderr)
    _emit({"ok": not failures, "cards": lines})
    return 1 if failures else 0


def train_cli_phase(torch, np, root: Path, failures, yaml: str = YAML, res: int = 256, device: str = "cuda") -> dict:
    """`train --n_devices 4 --base YAML` on a seeded CLEVR-style dataset at
    res^2: CLI_STEPS + 1 steps with validation and test, then `-r` for one
    more (a small YAML on the CPU rehearses it)."""
    from sgam_neurips22_tpu_torch import train as train_cli
    from sgam_neurips22_tpu_torch.core.checkpoint import complete_steps
    from sgam_neurips22_tpu_torch.studies.trainer_host import write_train_dataset

    (root / "data").mkdir()
    write_train_dataset(root / "data", res, res, SEED + 11, 8, 18, 2)
    logs = root / "logs"
    argv = ["--n_devices", "4", "--no_wandb", "--device", device, "--max_steps", str(CLI_STEPS),
            f"data.params.dataset_dir={root / 'data'}", f"data.params.image_resolution=[{res},{res}]"]
    t0 = time.perf_counter()
    train_cli.main(["--base", yaml, "-l", str(logs), "-n", "dp4", *argv])
    first_s = time.perf_counter() - t0
    runs = sorted(os.listdir(logs))
    run = logs / runs[0]
    steps_first = complete_steps(str(run / "checkpoints"))
    t0 = time.perf_counter()
    train_cli.main(["-r", str(run), *argv])
    resume_s = time.perf_counter() - t0
    metrics = [json.loads(x) for x in open(run / "metrics.jsonl")]
    rep = {"runs": runs, "seconds": first_s, "resume_seconds": resume_s, "checkpoints_first": steps_first,
           "checkpoints_after_resume": complete_steps(str(run / "checkpoints")),
           "train_log_steps": [m["step"] for m in metrics if "aeloss" in m],
           "validation_records": sum("val/rec_loss" in m for m in metrics),
           "finite": all(np.isfinite(v) for m in metrics for v in m.values() if isinstance(v, float))}
    rep["ok"] = (len(runs) == 1 and rep["checkpoints_first"][-1:] == [CLI_STEPS + 1]
                 and rep["checkpoints_after_resume"][-1:] == [CLI_STEPS + 2] and rep["finite"]
                 and rep["validation_records"] == 4)
    if not rep["ok"]:
        failures.append(f"train_cli: {rep}")
    return rep


if __name__ == "__main__":
    sys.exit(main())
