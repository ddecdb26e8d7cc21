#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (`sgam_neurips22_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--profile] [--out DIR]

From the repository root. It builds the port's CUDA kernels from csrc/,
holds each against its plain PyTorch version on the card and times both,
unrolls the flagship clevr-infinite flythrough (256^2, 5 sources, topk=1,
seeded random weights) through `InfiniteSceneGeneration.scene_expansion`,
checks that both kernels ran once per frame, and compares one full-width
step on the card with the same step on the CPU. Each phase prints one JSON
line; --out DIR also writes the details to DIR/chip_smoke.json and nvcc's
register report to DIR/chip_smoke_ptxas.txt. The last line is
{"ok": true, "device": {...}} and is printed only when every check passed.
It exits non-zero without that line when CUDA is unavailable or any check
fails. --profile adds a torch.profiler pass over one more unroll.
"""
from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM data-sheet peaks (NVIDIA, dense): HBM3 bandwidth and the f32 rate
# of the CUDA cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
SEED = 0
H = W = 256
FRAMES = 24  # frames generated per unroll: the flythrough grid is (FRAMES + 1) x 1


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


def device_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Device time per fn() call: the summed time of every kernel that
    `iters` calls launched, from torch.profiler, over `iters`. Unlike
    cuda_ms it leaves out the gaps while the host prepares each launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.self_device_time_total for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA)
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


def splat_keys(torch, np, gen, n_src: int, rng):
    """(pix, key) of a real flagship splat: n_src random 8-14 depth frames
    at grid rows 0..n_src-1 projected into row n_src, all sources valid."""
    from sgam_neurips22_tpu_torch.geometry.camera import pose_matrix
    from sgam_neurips22_tpu_torch.geometry.splat import packed_keys, project_points

    dev = gen.device
    t_tgt = gen.grid.w2c(n_src)
    rel = np.stack([t_tgt @ np.linalg.inv(gen.grid.w2c(i)) for i in range(n_src)]).astype(np.float32)
    depths = torch.tensor(rng.uniform(8, 14, (1, n_src, H, W)), dtype=torch.float32, device=dev)
    src2tgt = pose_matrix(torch.tensor(rel[:, :3, :3], device=dev), torch.tensor(rel[:, :3, 3], device=dev))
    ks = gen.ks[:n_src]
    pix, z, valid = project_points(depths, ks[:1], ks[None], src2tgt[None])
    return packed_keys(pix, z, valid, W)


def check_zbuffer(torch, np, gen, failures):
    from sgam_neurips22_tpu_torch.ops.zbuffer import IMAX, zbuffer_min, zbuffer_min_plain

    rng = np.random.default_rng(SEED)
    pix, key = splat_keys(torch, np, gen, 5, rng)
    b, p = pix.shape
    # collision-heavy: every point on one of 1024 pixels, 20% invalid
    cp = torch.tensor(rng.integers(0, 1024, (b, p)), dtype=torch.int32, device=gen.device)
    ck = torch.tensor(rng.integers(0, 2**31 - 1, (b, p)), dtype=torch.int32, device=gen.device)
    invalid = torch.tensor(rng.random((b, p)) < 0.2, device=gen.device)
    cases = {"splat": (pix, key), "collisions": (torch.where(invalid, 0, cp), torch.where(invalid, IMAX, ck))}
    err, exact = 0, True
    for name, (cpix, ckey) in cases.items():
        out, ref = zbuffer_min(cpix, ckey, H, W), zbuffer_min_plain(cpix, ckey, H, W)
        torch.cuda.synchronize()
        exact &= torch.equal(out, ref)
        err = max(err, int((out.long() - ref.long()).abs().max()))
    if not exact:
        failures.append("zbuffer_min differs from zbuffer_min_plain")
    base, idx = torch.full((b, H * W), IMAX, dtype=torch.int32, device=gen.device), pix.long()
    b_ms, b_by = bound(2 * 4 * b * p + 4 * b * H * W, 0)
    return {
        "name": "zbuffer_min", "route": "cuda",
        "source": "sgam_neurips22_tpu_torch/csrc/zbuffer_min.cu",
        "replaces": "sgam_neurips22_tpu/ops/splat_pallas.py:88",
        "ok": exact, "bit_exact": exact, "max_abs_err": err,
        "shape": {"pix": [b, p], "pixels": H * W},
        "valid_points": int((key != IMAX).sum()),
        **timings(torch, lambda: zbuffer_min(pix, key, H, W),
                  lambda: zbuffer_min_plain(pix, key, H, W),
                  lambda: torch.scatter_reduce(base, 1, idx, key, "amin")),
        "bound_ms": b_ms, "bound_by": b_by,
    }


def check_nearest_codeword(torch, model, failures, p=256):
    from sgam_neurips22_tpu_torch.ops.vq import nearest_codeword, nearest_codeword_plain

    g = torch.Generator(device="cuda").manual_seed(SEED)
    cb = model.codebook.detach()  # seeded flagship init, uniform(-1/K, 1/K)
    k, d = cb.shape
    z = torch.randn((p, d), generator=g, device=cb.device)
    idx, dist = nearest_codeword(z, cb)
    pidx, pdist = nearest_codeword_plain(z, cb)
    torch.cuda.synchronize()
    # an index may differ only at an f32 near-tie: the two codewords' exact
    # (f64) scores e2 - 2 z.e within 1e-6 of the scale of their f32 sums
    z64, e64 = z.double(), cb.double()
    rows = torch.nonzero(idx != pidx).flatten()
    ties_ok = True
    for r in rows.tolist():
        a, b_ = int(idx[r]), int(pidx[r])
        score = [float(e64[j] @ e64[j] - 2 * z64[r] @ e64[j]) for j in (a, b_)]
        scale = max(float(e64[j] @ e64[j] + 2 * (z64[r] * e64[j]).abs().sum()) for j in (a, b_))
        ties_ok &= abs(score[0] - score[1]) <= 1e-6 * scale
    dist_ok = bool(torch.allclose(dist, pdist, rtol=1e-5, atol=0.0))
    ok = ties_ok and dist_ok
    if not ok:
        failures.append(f"nearest_codeword: ties_ok={ties_ok} dist_ok={dist_ok}")
    b_ms, b_by = bound(4 * (p * d + k * d) + 8 * p, 2.0 * p * k * d)
    return {
        "name": "nearest_codeword", "route": "cuda",
        "source": "sgam_neurips22_tpu_torch/csrc/nearest_codeword.cu",
        "replaces": "sgam_neurips22_tpu/ops/vq_pallas.py:117",
        "ok": ok, "index_mismatches": len(rows), "near_ties_ok": ties_ok,
        "max_abs_err": float((dist - pdist).abs().max()),
        "shape": {"P": p, "K": k, "D": d},
        **timings(torch, lambda: nearest_codeword(z, cb),
                  lambda: nearest_codeword_plain(z, cb),
                  lambda: torch.cdist(z, cb).argmin(dim=1)),
        "bound_ms": b_ms, "bound_by": b_by,
    }


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
    ("zbuffer_min_kernel", "ours: zbuffer_min"),
    ("search_kernel|sqnorm_kernel|finalize_kernel", "ours: nearest_codeword"),
    ("fprop|cudnn|nchwToNhwc|nhwcToNchw|conv", "conv (cuDNN)"),
    ("gemm", "matmul (attention, plain GEMMs)"),
    ("softmax|SoftMax", "softmax"),
    ("reduce_kernel", "reductions (GroupNorm stats, splat z range)"),
    ("", "elementwise / copies / index"),
)


def profile_unroll(torch, gen, timed_s: float) -> dict:
    """Device time by kernel over one more unroll, grouped by layer, and
    the device's idle share: 1 - device time / the timed unroll's wall time
    (the profiler itself slows the host, so its own wall time is not used)."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen.reset()
    frames = len(gen.build_plan()["tgt"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        gen.scene_expansion()
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


def parity_step(torch, gen, cpu_model, failures) -> dict:
    """Frame 1 of the unroll on the card against the same step on the CPU
    (plain versions), same weights and inputs, stage by stage."""
    from sgam_neurips22_tpu_torch.models.conditioning import get_x
    from sgam_neurips22_tpu_torch.models.vqgan.quantize import nearest_codeword_indices

    gen.reset()
    plan = gen.build_plan()
    batch = gen.step_batch(plan, 0)
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
        "x_identical_pixel_share": x_agree, "x_rgb_identical_pixel_share": rgb_agree,
        "latent_max_err_rel": latent_rel,
        "index_agreement_gpu_vs_cpu_latents": float((idx.cpu() == idx_c).float().mean()),
        "rgb_max_abs_err": rgb_err, "depth_max_rel_err": depth_rel,
    }
    res["ok"] = x_agree >= 0.999 and latent_rel <= 1e-4 and rgb_err <= 1e-3 and depth_rel <= 1e-3
    if not res["ok"]:
        failures.append(f"GPU vs CPU parity: {res}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true", help="profile one more unroll")
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

    # 1. build
    t0 = time.perf_counter()
    ptxas = cuda_build.build("zbuffer_min", "nearest_codeword")
    secs = time.perf_counter() - t0
    report["build"] = {"seconds": secs, "built": sorted(ptxas)}
    if args.out:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "chip_smoke_ptxas.txt").write_text("\n".join(f"--- {k}\n{v}" for k, v in ptxas.items()))
    emit({"phase": "build", **report["build"], "card": card})

    # the flagship model with seeded random weights, on the CPU and the card
    cpu_model = VQModel(flagship_config())
    load_into(cpu_model, random_state_dict(cpu_model, SEED))
    cpu_model.eval()
    rng = np.random.default_rng(SEED)
    seeds = [((0, 0), rng.uniform(-1, 1, (H, W, 3)).astype(np.float32),
              rng.uniform(8, 14, (H, W)).astype(np.float32))]
    cfg = SceneGenConfig(dataset="clevr-infinite", output_dim=(FRAMES + 1, 1), topk=1, image_resolution=(H, W))
    gen = InfiniteSceneGeneration(copy.deepcopy(cpu_model), cfg, seeds, device="cuda")

    # 2. kernels against their plain versions
    kernels = [check_zbuffer(torch, np, gen, failures), check_nearest_codeword(torch, gen.model, failures)]
    emit({"phase": "kernels", "kernels": kernels})

    # 3. the flythrough: one warm-up unroll, then one timed unroll whose
    #    kernel launches are counted
    t0 = time.perf_counter()
    gen.scene_expansion()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    gen.reset()
    torch.cuda.synchronize()
    zbuffer_min.launches = nearest_codeword.launches = 0
    t0 = time.perf_counter()
    rgb, depth = gen.scene_expansion()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"zbuffer_min": zbuffer_min.launches, "nearest_codeword": nearest_codeword.launches}
    finite = bool(torch.isfinite(rgb).all() and torch.isfinite(depth).all())
    unroll = {
        "frames": FRAMES, "seconds": dt, "frames_per_s": FRAMES / dt,
        "ms_per_frame": dt / FRAMES * 1e3, "warmup_seconds": warm,
        "launches": launches, "finite": finite, "card": card,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "gflop_per_frame": model_gflop(torch, flagship_config()),
    }
    gflop = sum(unroll["gflop_per_frame"].values())
    unroll["model_tflop_per_s"] = gflop * FRAMES / dt / 1e3
    unroll["model_bound_ms_per_frame"] = gflop * 1e9 / F32_FLOP_PER_S * 1e3
    emit({"phase": "unroll", **unroll})
    if not finite:
        failures.append("non-finite frames in the unroll")
    if any(n != FRAMES for n in launches.values()):
        failures.append(f"launch counts {launches} != {FRAMES} frames")
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["kernel_ms"] = k["ms"]
    if args.profile:
        report["profile"] = profile_unroll(torch, gen, dt)
        emit({"phase": "profile", **{k: v for k, v in report["profile"].items() if k != "top"}})

    # 4. one full-width step on the card against the CPU
    parity = parity_step(torch, gen, cpu_model, failures)
    emit({"phase": "parity", **parity})

    report.update(kernels=kernels, unroll=unroll, parity=parity, failures=failures)
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
