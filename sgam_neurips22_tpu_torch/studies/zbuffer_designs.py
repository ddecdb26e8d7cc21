"""The z-buffer merge's designs at chip_smoke.py's cases, on one card.

    python3 -m sgam_neurips22_tpu_torch.studies.zbuffer_designs [--out DIR]

From the repository root (chip_smoke.py's cases, from `studies/cases`). It builds
`zbuffer_designs.cu` beside this file (the designs that were measured and
rejected) and the shipped `csrc/zbuffer_min.cu`, checks every design
bit-exact against `zbuffer_min_plain` at every case, and prints one JSON
line a case with each design's device time per call in us (profiler; the
INT32_MAX fill included wherever the design needs one):

- pr1, shipped: the first port's kernel and the shipped routes at the
  plan's launch shape, in turns (pr1, shipped, shipped, pr1), each also as
  the kernel alone (`*_kernel`: the fill left out);
- readonly: a 16-byte read of pix and key, the best of 528 and 1056 blocks;
- tile_128, tile_200: the shipped tile route with a window of 128 or 200
  KiB, 128 blocks over the batch; l2_shipped: the shipped l2 route;
- l2_contiguous, l2_skip, l2_fold: L2 atomics with 16-byte loads and a
  contiguous part a block (264 blocks over the batch), without or with
  pr1's read of the winner, or with the fill behind a grid barrier;
  tile_fold: the tile route (200 KiB) with the fill behind a grid barrier;
- cluster, bin: thread-block clusters with the image in distributed shared
  memory (remote shared atomics; a counting sort and pulled runs), the best
  of C = 4, 8, 16 with about 128 blocks over the batch (`*_config`).

Then the batch-1 unroll's own z-buffer inputs (24 flagship frames, seeded
random weights) and each case's collision case (`cases.collision_case`),
pr1 against shipped in turns. --out DIR writes all of it to
DIR/zbuffer_designs.json.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
SMEM_MAX = 232448


def build(cuda_build) -> ctypes.CDLL:
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = cuda_build.BUILD_DIR / "libzbuffer_designs.so"
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(tmp), str(HERE / "zbuffer_designs.cu")],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    v, i = ctypes.c_void_p, ctypes.c_int
    for name, args in (("zs_pr1", [v] * 3 + [i] * 3 + [v]),
                       ("zs_readonly", [v, v, ctypes.c_longlong, v, i, v]),
                       ("zs_cluster", [v] * 3 + [i] * 6 + [v]),
                       ("zs_bin", [v] * 3 + [i] * 6 + [v]),
                       ("zs_tile_fold", [v] * 3 + [i] * 7 + [v]),
                       ("zs_l2v", [v] * 3 + [i] * 6 + [v])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = ctypes.c_int
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from sgam_neurips22_tpu_torch.ops import cuda_build, zbuffer as zb
    from sgam_neurips22_tpu_torch.studies import cases as cs
    from sgam_neurips22_tpu_torch.utils import trace_events as te

    if not torch.cuda.is_available():
        print("zbuffer_designs: needs a GPU", file=sys.stderr)
        return 1
    print(te.card_line(), flush=True)
    lib = build(cuda_build)
    shipped = cuda_build.library("zbuffer_min", zb._SIGNATURES)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def check(rc):
        if rc != 0:
            raise RuntimeError(f"CUDA error {rc}")

    def filled(b, n):
        return torch.full((b, n), zb.IMAX, dtype=torch.int32, device="cuda")

    def pr1(pix, key, h, w):
        out = filled(pix.shape[0], h * w)
        check(lib.zs_pr1(pix.data_ptr(), key.data_ptr(), out.data_ptr(), *pix.shape, h * w, stream()))
        return out

    def route(name, parts, segments=1, rows=0):
        def f(pix, key, h, w):
            out = filled(pix.shape[0], h * w)
            check(shipped.zbuffer_min_launch(pix.data_ptr(), key.data_ptr(), out.data_ptr(), *pix.shape, h, w,
                                             zb.ROUTES.index(name), parts, segments, rows, stream()))
            return out
        return f

    def l2v(parts, skip, fold):
        def f(pix, key, h, w):
            b, n = pix.shape[0], h * w
            out = torch.empty((b, n), dtype=torch.int32, device="cuda") if fold else filled(b, n)
            check(lib.zs_l2v(pix.data_ptr(), key.data_ptr(), out.data_ptr(), *pix.shape, n, parts, skip, fold, stream()))
            return out
        return f

    def tile_fold(parts, segments, rows):
        def f(pix, key, h, w):
            out = torch.empty((pix.shape[0], h * w), dtype=torch.int32, device="cuda")
            check(lib.zs_tile_fold(pix.data_ptr(), key.data_ptr(), out.data_ptr(), *pix.shape, h, w, parts, segments,
                                   rows, stream()))
            return out
        return f

    def clustered(kind, c, k, segments):
        def f(pix, key, h, w):
            b, n = pix.shape[0], h * w
            out = filled(b, n) if k > 1 else torch.empty((b, n), dtype=torch.int32, device="cuda")
            if kind == "cluster":
                check(lib.zs_cluster(pix.data_ptr(), key.data_ptr(), out.data_ptr(), *pix.shape, n, c, k, segments,
                                     stream()))
            else:
                check(lib.zs_bin(pix.data_ptr(), key.data_ptr(), out.data_ptr(), *pix.shape, n, c, k, 8, stream()))
            return out
        return f

    def us(fn, match=None, iters=20):
        ms = te.device_ms(torch, fn, iters=iters, match=match)
        if ms is None or te.PROFILER_MISSES:
            raise RuntimeError("torch.profiler recorded no device time: this study needs its trace")
        return ms * 1e3

    def exact(fn, pix, key, h, w, ref):
        out = fn(pix, key, h, w)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"{fn} differs from zbuffer_min_plain")

    def turns(pix, key, h, w):
        t = {"pr1": [], "shipped": [], "pr1_kernel": [], "shipped_kernel": []}
        for who in ("pr1", "shipped", "shipped", "pr1"):
            fn = pr1 if who == "pr1" else zb.zbuffer_min
            t[who].append(us(lambda: fn(pix, key, h, w)))
            t[who + "_kernel"].append(us(lambda: fn(pix, key, h, w), match="pr1_kernel|zbuffer_tile|zbuffer_l2"))
        return {k: sum(v) / len(v) for k, v in t.items()}

    from types import SimpleNamespace

    from sgam_neurips22_tpu_torch.pipeline.trajectory import prepare_grid

    gen = SimpleNamespace(grid=prepare_grid("clevr-infinite", (cs.FRAMES + 1, 1)), device="cuda")
    rng = np.random.default_rng(cs.SEED)
    scratch = torch.empty(1 << 12, dtype=torch.int32, device="cuda")
    report = {"card": te.card_line(), "cases": [], "collisions": []}
    for name, (pix, key, h, w) in cs.zbuffer_cases(torch, np, gen, rng).items():
        b, p = pix.shape
        n = h * w
        ref = zb.zbuffer_min_plain(pix, key, h, w)
        plan = zb.zbuffer_plan(b, p, h, w)
        segments = p // n if p >= n and p % n == 0 else 1
        designs = {"l2_shipped": route("l2", max(1, -(-zb.L2_BLOCKS // b))),
                   "l2_contiguous": l2v(max(1, 264 // b), 0, 0), "l2_skip": l2v(max(1, 264 // b), 1, 0),
                   "l2_fold": l2v(max(1, 264 // b), 0, 1)}
        for kib in (128, 200):
            rows = min(h, kib * 1024 // (4 * w))
            designs[f"tile_{kib}"] = route("tile", max(1, 128 // b), segments, rows)
        designs["tile_fold"] = tile_fold(max(1, 128 // b), segments, min(h, 200 * 1024 // (4 * w)))
        for kind in ("cluster", "bin"):
            for c in (4, 8, 16):
                band = (-(-n // c) + 3) // 4 * 4
                if band * 4 + (512 * 8 * 8 if kind == "bin" else 0) <= SMEM_MAX - 1024:
                    designs[f"{kind}_c{c}"] = clustered(kind, c, max(1, 128 // (b * c)), segments)
        row = {"case": name, "shape": [b, p], "pixels": n, "plan": plan._asdict(), **turns(pix, key, h, w)}
        row["readonly"] = min(us(lambda: check(lib.zs_readonly(pix.data_ptr(), key.data_ptr(), pix.numel(),
                                                               scratch.data_ptr(), blocks, stream())))
                              for blocks in (528, 1056))
        for dn, fn in designs.items():
            exact(fn, pix, key, h, w, ref)
            row[dn] = us(lambda: fn(pix, key, h, w))
        for kind in ("cluster", "bin"):
            best = min((k for k in row if k.startswith(kind + "_c")), key=row.get, default=None)
            if best:
                row[kind], row[kind + "_config"] = row[best], best
        print(json.dumps(row), flush=True)
        report["cases"].append(row)
        cpix, ckey = cs.collision_case(torch, rng, b, p, "cuda")
        cref = zb.zbuffer_min_plain(cpix, ckey, h, w)
        for fn in (pr1, zb.zbuffer_min):
            exact(fn, cpix, ckey, h, w, cref)
        crow = {"case": name + " collisions", **turns(cpix, ckey, h, w)}
        print(json.dumps(crow), flush=True)
        report["collisions"].append(crow)

    report["unroll_frames"] = unroll_frames(torch, np, cs, pr1, zb, us, exact)
    print(json.dumps({"unroll_frames": report["unroll_frames"]}), flush=True)
    if args.out:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "zbuffer_designs.json").write_text(json.dumps(report, indent=1))
    return 0


def unroll_frames(torch, np, cs, pr1, zb, us, exact) -> dict:
    """pr1 against the shipped kernel, in turns, on the z-buffer inputs of
    the batch-1 flythrough unroll's 24 frames (the flagship model with
    seeded random weights), us a frame."""
    from sgam_neurips22_tpu_torch.core.state_dict import load_into, random_state_dict
    from sgam_neurips22_tpu_torch.geometry import splat
    from sgam_neurips22_tpu_torch.models.vqgan.model import VQModel
    from sgam_neurips22_tpu_torch.pipeline.scene_generation import InfiniteSceneGeneration, SceneGenConfig
    from sgam_neurips22_tpu_torch.serving import flagship_config

    model = VQModel(flagship_config())
    load_into(model, random_state_dict(model, cs.SEED))
    model.eval()
    cfg = SceneGenConfig(dataset="clevr-infinite", output_dim=(cs.FRAMES + 1, 1), topk=1,
                         image_resolution=(cs.H, cs.W))
    gen = InfiniteSceneGeneration(model, cfg, cs.seed_frames(np, np.random.default_rng(cs.SEED)), device="cuda")
    frames, kernel = [], splat.zbuffer_min

    def capture(pix, key, h, w):
        frames.append((pix.clone(), key.clone(), h, w))
        return kernel(pix, key, h, w)

    splat.zbuffer_min = capture
    try:
        gen.scene_expansion()
    finally:
        splat.zbuffer_min = kernel
    for f in frames:
        for fn in (pr1, zb.zbuffer_min):
            exact(fn, *f, zb.zbuffer_min_plain(*f))
    t = {"pr1": [], "shipped": []}
    for who in ("pr1", "shipped", "shipped", "pr1"):
        fn = pr1 if who == "pr1" else zb.zbuffer_min
        t[who].append(us(lambda: [fn(*f) for f in frames], iters=10) / len(frames))
    return {"frames": len(frames), "valid_points": [int((f[1] != zb.IMAX).sum()) for f in frames],
            "plan": zb.zbuffer_plan(*frames[0][0].shape, frames[0][2], frames[0][3])._asdict(),
            **{k: sum(v) / len(v) for k, v in t.items()}, "turns": t}


if __name__ == "__main__":
    sys.path.insert(0, os.getcwd())
    sys.exit(main())
