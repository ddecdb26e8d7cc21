"""The f32 batch-1 flythrough's time in two checkouts of the repository, on
one card, in turns.

    python3 -m sgam_neurips22_tpu_torch.studies.unroll_host_time --trees A B [--repeats 3] [--out DIR]

From the repository root. A and B are checkouts of the repository (for
example the parent commit unpacked with `git archive` into a git-ignored
directory, and `.`). The runs go A, B, B, A, each in a process of its own
whose package is that tree's: it builds the z-buffer and codeword kernels,
makes the flagship f32 model with seeded random weights, and unrolls the
(24+1) x 1 clevr-infinite flythrough from one seeded frame, as
chip_smoke.py's unroll phase does: one warm-up unroll, then REPEATS timed
unrolls (host clock, synchronized, each after an untimed reset), then one
profiled unroll for the device's busy time (CUDA activity only): the union
of the card's record intervals, read for both trees by this checkout's
`utils/trace_events`, and none where the trace lost a launch. Prints one
JSON line a run (ms per frame of each timed unroll, device busy and kernel
ms per frame, lost launches, idle share) and a last line with each tree's median; --out DIR also
writes DIR/unroll_host_time.json.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

FRAMES = 24


def child(repeats: int) -> dict:
    """One run, in the tree the process imports the package from."""
    import time

    import importlib.util

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sgam_neurips22_tpu_torch.core.device import resolve_device
    from sgam_neurips22_tpu_torch.core.state_dict import load_into, random_state_dict
    from sgam_neurips22_tpu_torch.models.vqgan.model import VQModel
    from sgam_neurips22_tpu_torch.ops import cuda_build
    from sgam_neurips22_tpu_torch.pipeline.scene_generation import InfiniteSceneGeneration, SceneGenConfig
    from sgam_neurips22_tpu_torch.serving import flagship_config

    resolve_device("cuda")
    cuda_build.build("zbuffer_min", "nearest_codeword")
    model = VQModel(flagship_config())
    load_into(model, random_state_dict(model, 0))
    model.eval()
    rng = np.random.default_rng(0)
    seeds = [((0, 0), rng.uniform(-1, 1, (256, 256, 3)).astype(np.float32),
              rng.uniform(8, 14, (256, 256)).astype(np.float32))]
    cfg = SceneGenConfig(dataset="clevr-infinite", output_dim=(FRAMES + 1, 1), topk=1, image_resolution=(256, 256))
    gen = InfiniteSceneGeneration(model, cfg, seeds, device="cuda")
    gen.reset()
    gen.scene_expansion()
    times = []
    for _ in range(repeats):
        gen.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen.scene_expansion()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / FRAMES * 1e3)
    gen.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        gen.scene_expansion()
        torch.cuda.synchronize()
    # this file's own trace reader, whichever tree the process imports the package from
    spec = importlib.util.spec_from_file_location(
        "trace_events", Path(__file__).resolve().parents[1] / "utils" / "trace_events.py")
    te = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(te)
    trace = te.from_profile(prof)
    busy = te.busy_us(trace)  # the union of the card's record intervals; None where a launch was lost
    busy = None if busy is None else busy / 1e3 / FRAMES
    return {"ms_per_frame": times, "device_busy_ms_per_frame": busy,
            "device_kernel_ms_per_frame": None if busy is None else te.kernel_us(trace) / 1e3 / FRAMES,
            "lost_launches": trace.lost,
            "device_idle_share": None if busy is None else 1.0 - busy / statistics.median(times)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", type=Path, nargs=2, metavar=("A", "B"))
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.repeats)), flush=True)
        return 0

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    a, b = (t.resolve() for t in args.trees)
    runs = []
    for tree in (a, b, b, a):
        env = {**os.environ, "PYTHONPATH": str(tree)}
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child", "--repeats", str(args.repeats)],
                             cwd=tree, env=env, capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            return 1
        runs.append({"tree": str(tree), **json.loads(out.stdout.strip().splitlines()[-1])})
        print(json.dumps(runs[-1]), flush=True)
    summary = {"card": card, "frames": FRAMES, "median_ms_per_frame": {
        str(t): statistics.median(ms for r in runs if r["tree"] == str(t) for ms in r["ms_per_frame"]) for t in (a, b)},
        "median_device_busy_ms_per_frame": {
        str(t): statistics.median(r["device_busy_ms_per_frame"] for r in runs
                                  if r["tree"] == str(t) and r["device_busy_ms_per_frame"] is not None)
        for t in (a, b)}}
    print(json.dumps(summary), flush=True)
    if args.out:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "unroll_host_time.json").write_text(json.dumps({**summary, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
