"""The map's grid accumulation (`ops/grid_accumulate`) on the card: what its
callers give it, and its routes against each other.

    python3 -m sgam_neurips22_tpu_torch.studies.grid_accumulate capture --out DIR
    python3 -m sgam_neurips22_tpu_torch.studies.grid_accumulate routes --inputs DIR --out DIR

From the repository root, on a machine with a card (chip_smoke.py's cases
and helpers come from `studies/cases` and `utils/trace_events`).

- capture: runs the four map callers of chip_smoke (bf16, seeded random
  weights): CLEVR 3x3, google_earth 13x1, CLEVR stride 2 on 2x2 and the
  8-scene CLEVR map on 5x5, captures integrate's inputs at each one's last
  step, and reports per case the samples, key bits, touched voxels, zero
  addends, voxel 0's run and the longest other run (chip_smoke
  `grid_input_stats`), the op's and the first route's device time split
  by kernel in launch order (`kernel_split`), and `index_add_` and
  `index_put_(accumulate=True)` beside them. It writes DIR/capture.json and DIR/inputs_<case>.npz (the
  samples, and the grid's values at the touched voxels only).
- routes: on those inputs (the grid rebuilt as zeros but at the touched
  voxels) and on small made-up cases (-0.0 grids, +0.0 and -0.0 addends,
  one key, N = 0 and 1, a ragged N, V = 2^20 + 1, keys outside [0, V)),
  every digit width of the CUDA route against index_add_ on the
  CPU, bit for bit; then at each case the first route (torch.sort, a
  gather, the walk: chip_smoke's
  `grid_accumulate_sorted`) and the default route timed
  in turns (old, new, new, old), the default's split by kernel, two runs
  bit-equal, and one call under torch.cuda.set_sync_debug_mode("error").
  It writes DIR/routes.json.

Every line carries the card's name and power limit (nvidia-smi).
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from sgam_neurips22_tpu_torch.studies import cases as cs
from sgam_neurips22_tpu_torch.utils import trace_events as te

DIGIT_BITS = (8, 9, 10)  # the CUDA route's widest digit


def capture(cs, out: Path, card: str) -> None:
    from sgam_neurips22_tpu_torch.core.state_dict import load_into, random_state_dict
    from sgam_neurips22_tpu_torch.models.vqgan.model import VQModel
    from sgam_neurips22_tpu_torch.ops import cuda_build
    from sgam_neurips22_tpu_torch.ops.grid_accumulate import grid_accumulate, grid_accumulate_plain
    from sgam_neurips22_tpu_torch.pipeline.scene_generation import InfiniteSceneGeneration
    from sgam_neurips22_tpu_torch.serving import flagship_config

    cuda_build.build("zbuffer_min", "nearest_codeword", "flash_attention_fwd", "grid_accumulate")
    cpu_model = VQModel(flagship_config())
    load_into(cpu_model, random_state_dict(cpu_model, cs.SEED))
    cpu_model16 = VQModel(flagship_config(compute_dtype="bfloat16"))
    cpu_model16.load_state_dict(cpu_model.state_dict())
    cpu_model16.eval()
    rng = np.random.default_rng(cs.SEED)  # drawn in chip_smoke's order
    seeds = cs.seed_frames(np, rng)
    seeds_batch = [cs.seed_frames(np, rng) for _ in range(cs.SCENES)]
    cs.seed_frames(np, rng, (0.5, 4.0))  # the google_earth flythrough's seed
    cases = {}
    gen_map = InfiniteSceneGeneration(copy.deepcopy(cpu_model16), cs.map_config("clevr-infinite", cs.MAP_GRID), seeds,
                                      device="cuda")
    gen_map.reset()
    gen_map.scene_expansion()
    cases["map_clevr_last_step"] = cs.capture_grid_inputs(torch, gen_map)
    ge_model = VQModel(flagship_config("google_earth", "bfloat16"))
    load_into(ge_model, random_state_dict(ge_model, cs.SEED))
    gen = InfiniteSceneGeneration(ge_model, cs.map_config("google_earth", (cs.GE_MAP_FRAMES + 1, 1)),
                                  cs.seed_frames(np, rng, (0.5, 4.0)), device="cuda")
    gen.reset()
    gen.scene_expansion()
    cases["map_google_earth_last_step"] = cs.capture_grid_inputs(torch, gen)
    gen = InfiniteSceneGeneration(gen_map.model, cs.map_config("clevr-infinite", cs.MAP_STRIDE2_GRID, stride=2), seeds,
                                  device="cuda")
    gen.reset()
    gen.scene_expansion()
    cases["map_clevr_stride2_last_step"] = cs.capture_grid_inputs(torch, gen)
    gen = InfiniteSceneGeneration(gen_map.model, cs.map_config("clevr-infinite", cs.MAP_BATCH_GRID), seeds,
                                  device="cuda")
    _, depth = gen.scene_expansion_batched(seeds_batch)
    cases["map_clevr_8_scenes_last_step"] = cs.capture_grid_inputs_batched(torch, gen, depth)
    del gen, gen_map, ge_model, depth
    torch.cuda.empty_cache()

    res = {"card": card}
    for name, c in cases.items():
        grid, idx, vals = c["grid"], c["idx"], c["vals"]
        row = cs.grid_input_stats(torch, grid, idx, vals)
        work, lib_idx = grid.clone(), idx.long()
        row["split"] = te.kernel_split(torch, lambda: grid_accumulate(work, idx, vals))
        row["ms"] = te.device_ms(torch, lambda: grid_accumulate(work, idx, vals))
        row["call_ms"] = te.cuda_ms(torch, lambda: grid_accumulate(work, idx, vals))
        row["old_split"] = te.kernel_split(torch, lambda: cs.grid_accumulate_sorted(torch, work, idx, vals))
        row["old_ms"] = te.device_ms(torch, lambda: cs.grid_accumulate_sorted(torch, work, idx, vals))
        row["index_add_ms"] = te.device_ms(torch, lambda: grid_accumulate_plain(work, idx, vals))
        row["index_put_ms"] = te.device_ms(torch, lambda: work.index_put_((lib_idx,), vals, accumulate=True))
        res[name] = row
        print(json.dumps({"case": name, "card": card, **row}), flush=True)
        keys = torch.unique(idx)
        np.savez_compressed(out / f"inputs_{name}.npz", idx=idx.cpu().numpy(), vals=vals.cpu().numpy(),
                            keys=keys.cpu().numpy(), grid_at_keys=grid[keys.long()].cpu().numpy(),
                            voxels=np.int64(grid.numel()))
    (out / "capture.json").write_text(json.dumps(res, indent=1))


def small_cases() -> dict:
    """Made-up cases: (grid, idx, vals) as numpy arrays."""
    rng = np.random.default_rng(20)
    neg0, pos0 = np.float32(-0.0), np.float32(0.0)
    cases = {}
    g = rng.normal(0, 1, 64).astype(np.float32)
    g[[1, 2, 3, 4]] = neg0
    idx = np.r_[np.zeros(5000), [1, 1, 2, 2, 3, 3, 3, 4, 4], rng.integers(5, 64, 3000)].astype(np.int32)
    vals = np.r_[np.zeros(5000, np.float32), [pos0, neg0, neg0, neg0, 0.5, -0.5, pos0, neg0, pos0],
                 rng.choice(np.float32([0.25, -0.25, 0.125, 0.0, -0.0]), 3000)].astype(np.float32)
    cases["zeros_and_neg_zero_grid"] = (g, idx, vals)
    cases["empty"] = (g, np.zeros(0, np.int32), np.zeros(0, np.float32))
    cases["one_sample"] = (g, np.int32([63]), np.float32([1.5]))
    v = (1 << 20) + 1
    n = 3 * 2048 + 77
    idx = rng.integers(v - 40, v, n).astype(np.int32)
    cases["ragged_top_keys"] = (rng.normal(0, 1, v).astype(np.float32), idx,
                                rng.normal(0, 1, n).astype(np.float32))
    cases["one_key"] = (g, np.full(20000, 7, np.int32), rng.normal(0, 1, 20000).astype(np.float32))
    idx = rng.integers(-5, 69, 4000).astype(np.int32)
    cases["keys_outside"] = (g, idx, rng.normal(0, 1, 4000).astype(np.float32))
    return cases


def reference(grid: np.ndarray, idx: np.ndarray, vals: np.ndarray) -> torch.Tensor:
    """index_add_ on the CPU over the keys inside [0, V) (the card drops the rest)."""
    keep = (idx >= 0) & (idx < grid.size)
    return torch.as_tensor(grid.copy()).index_add_(0, torch.as_tensor(idx[keep]), torch.as_tensor(vals[keep]))


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.cpu().view(torch.int32), b.cpu().view(torch.int32))


def routes(cs, inputs: Path, out: Path, card: str) -> int:
    from sgam_neurips22_tpu_torch.ops import cuda_build
    from sgam_neurips22_tpu_torch.ops import grid_accumulate as acc

    t0 = time.perf_counter()
    report = cuda_build.build("grid_accumulate")
    res = {"card": card, "ptxas": cs.ptxas_summary(report), "build_seconds": time.perf_counter() - t0, "small": {},
           "cases": {}}
    print(json.dumps({"build": res["ptxas"], "card": card}), flush=True)
    failures = []
    for name, (g, idx, vals) in small_cases().items():
        ref = reference(g, idx, vals)
        row = {}
        for mb in DIGIT_BITS:
            grid = torch.as_tensor(g, device="cuda").clone()
            acc.launch(grid, torch.as_tensor(idx, device="cuda"), torch.as_tensor(vals, device="cuda"), mb)
            torch.cuda.synchronize()
            row[f"{mb} bits"] = bits_equal(grid, ref)
        res["small"][name] = row
        print(json.dumps({"small": name, **row}), flush=True)
        if not all(row.values()):
            failures.append(f"small case {name}: {row}")

    for path in sorted(inputs.glob("inputs_*.npz")):
        name = path.stem[len("inputs_"):]
        z = np.load(path)
        grid0 = torch.zeros(int(z["voxels"]), device="cuda")
        grid0[torch.as_tensor(z["keys"], device="cuda").long()] = torch.as_tensor(z["grid_at_keys"], device="cuda")
        idx, vals = torch.as_tensor(z["idx"], device="cuda"), torch.as_tensor(z["vals"], device="cuda")
        ref = acc.grid_accumulate_plain(grid0.cpu(), idx.cpu(), vals.cpu())
        row = {"samples": idx.numel(), "voxels": grid0.numel(),
               "plan": acc.digit_plan(grid0.numel()), "configs": {}}
        for mb in DIGIT_BITS:
            grid = grid0.clone()
            acc.launch(grid, idx, vals, mb)
            torch.cuda.synchronize()
            work = grid0.clone()
            row["configs"][f"{mb} bits"] = {
                "bit_exact": bits_equal(grid, ref), "passes": len(acc.digit_plan(grid0.numel(), mb)),
                "ms": te.device_ms(torch, lambda: acc.launch(work, idx, vals, mb)),
                "call_ms": te.cuda_ms(torch, lambda: acc.launch(work, idx, vals, mb)),
                "split": te.kernel_split(torch, lambda: acc.launch(work, idx, vals, mb))}
            if not row["configs"][f"{mb} bits"]["bit_exact"]:
                failures.append(f"{name} {mb} bits not bit-exact")
        work = grid0.clone()
        new = lambda: acc.grid_accumulate(work, idx, vals)  # noqa: E731
        old = lambda: cs.grid_accumulate_sorted(torch, work, idx, vals)  # noqa: E731
        turns = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            fn = old if which == "old" else new
            turns[which].append({"ms": te.device_ms(torch, fn), "call_ms": te.cuda_ms(torch, fn)})
        row["turns"] = turns
        row["split"] = te.kernel_split(torch, new)
        row["old_split"] = te.kernel_split(torch, old)
        a, b = grid0.clone(), grid0.clone()
        acc.grid_accumulate(a, idx, vals)
        acc.grid_accumulate(b, idx, vals)
        o = grid0.clone()
        cs.grid_accumulate_sorted(torch, o, idx, vals)
        row.update(deterministic=bits_equal(a, b), bit_exact=bits_equal(a, ref), old_bit_exact=bits_equal(o, ref))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            acc.grid_accumulate(a, idx, vals)
            row["sync_free"] = True
        except RuntimeError as e:
            row["sync_free"] = f"synchronised: {str(e)[:200]}"
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        if not (row["deterministic"] and row["bit_exact"] and row["sync_free"] is True):
            failures.append(f"{name}: {row}")
        res["cases"][name] = row
        print(json.dumps({"case": name, "card": card, **row}), flush=True)
        del grid0, ref, work, a, b, o
        torch.cuda.empty_cache()
    res["failures"] = failures
    (out / "routes.json").write_text(json.dumps(res, indent=1))
    print(json.dumps({"failures": failures, "card": card}), flush=True)
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("phase", choices=("capture", "routes"))
    ap.add_argument("--inputs", type=Path, default=None, help="routes: the capture's directory")
    ap.add_argument("--out", type=Path, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("grid_accumulate study: no CUDA device", file=sys.stderr)
        return 2

    args.out.mkdir(parents=True, exist_ok=True)
    card = te.card_line()
    if args.phase == "capture":
        capture(cs, args.out, card)
        return 0
    return routes(cs, args.inputs or args.out, args.out, card)


if __name__ == "__main__":
    sys.exit(main())
