"""The control and the planted faults of a cell's comparison, read on the
card at the cell's own size: for each seed, in one process, the cell's
set-up, a short window at its own load, and its check with the control (the
plain reference one precision below the configuration's, in the program's
place), with a planted fault if asked. One JSON line a seed.

    python3 -m portbench.control --workload <name> --seeds 1 2 3 [--seconds 3] [--fault half_batch]

The lower reading of each compared number is the largest the program's
sound runs give over a dozen seeds or more, its upper reading the smallest
the control (or a fault) gives; `portbench/limits/<workload>.json` sits
between them. portbench/tests/test_portbench_card.py runs it on the card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import faults, run


def readings(workload: str, seeds, seconds: float, fault=None, device=None) -> list:
    """[{seed, readings}] of each seed's short run with the control."""
    spec = run.load_spec(workload)
    device = device or torch.device("cuda", 0)
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        cell = run.cell_driver(spec["traffic"]["kind"])(spec["config"], spec["traffic"], seed, device,
                                                        faults.FAULTS[fault] if fault else None)
        cell.setup()
        window = cell.window(seconds)
        got = cell.check(control=True)
        out.append({"seed": seed, "fault": fault, "attempted": window["attempted"],
                    "seconds": time.perf_counter() - t0, **got})
        del cell
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    for row in readings(args.workload, args.seeds, args.seconds, args.fault):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
