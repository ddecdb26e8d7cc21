"""The bf16 training step's parity on one card at more seeds than
chip_smoke.py's one.

    python3 -m sgam_neurips22_tpu_torch.studies.bf16_train_parity [--seeds 1 2 3] [--out DIR]

From the repository root (it runs `studies.cases.parity_train_bf16`, chip_smoke.py's phase). For each
seed s: model weights from s and the batch from numpy seed s + 2; the
conditional step at batch 2 in f32 on the CPU, in bf16 on the CPU and on
the card, and on the card with dV zeroed (the planted fault), at a
codebook where no latent changes codeword. Prints one JSON line a seed:
each bf16 run's distance from the f32 step in every log (d_weight among
them), its gradients' worst and median L2 distance and the range of their
norms over the f32 step's, whether the gates held and whether the planted
fault failed them; --out DIR also writes DIR/bf16_train_parity.json with
the per-tensor distances and norm ratios.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from sgam_neurips22_tpu_torch.core.device import resolve_device
    from sgam_neurips22_tpu_torch.ops import cuda_build
    from sgam_neurips22_tpu_torch.studies.cases import parity_train_bf16
    from sgam_neurips22_tpu_torch.utils.trace_events import card_line

    resolve_device("cuda")
    print(card_line(), flush=True)
    cuda_build.build("zbuffer_min", "nearest_codeword", "flash_attention_fwd", "flash_attention_dq",
                     "flash_attention_dkv")
    rows, ok = [], True
    for seed in args.seeds:
        failures: list[str] = []
        res = parity_train_bf16(torch, np, failures, seed=seed, batch_seed=seed + 2)
        rows.append(res)
        ok = ok and res["ok"]
        line = {"seed": seed, "ok": res["ok"], "control_fails": res["control_fails"]}
        for run in ("cpu", "cuda", "control"):
            r = res[run]
            line[run] = {"d_weight_rel_err_vs_f32": r["log_err_vs_f32"]["train/d_weight"]
                         / abs(res["f32_logs"]["train/d_weight"]),
                         "log_err_vs_f32": r["log_err_vs_f32"], "logs_ok": r["logs_ok"],
                         "grad_worst_vs_f32": r["grad_worst_vs_f32"], "grad_median_vs_f32": r["grad_median_vs_f32"],
                         "grad_norm_ratio_range": r["grad_norm_ratio_range"], "grad_norm_off": r["grad_norm_off"],
                         "grads_ok": r["grads_ok"],
                         "index_is_own_row": r["index_is_own_row"]}
        print(json.dumps(line), flush=True)
    if args.out:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "bf16_train_parity.json").write_text(json.dumps({"card": card_line(), "seeds": rows}, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
