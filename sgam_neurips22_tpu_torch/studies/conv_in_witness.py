"""A float64 witness for `conv_in.bias`, the tensor behind two readings of
the training step (the bf16 gradient far from the f32 one; the f32 Adam
moment past the CPU test's tolerance at batch 8 with LPIPS).

    python tests/torch_port_conv_in_jax.py --out W.pkl [--seeds 0 1 2 3]
    python -m sgam_neurips22_tpu_torch.studies.conv_in_witness --jax W.pkl [--out DIR]

On the CPU. The first command (a test-side script: it imports JAX, which
this package never does) writes, for each seed and case, JAX's initial
training state, its state after step 1 and conv_in.bias's Adam first
moment after steps 1 and 2 of the JAX `train_step`. This study then runs
the same cases in the port (the TINY conditional model with flash
attention, CASES: batch 2 and 8, with and without LPIPS, f32 and bf16):

- the port's `train_step` from JAX's initial weights (step 1), then from
  JAX's weights after step 1 with its own moments (step 2), as
  tests/test_torch_port_training.py runs it;
- the witness: the same two gradients in float64 (`_ae_loss` on the f32
  conditioning, flash attention's plain versions), and the moment Adam
  makes of them;
- the cancellation of the bias gradient, a sum over every pixel of the
  batch: per channel sum |d loss / d conv_in(x)| over |sum|, from the
  float64 run, and the rounding that sum can carry in the run's dtype
  (unit roundoff x sum of |terms|, relative to the gradient).

Each case prints one JSON line: the gradient at step 1 and the moment
after step 2 from the port, JAX and float64, their distances (max abs
difference over the float64 tensor's largest), the cancellation, and a
verdict: "cancellation" where the port is no farther from float64 than
three times the larger of JAX's distance and the sum's rounding scale;
"cancellation (oneDNN)" where only the port's f32 run with oneDNN off
(`torch.backends.mkldnn`, run beside it: the CPU's default f32
convolutions, which XLA:CPU does not use, round more) is; "fault"
otherwise.
"""
from __future__ import annotations

import argparse
import json
import pickle
import sys
from pathlib import Path

import numpy as np

TENSOR = "conv_in.bias"
BETA1 = 0.5  # the step's Adam betas are (0.5, 0.9)
LR = 1e-3
# the TINY conditional model of the port's tests (tests/torch_port_common.py), flash attention on
DDCONFIG = dict(ch=32, out_ch=4, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=16,
                z_channels=32, in_channels=4, flash_attention=True)
MODEL = dict(n_embed=32, embed_dim=16, phase="conditional_generation", dataset="clevr-infinite",
             depth_range=(7.0, 16.0))
LOSS = dict(disc_start=0, disc_num_layers=2)
CASES = [(b, lpips, dtype) for b in (2, 8) for lpips in (False, True) for dtype in ("float32", "bfloat16")]
UNIT_ROUNDOFF = {"float32": 2.0 ** -24, "bfloat16": 2.0 ** -8}


def case_key(seed: int, b: int, lpips: bool, dtype: str) -> str:
    return f"seed{seed}_b{b}_{'lpips' if lpips else 'nolpips'}_{dtype}"


def cond_batch(b: int, seed: int, n: int = 2, res: int = 32) -> dict:
    """A conditional batch of numpy arrays from numpy seed `seed` (the
    layout of tests/test_training.py's make_cond_batch)."""
    rng = np.random.default_rng(seed)
    k = np.array([[20.0, 0, (res - 1) / 2], [0, 20.0, (res - 1) / 2], [0, 0, 1]], np.float32)
    return {
        "dst_img": rng.uniform(-1, 1, (b, res, res, 3)).astype(np.float32),
        "dst_depth": rng.uniform(8, 14, (b, res, res)).astype(np.float32),
        "src_imgs": rng.uniform(-1, 1, (b, n, res, res, 3)).astype(np.float32),
        "src_depths": rng.uniform(8, 14, (b, n, res, res)).astype(np.float32),
        "Ks": np.ascontiguousarray(np.broadcast_to(k, (b, n, 3, 3))),
        "R_rels": np.ascontiguousarray(np.broadcast_to(np.eye(3, dtype=np.float32), (b, n, 3, 3))),
        "t_rels": np.zeros((b, n, 3), np.float32),
        "src_masks": np.ones((b, n), np.float32),
    }


def train_config(lpips: bool, dtype: str):
    from sgam_neurips22_tpu_torch.models.vqgan.autoencoder import DDConfig
    from sgam_neurips22_tpu_torch.models.vqgan.model import VQModelConfig
    from sgam_neurips22_tpu_torch.training.losses import LossConfig
    from sgam_neurips22_tpu_torch.training.train_step import TrainConfig

    model = VQModelConfig(ddconfig=DDConfig(**DDCONFIG, compute_dtype=dtype), **MODEL)
    return TrainConfig(model=model, loss=LossConfig(**LOSS, perceptual_weight=1.0 if lpips else 0.0),
                       learning_rate=LR)


def _state(torch, cfg, trees: dict, lpips_tree):
    from sgam_neurips22_tpu_torch.core.state_dict import load_jax_training
    from sgam_neurips22_tpu_torch.training.lpips import LPIPS
    from sgam_neurips22_tpu_torch.training.train_step import create_train_state

    state = create_train_state(cfg, seed=0, device="cpu")
    lp = None if lpips_tree is None else LPIPS()
    load_jax_training(state.model, state.disc, trees["params"], trees["disc_params"], trees["disc_state"], lp,
                      lpips_tree)
    return state, lp


def port_run(torch, cfg, batch: dict, init: dict, after1: dict, lpips_tree) -> dict:
    """The port's train_step, step 1 from `init`, step 2 from JAX's state
    `after1` with the port's own moments: conv_in.bias's gradient and
    first moment after each step."""
    from sgam_neurips22_tpu_torch.core.state_dict import load_jax_training
    from sgam_neurips22_tpu_torch.training.train_step import train_step

    state, lp = _state(torch, cfg, init, lpips_tree)
    param = dict(state.model.named_parameters())[TENSOR]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    for step in (1, 2):
        if step == 2:
            load_jax_training(state.model, state.disc, after1["params"], after1["disc_params"],
                              after1["disc_state"])
        train_step(state, tb, lp, cfg)
        out[f"grad{step}"] = param.grad.double().numpy().copy()
        out[f"moment{step}"] = state.opt_ae.state[param]["exp_avg"].double().numpy().copy()
    return out


def witness_run(torch, cfg, batch: dict, init: dict, after1: dict, lpips_tree) -> dict:
    """The float64 witness: each step's conv_in.bias gradient from
    `_ae_loss` in float64 on the f32 conditioning (step 1 from `init`,
    step 2 at JAX's state `after1`), the Adam moment of the two, and the
    per-channel terms of step 1's gradient (d loss / d conv_in(x))."""
    from sgam_neurips22_tpu_torch.core.state_dict import load_jax_training
    from sgam_neurips22_tpu_torch.ops import attention
    from sgam_neurips22_tpu_torch.training.train_step import _ae_loss, model_inputs

    from dataclasses import replace

    cfg = replace(cfg, model=replace(cfg.model, ddconfig=replace(cfg.model.ddconfig, compute_dtype="float32")))
    wrappers = attention.flash_attention_fwd, attention.flash_attention_bwd
    attention.flash_attention_fwd, attention.flash_attention_bwd = (
        attention.flash_attention_plain, attention.flash_attention_bwd_plain)
    try:
        state, lp = _state(torch, cfg, init, lpips_tree)
        x, x_dst, mask = model_inputs({k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
        state.model.double()
        state.disc.double()
        if lp is not None:
            lp.double()
        param = dict(state.model.named_parameters())[TENSOR]
        seen = []

        def keep_output_grad(module, inputs, out):
            out.register_hook(seen.append)  # returns None: the output stays as it is

        hook = state.model.conv_in.register_forward_hook(keep_output_grad)
        grads = []
        for step in (1, 2):
            if step == 2:
                hook.remove()
                load_jax_training(state.model, state.disc, after1["params"], after1["disc_params"],
                                  after1["disc_state"])
            loss = _ae_loss(state.model, state.disc, lp, x.double(), x_dst.double(), mask, step - 1, cfg)[0]
            grads.append(torch.autograd.grad(loss, [param])[0].numpy().copy())
    finally:
        attention.flash_attention_fwd, attention.flash_attention_bwd = wrappers
    terms = seen[0].double()  # [B, 4, H, W]
    m1 = (1 - BETA1) * grads[0]
    return {"grad1": grads[0], "grad2": grads[1], "moment1": m1, "moment2": BETA1 * m1 + (1 - BETA1) * grads[1],
            "terms_abs_sum": terms.abs().sum(dim=(0, 2, 3)).numpy(), "terms_sum": terms.sum(dim=(0, 2, 3)).numpy()}


def rel(a, ref) -> float:
    return float(np.abs(np.asarray(a, np.float64) - ref).max() / np.abs(ref).max())


def within(dist: dict, port: str, scale: float) -> bool:
    """The port run `port` no farther from float64 than three times the
    larger of JAX's distance and the rounding scale of the sum, at step
    1's gradient and step 2's moment."""
    return all(dist[q][port] <= 3 * max(dist[q]["jax_vs_f64"], scale) for q in ("grad1", "moment2"))


def verdict(row: dict) -> str:
    if within(row["dist"], "port_vs_f64", row["rounding_scale"]):
        return "cancellation"
    if "port_no_onednn_vs_f64" in row["dist"]["grad1"] and within(row["dist"], "port_no_onednn_vs_f64",
                                                                  row["rounding_scale"]):
        return "cancellation (oneDNN)"
    return "fault"


def run_case(torch, rec: dict, seed: int, b: int, lpips: bool, dtype: str) -> dict:
    key = case_key(seed, b, lpips, dtype)
    jax_rec = rec["cases"][key]
    cfg = train_config(lpips, dtype)
    batch = cond_batch(b, seed)
    lpips_tree = rec["lpips"] if lpips else None
    init = rec["init"][seed]
    port = port_run(torch, cfg, batch, init, jax_rec["after1"], lpips_tree)
    plain = None
    if dtype == "float32":
        with torch.backends.mkldnn.flags(enabled=False):
            plain = port_run(torch, cfg, batch, init, jax_rec["after1"], lpips_tree)
    f64 = witness_run(torch, cfg, batch, init, jax_rec["after1"], lpips_tree)
    jax_q = {"grad1": np.asarray(jax_rec["moment1"], np.float64) / (1 - BETA1),
             "moment1": np.asarray(jax_rec["moment1"], np.float64),
             "moment2": np.asarray(jax_rec["moment2"], np.float64)}
    cancel = f64["terms_abs_sum"] / np.maximum(np.abs(f64["terms_sum"]), 1e-300)
    row = {"case": key, "seed": seed, "batch": b, "lpips": lpips, "dtype": dtype,
           "grad1": {"port": port["grad1"].tolist(), "jax": jax_q["grad1"].tolist(), "f64": f64["grad1"].tolist()},
           "moment2": {"port": port["moment2"].tolist(), "jax": jax_q["moment2"].tolist(),
                       "f64": f64["moment2"].tolist()},
           "dist": {q: {"port_vs_jax": rel(port[q], jax_q[q]), "port_vs_f64": rel(port[q], f64[q]),
                        "jax_vs_f64": rel(jax_q[q], f64[q])} for q in ("grad1", "moment2")},
           "cancellation_per_channel": cancel.tolist(),
           "rounding_scale": float(UNIT_ROUNDOFF[dtype] * f64["terms_abs_sum"].max() / np.abs(f64["grad1"]).max())}
    if plain is not None:
        for q in ("grad1", "moment2"):
            row["dist"][q]["port_no_onednn_vs_f64"] = rel(plain[q], f64[q])
    row["verdict"] = verdict(row)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jax", type=Path, required=True, help="tests/torch_port_conv_in_jax.py's output")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(min(torch.get_num_threads(), 4))
    with open(args.jax, "rb") as f:
        rec = pickle.load(f)
    rows = []
    for seed in rec["seeds"]:
        for b, lpips, dtype in CASES:
            if case_key(seed, b, lpips, dtype) not in rec["cases"]:
                continue
            row = run_case(torch, rec, seed, b, lpips, dtype)
            rows.append(row)
            print(json.dumps({k: row[k] for k in ("case", "dist", "cancellation_per_channel", "rounding_scale",
                                                  "verdict")}), flush=True)
    summary = {"cases": len(rows), "verdicts": {v: [r["case"] for r in rows if r["verdict"] == v]
                                                for v in sorted({r["verdict"] for r in rows})},
               "worst_port_vs_jax_moment2": max((r["dist"]["moment2"]["port_vs_jax"], r["case"]) for r in rows)}
    print(json.dumps(summary), flush=True)
    if args.out:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "conv_in_witness.json").write_text(json.dumps({"rows": rows, "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
