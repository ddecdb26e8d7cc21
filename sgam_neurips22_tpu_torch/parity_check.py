"""Checkpoint-parity harness: per-stage goldens against a reference .ckpt —
the port's counterpart of `tools/parity_check.py`, with its modes, stages,
tolerances, printed rows and exit codes:

    python -m sgam_neurips22_tpu_torch.parity_check CKPT [--config YAML] \\
        [--image PNG --depth NPY] [--dataset D] [--seed N] \\
        [--record NPZ | --compare NPZ] [--device cuda|cpu]

1) cross-check (default): load the .ckpt into the port's model, run its
   stages on --device, run the torch-functional oracle
   (`models/vqgan/torch_functional.py`) from the same .ckpt's state_dict on
   the CPU in f32, and report the encode, pre_quant, indices, quantized and
   decode diffs against the tolerances below. Where indices differ, it also
   prints how many rows differ and whether each one is an f32 near-tie
   (`ops.vq.near_ties_ok`); that line is information only.

     python -m sgam_neurips22_tpu_torch.parity_check trained_models/clevr-infinite/last.ckpt

2) record: dump per-stage golden activations to an .npz

     python -m sgam_neurips22_tpu_torch.parity_check last.ckpt --record goldens.npz

3) compare: re-run and diff against a recorded golden file (exit code 1 on
   any stage out of tolerance):

     python -m sgam_neurips22_tpu_torch.parity_check last.ckpt --compare goldens.npz

The golden files go both ways with the JAX tool's: NHWC arrays under the
same keys, the input under `input`. A file that `tools/parity_check.py
--record` writes is read by this tool's --compare, and the other way round.

Stages and tolerances (max |diff|, f32 with TF32 off, as the JAX tool's
jax_default_matmul_precision='highest'):

  encode         2e-4   conv stack: f32 accumulation-order divergence only
  pre_quant      2e-4
  indices        exact  argmin over f32 distances (ties resolved identically)
  quantized      2e-4   codebook gather of matching indices
  decode         5e-4   decoder conv stack on top of quantized
  splat          1e-5   pure geometry (no matmul accumulation)
  frame_rgb      5e-4   full conditional step, clipped RGB
  frame_depth    5e-3   metric depth via the dataset codec (1/x amplifies)

Without --config the model is `serving.flagship_config()`; the weights come
from `serving.load_inference_params`. On the card the indices stage and the
frame run the codeword search kernel (`csrc/nearest_codeword.cu`) and the
splat stage the z-buffer kernel (`csrc/zbuffer_min.cu`). Optionally pass
--image/--depth for a real template frame; otherwise a seeded random input
is used (recorded goldens embed the input, so compare runs are
input-identical either way).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

TOLERANCES = {
    "encode": 2e-4,
    "pre_quant": 2e-4,
    "indices": 0.0,
    "quantized": 2e-4,
    "decode": 5e-4,
    "splat": 1e-5,
    "frame_rgb": 5e-4,
    "frame_depth": 5e-3,
}


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def compute_stages(model, x: np.ndarray, dataset: str = "clevr-infinite") -> dict:
    """Every parity stage of the port's model on its device: {stage: NHWC
    numpy array}, the input under "input".

    The stages follow the JAX tool's `compute_stages`: encode (conv_in with
    a zero extrapolation channel, then the encoder), quant_conv, the
    nearest codeword (indices and the straight-through latents), decode
    (post_quant_conv and the decoder), the forward splat of a two-view
    geometry built from the input frame, and the deterministic (topk=1)
    conditional frame with metric depth."""
    from sgam_neurips22_tpu_torch.geometry.codec import get_codec
    from sgam_neurips22_tpu_torch.geometry.splat import render_projection_from_srcs
    from sgam_neurips22_tpu_torch.models.vqgan.quantize import quantize
    from sgam_neurips22_tpu_torch.pipeline.trajectory import default_intrinsics

    dev = model.codebook.device
    xt = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
    h, w = x.shape[1:3]
    out = {"input": np.asarray(x)}
    with torch.inference_mode():
        h_enc = model.encoder(model._fold_mask(xt, None))
        out["encode"] = _np(h_enc.permute(0, 2, 3, 1))
        pre_quant = model.quant_conv(h_enc).permute(0, 2, 3, 1).contiguous()
        out["pre_quant"] = _np(pre_quant)
        q = quantize(model.codebook, pre_quant, model.cfg.beta)
        out["indices"] = _np(q.indices)
        out["quantized"] = _np(q.z_q)
        out["decode"] = _np(model.decode(q.z_q))

        # splat stage: deterministic two-view geometry from the test frame
        codec = get_codec(dataset)
        k = np.asarray(default_intrinsics(dataset), np.float32)
        k = torch.from_numpy(k * np.array([[w / 256], [h / 256], [1]], np.float32)).to(dev)
        rgb = xt[..., :3]
        depth = codec.decode(torch.clamp(xt[..., 3], -0.99, 0.99))
        eye = torch.eye(4, dtype=torch.float32, device=dev)
        t_rel = eye.clone()
        t_rel[0, 3], t_rel[1, 3] = 0.25, -0.1
        res = render_projection_from_srcs(
            torch.stack([rgb, rgb], dim=1),
            torch.stack([depth, depth], dim=1),
            k[None],
            k.expand(1, 2, 3, 3),
            torch.stack([eye, t_rel])[None],
        )
        out["splat"] = np.concatenate([_np(res.features), _np(res.depth)], axis=-1)

        # full deterministic conditional frame (topk=1; the CLI default,
        # reference inference_pipeline.py:24)
        fres = model(xt, extrapolation_mask=torch.zeros((1, h, w, 1), dtype=torch.bool, device=dev), topk=1,
                     sample_number=1)
        xr = fres.xrec[:, 0]
        out["frame_rgb"] = _np(torch.clamp(xr[..., :3], -1.0, 1.0))
        out["frame_depth"] = _np(codec.decode(xr[..., 3]))
    return out


def compare_stages(got, want, tolerances=TOLERANCES):
    """Returns [(stage, max_diff, tol, ok)] for the stages present in both."""
    rows = []
    for stage, tol in tolerances.items():
        if stage not in got or stage not in want:
            continue
        a, b = np.asarray(got[stage]), np.asarray(want[stage])
        if stage == "indices":
            diff = float((a != b).mean())
            ok = diff == 0.0
        else:
            diff = float(np.abs(a - b).max())
            ok = diff <= tol
        rows.append((stage, diff, tol, ok))
    return rows


def index_report(got: dict, want: dict, codebook: torch.Tensor, with_z2: bool) -> tuple[int, bool] | None:
    """(rows whose codeword index differs, whether each one is an f32
    near-tie of the two codewords for the port's latent) where both sides
    have indices, else None. `with_z2`: the other side's distances carry
    ||z||^2 (the oracle's do), which widens the f32 scale of a tie."""
    from sgam_neurips22_tpu_torch.ops.vq import near_ties_ok

    if "indices" not in got or "indices" not in want or "pre_quant" not in got:
        return None
    z = torch.from_numpy(np.asarray(got["pre_quant"], np.float32)).reshape(-1, codebook.shape[1])
    idx, ref = (torch.from_numpy(np.asarray(s["indices"]).astype(np.int64).reshape(-1)) for s in (got, want))
    return near_ties_ok(z, codebook.detach().float().cpu(), idx, ref, with_z2=with_z2)


def load_test_input(args, cfg) -> np.ndarray:
    """[1, 256, 256, in_channels] f32: the --image/--depth frame (RGB in
    [-1, 1] and the scaled inverse depth; CLEVR's ray depth to z first), or
    the JAX tool's seeded uniform(-1, 1) input."""
    if args.image:
        from sgam_neurips22_tpu_torch.pipeline.trajectory import default_intrinsics
        from sgam_neurips22_tpu_torch.training.data.io import (
            encode_disparity_np,
            load_depth,
            load_rgb,
            ray_to_z_np,
        )

        rgb = load_rgb(args.image, (256, 256))
        depth = load_depth(args.depth, (256, 256))
        if args.dataset == "clevr-infinite":
            depth = ray_to_z_np(depth, default_intrinsics(args.dataset))
        disp = encode_disparity_np(depth, args.dataset)
        return np.concatenate([rgb, disp[..., None]], axis=-1)[None]
    x = np.random.default_rng(args.seed).uniform(
        -1, 1, (1, 256, 256, cfg.ddconfig.in_channels)
    ).astype(np.float32)
    print("using a random test input (pass --image/--depth for a real frame)")
    return x


def checkpoint_state_dict(path: str) -> dict:
    """The .ckpt's state_dict as numpy arrays (a Lightning .ckpt's
    `state_dict` entry, or a bare state_dict), read on the CPU."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    return {k: v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v) for k, v in sd.items()}


def torch_oracle_stages(ckpt: str, cfg, x: np.ndarray) -> dict:
    """Per-stage activations from the torch-functional oracle on the same
    weights (reference block semantics in torch.nn.functional), on the CPU
    in f32: encode, pre_quant, indices (argmin of ||z||^2 + ||e||^2 - 2
    z.e), quantized and decode."""
    import torch.nn.functional as F

    from sgam_neurips22_tpu_torch.models.vqgan import torch_functional as tfn

    sd = checkpoint_state_dict(ckpt)
    xt = tfn.t(x)
    if cfg.use_extrapolation_mask:
        xt = torch.cat([xt, torch.zeros(1, 1, *x.shape[1:3])], 1)
        xt = F.conv2d(
            xt,
            torch.from_numpy(sd["conv_in.weight"]),
            torch.from_numpy(sd["conv_in.bias"]),
        )
    enc_sd = {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}
    dec_sd = {k[len("decoder."):]: v for k, v in sd.items() if k.startswith("decoder.")}
    h_t = tfn.torch_encoder(xt, enc_sd, cfg.ddconfig)
    pq_t = F.conv2d(
        h_t, torch.from_numpy(sd["quant_conv.weight"]), torch.from_numpy(sd["quant_conv.bias"])
    )
    e = torch.from_numpy(sd["quantize.embedding.weight"])
    _, _, lh, lw = pq_t.shape
    zf = pq_t.permute(0, 2, 3, 1).reshape(-1, e.shape[1])
    d = (zf**2).sum(1, keepdim=True) + (e**2).sum(1) - 2 * zf @ e.T
    idx_t = d.argmin(1)
    zq_t = e[idx_t].reshape(1, lh, lw, -1).permute(0, 3, 1, 2)
    post_t = F.conv2d(
        zq_t, torch.from_numpy(sd["post_quant_conv.weight"]), torch.from_numpy(sd["post_quant_conv.bias"])
    )
    xrec_t = tfn.torch_decoder(post_t, dec_sd, cfg.ddconfig)
    return {
        "encode": tfn.un_t(h_t),
        "pre_quant": tfn.un_t(pq_t),
        "indices": idx_t.numpy().reshape(1, lh, lw),
        "quantized": tfn.un_t(zq_t),
        "decode": tfn.un_t(xrec_t),
    }


def model_config(config: str | None):
    """The port's VQModelConfig: `VQModelConfig.from_config` of a
    reference-schema YAML, or `serving.flagship_config()`."""
    from sgam_neurips22_tpu_torch.models.vqgan.model import VQModelConfig

    if config:
        from sgam_neurips22_tpu_torch.core.config import load_yaml

        yaml_cfg = load_yaml(config)
        return VQModelConfig.from_config(
            yaml_cfg.model.params,
            yaml_cfg.model.params.get("data_config")
            or yaml_cfg.get("data", {}).get("params", {}),
        )
    from sgam_neurips22_tpu_torch.serving import flagship_config

    return flagship_config()


def load_model(ckpt: str, cfg, device):
    """VQModel(cfg) with seeded random weights (seed 0) that the .ckpt's
    tensors replace (`serving.load_inference_params`), on `device`, eval."""
    from sgam_neurips22_tpu_torch.core.state_dict import load_into, random_state_dict
    from sgam_neurips22_tpu_torch.models.vqgan.model import VQModel
    from sgam_neurips22_tpu_torch.serving import load_inference_params

    model = VQModel(cfg)
    load_into(model, random_state_dict(model, 0))
    load_inference_params(ckpt, model)
    return model.to(device).eval()


def run(argv=None) -> tuple[int, dict]:
    """The CLI: (exit code, report). The report holds the rows, each
    stage's largest magnitude on the reference side, and the index line's
    (rows differing, all near-ties)."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("ckpt")
    p.add_argument("--config", default=None, help="trained-model YAML (reference schema)")
    p.add_argument("--image", default=None, help="test RGB png (default: random input)")
    p.add_argument("--depth", default=None, help="matching depth npy (ray depth for CLEVR)")
    p.add_argument("--dataset", default="clevr-infinite")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--record", default=None, metavar="NPZ",
                   help="dump per-stage goldens to this .npz and exit")
    p.add_argument("--compare", default=None, metavar="NPZ",
                   help="diff against recorded goldens; exit 1 if out of tolerance")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device of the port's stages (the oracle runs on the CPU)")
    args = p.parse_args(argv)

    from sgam_neurips22_tpu_torch.core.device import resolve_device

    device = resolve_device(args.device)  # f32 parity mode: TF32 off
    cfg = model_config(args.config)
    model = load_model(args.ckpt, cfg, device)
    print(f"loaded {args.ckpt}")

    if args.compare:
        want = dict(np.load(args.compare))
        x = want["input"]
    else:
        x = load_test_input(args, cfg)

    got = compute_stages(model, x, args.dataset)

    if args.record:
        np.savez_compressed(args.record, **got)
        print(f"recorded {len(got)} stages -> {args.record}")
        return 0, {"recorded": sorted(got)}

    if not args.compare:
        want = torch_oracle_stages(args.ckpt, cfg, x)
    rows = compare_stages(got, want)

    failed = False
    for stage, diff, tol, ok in rows:
        mark = "ok " if ok else "FAIL"
        kind = "mismatch frac" if stage == "indices" else "max|diff|"
        print(f"  {mark} {stage:12s} {kind} {diff:.3e}  (tol {tol:.0e})")
        failed |= not ok
    ties = index_report(got, want, model.codebook, with_z2=not args.compare)
    if ties is not None and ties[0]:
        n = int(np.asarray(got["indices"]).size)
        print(f"  indices: {ties[0]} of {n} rows differ; "
              f"{'each one is' if ties[1] else 'not every one is'} an f32 near-tie (information only)")
    report = {"rows": rows, "index_rows_differ": None if ties is None else ties[0],
              "index_near_ties": None if ties is None else ties[1],
              "magnitude": {stage: float(np.abs(np.asarray(want[stage], np.float64)).max())
                            for stage, *_ in rows}}
    if failed:
        return 1, report
    print("all stages within tolerance")
    return 0, report


def main(argv=None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    sys.exit(main())
