"""AOT export of the conditional-generation inference step (`torch.export`) —
the port's counterpart of `tools/export_aot.py`, with its flags:

    python -m sgam_neurips22_tpu_torch.export_aot --out flagship_step.pt2 \\
        [--dataset clevr-infinite] [--ckpt trained_models/clevr-infinite/last.ckpt] \\
        [--topk 1] [--compute_dtype float32] [--platforms cuda [cpu]]

It serialises the per-frame inference function that
`serving.build_inference_step` builds (warp-conditioned encode -> nearest
codeword or top-k draw -> decode -> metric depth), with the model's weights,
to one `torch.export` archive. A serving process loads and calls it
without the model-building code (`models/`, `pipeline/`, `serving`,
`training/` are not imported) and without retracing. The hand kernels are
the custom ops `torch.ops.sgam.*` (`ops/library.py`) and stay single nodes
of the exported graph: the loaded program launches the z-buffer and
codeword kernels on the card as the eager step does.

Load side (any process with torch and this package):

    from sgam_neurips22_tpu_torch.export_aot import INPUTS, load_step
    step = load_step("flagship_step.pt2")  # or load_step(path, state_dict=other_weights)
    rgb, depth = step(*(batch[name] for name in INPUTS))  # at topk > 1: step(*..., gumbel)

The inputs are the example batch's eight tensors in the order of
`INPUTS`, at the shapes of the example batch (shapes are static, as in
JAX's export), and at topk > 1 the Gumbel noise [P, 1, topk] last, drawn by
the caller (`models.vqgan.quantize.gumbel_noise`): a torch.Generator cannot
travel in an artifact, as JAX's artifact takes its rng key instead. The
weights travel in the artifact (the flagship's 72.1 M parameters, about 288
MB in f32); `load_step(path, state_dict)` swaps in others by name.

Platforms: `--platforms cuda cpu` (JAX's `--platforms tpu cpu`) makes one
artifact for both. The step is traced on the first platform; the artifact
stores its weights and constants on the CPU and records its platforms, and
`load_step(path, device=...)` moves the program to a listed device
(`torch.export.passes.move_to_device_pass`: weights, constants and every
device the graph names). The hand kernels' custom ops have a CUDA and a CPU
implementation, so the program launches the kernels on the card and runs
their plain versions on the CPU. A device the artifact was not exported for
is refused, as JAX's `Exported` refuses a platform it was not lowered for;
a step traced on the CPU may still take another route on the card than one
traced there, so export for the card on the card.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import zipfile

import torch
from torch.export.passes import move_to_device_pass

PLATFORMS = ("cuda", "cpu")
PLATFORMS_FILE = "sgam_platforms.json"  # the artifact's record of its platforms (an extra file of the archive)
INPUTS = ("dst_img", "dst_depth", "src_imgs", "src_depths", "Ks", "R_rels", "t_rels", "src_masks")


class InferenceStep(torch.nn.Module):
    """`build_inference_step`'s step as a module over the batch's tensors
    in the order of INPUTS (and the Gumbel noise at topk > 1); the model is
    its submodule `model`, so its weights are the program's."""

    def __init__(self, step, model: torch.nn.Module):
        super().__init__()
        self.step = step
        self.model = model

    def forward(self, dst_img, dst_depth, src_imgs, src_depths, Ks, R_rels, t_rels, src_masks, gumbel=None):
        batch = dict(zip(INPUTS, (dst_img, dst_depth, src_imgs, src_depths, Ks, R_rels, t_rels, src_masks)))
        return self.step(self.model, batch, None, gumbel)


def gumbel_shape(model_cfg, topk: int, image_size: int) -> tuple:
    """The Gumbel noise input [P, 1, topk] of a step at `image_size`: P
    latent positions of the batch-1 step, the image downsampled by 2 at
    each level of the encoder but the last."""
    side = image_size // 2 ** (len(model_cfg.ddconfig.ch_mult) - 1)
    return (side * side, 1, topk)


def export_step(model_cfg, out_path: str, device: str | torch.device = "cuda", topk: int = 1,
                model: torch.nn.Module | None = None, platforms=None) -> torch.export.ExportedProgram:
    """Export the inference step of `model_cfg` at the example batch's
    shapes (256^2 for the flagship: 4x the model's resolution, as JAX's
    export) to `out_path`, with the step's seeded weights or `model`'s (a
    VQModel of `model_cfg`); returns the ExportedProgram, on the device it
    was traced on, `device`. `platforms` (default: `device`'s type alone)
    are the devices the artifact may load on, each of PLATFORMS, the first
    `device`'s. At topk > 1 the program takes the Gumbel noise as a last
    input."""
    from sgam_neurips22_tpu_torch.models.vqgan.quantize import gumbel_noise
    from sgam_neurips22_tpu_torch.serving import build_inference_step

    platforms = list(platforms or [torch.device(device).type])
    if platforms[0] != torch.device(device).type or any(p not in PLATFORMS for p in platforms) \
            or len(set(platforms)) < len(platforms):
        raise ValueError(f"platforms {platforms}: each of {PLATFORMS} once, the first {device!r}'s")
    image_size = model_cfg.ddconfig.resolution * 4
    fn, (own, batch, generator) = build_inference_step(model_cfg, topk=topk, image_size=image_size, device=device)
    dev = batch["dst_img"].device
    # the step without fn's inference mode: tensors made under it must not
    # become the program's constants
    module = InferenceStep(fn.__wrapped__, own if model is None else model.to(dev).eval())
    args = tuple(batch[name] for name in INPUTS)
    if topk > 1:
        args += (gumbel_noise(gumbel_shape(model_cfg, topk, image_size), generator, dev),)
    with torch.no_grad():
        exported = torch.export.export(module, args)
    stored = exported
    if dev.type != "cpu":  # stored on the CPU, so that any listed platform can read it
        stored = move_to_device_pass(copy.deepcopy(exported), "cpu")
    torch.export.save(stored, out_path, extra_files={PLATFORMS_FILE: json.dumps(platforms)})
    print(f"wrote {out_path}: {os.path.getsize(out_path) / 1e6:.1f} MB, traced on {dev}, platforms={platforms}, "
          f"inputs={len(args)}")
    return exported


def artifact_platforms(path: str) -> list | None:
    """The platforms an artifact of `export_step` records, read from its
    archive without loading the program; None for an artifact without a
    record (written before there was one)."""
    with zipfile.ZipFile(path) as archive:
        names = [n for n in archive.namelist() if n.endswith(f"/extra/{PLATFORMS_FILE}")]
        return json.loads(archive.read(names[0])) if names else None


def load_step(path: str, state_dict: dict | None = None, device: str | torch.device | None = None) -> torch.nn.Module:
    """The exported step at `path` as a callable module on `device` (the
    first of its platforms by default): step(*inputs) -> (rgb, depth).
    A device whose type the artifact was not exported for raises, naming
    its platforms. `state_dict`, a VQModel state_dict (tensors or arrays, as
    `core.state_dict.from_jax_params` gives), replaces the program's
    weights by name, strictly (every weight, and nothing else). The
    process's matmul precision mode (`float32` unless set) is applied, as
    every entry point of the port does. Imports the op registrations and
    nothing of the model."""
    from sgam_neurips22_tpu_torch.core.device import resolve_device
    from sgam_neurips22_tpu_torch.ops import library  # noqa: F401  (torch.ops.sgam before the load)

    platforms, exported = artifact_platforms(path), None
    if platforms is None:  # an artifact without a record: the device its weights were saved on
        exported = torch.export.load(path)
        platforms = sorted({t.device.type for t in exported.state_dict.values()})
    want = torch.device(device if device is not None else platforms[0])
    if want.type not in platforms:
        raise ValueError(f"{path} was exported for platforms {platforms}, not {want.type!r}; export it again with "
                         f"--platforms {' '.join(platforms + [want.type])}")
    dev = resolve_device(want)
    if exported is None:
        exported = torch.export.load(path)
    if any(t.device != dev for t in exported.state_dict.values()):
        exported = move_to_device_pass(exported, str(dev))
    step = exported.module().requires_grad_(False)  # inference: no autograd graph
    if state_dict is not None:
        step.load_state_dict({f"model.{name}": torch.as_tensor(t) for name, t in state_dict.items()}, strict=True)
    return step


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="flagship_step.pt2")
    p.add_argument("--dataset", default="clevr-infinite", choices=["clevr-infinite", "google_earth"])
    p.add_argument("--ckpt", default=None,
                   help="checkpoint whose weights the artifact carries (serving.load_inference_params: a "
                        "reference .ckpt, a JAX .pkl or a port run); seeded random weights without it")
    p.add_argument("--topk", type=int, default=1)
    p.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--platforms", nargs="+", choices=PLATFORMS, default=None,
                   help="devices the artifact loads on (default cuda); the step is traced on the first, e.g. "
                        "--platforms cuda cpu for a dual artifact")
    p.add_argument("--device", choices=PLATFORMS, default=None, help="the same as --platforms DEVICE")
    args = p.parse_args(argv)
    if args.platforms and args.device:
        p.error("give --platforms or --device, not both")
    platforms = args.platforms or [args.device or "cuda"]

    from sgam_neurips22_tpu_torch.serving import flagship_config

    cfg = flagship_config(args.dataset, compute_dtype=args.compute_dtype)
    model = None
    if args.ckpt:
        from sgam_neurips22_tpu_torch.core.state_dict import load_into, random_state_dict
        from sgam_neurips22_tpu_torch.models.vqgan.model import VQModel
        from sgam_neurips22_tpu_torch.serving import load_inference_params

        model = VQModel(cfg)
        load_into(model, random_state_dict(model, 0))
        load_inference_params(args.ckpt, model)
    export_step(cfg, args.out, device=platforms[0], topk=args.topk, model=model, platforms=platforms)


if __name__ == "__main__":
    main()
