"""Scene generation from the command line: unroll a scene from its seed
template and write the frames and point clouds in the reference's layout
(the port of the repository's `generate.py`, with the same flags).

Usage:
  python -m sgam_neurips22_tpu_torch.generate --dataset clevr-infinite \
      --ckpt trained_models/clevr-infinite/last.ckpt \
      --template_dir templates/clevr-infinite [--use_rgbd_integration] [--device cpu]

Differences from `generate.py`: `--device` picks the card (`cuda`, the
default) or the CPU; there is no `--matmul_precision`, because the port
keeps TF32 off (`core.device.resolve_device`). `--config` takes the model
configuration from a trained-model YAML (a run's config.yaml), and
`--ckpt` may be a port run directory. Without `--ckpt` the model takes
seeded random weights (`core.state_dict.random_state_dict`, seed 0).
"""
from __future__ import annotations

import argparse
import glob
import os
from dataclasses import replace

from sgam_neurips22_tpu_torch.core.config import load_yaml
from sgam_neurips22_tpu_torch.core.state_dict import load_into, random_state_dict
from sgam_neurips22_tpu_torch.models.vqgan.model import VQModel, VQModelConfig
from sgam_neurips22_tpu_torch.pipeline.scene_generation import InfiniteSceneGeneration, SceneGenConfig
from sgam_neurips22_tpu_torch.pipeline.templates import load_seed_frames
from sgam_neurips22_tpu_torch.serving import flagship_config, load_inference_params


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", default="clevr-infinite", choices=["clevr-infinite", "google_earth"])
    p.add_argument("--ckpt", default=None,
                   help="reference torch .ckpt (or a bare state_dict), or a port training run directory")
    p.add_argument("--config", default=None, help="trained-model YAML (the model configuration)")
    p.add_argument("--template_dir", default=None)
    p.add_argument("--output_dir", default=None)
    p.add_argument("--use_rgbd_integration", action="store_true")
    p.add_argument("--topk", type=int, default=1)
    p.add_argument("--topk_position0_compat", action="store_true",
                   help="reproduce the reference's topk>1 position-0 sampling bug")
    p.add_argument("--seed_index", type=int, default=0)
    p.add_argument("--batch_seeds", action="store_true",
                   help="unroll every seed template at once (splat conditioning only); outputs land in "
                        "<output_dir>_seed<k>")
    p.add_argument("--rows", type=int, default=None)
    p.add_argument("--cols", type=int, default=None)
    p.add_argument("--resolution", type=int, default=256, help="square frame resolution (reference: 256)")
    p.add_argument("--num_src", type=int, default=None)
    p.add_argument("--trajectory", default="grid", choices=["grid", "spiral", "cylinder", "trajectory"])
    p.add_argument("--pose_file", default=None)
    p.add_argument("--splat_stride", type=int, default=1, help="splat every s-th source pixel (1 = reference)")
    p.add_argument("--tsdf_integrate_stride", type=int, default=1, help="map re-query: fuse every s-th ray")
    p.add_argument("--tsdf_render_chunk", type=int, default=0,
                   help="map re-query: the pool splat's sub-chunk (0 = the library default)")
    p.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"],
                   help="the model's activation dtype")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> None:
    opt = parse_args(argv)
    if opt.batch_seeds and opt.use_rgbd_integration:
        raise SystemExit("--batch_seeds currently supports splat conditioning")
    if opt.config:
        yaml_cfg = load_yaml(opt.config)
        mp = yaml_cfg.model.params
        model_cfg = VQModelConfig.from_config(mp, mp.get("data_config") or yaml_cfg.get("data", {}).get("params", {}))
        if opt.compute_dtype != "float32":
            model_cfg = replace(model_cfg, ddconfig=replace(model_cfg.ddconfig, compute_dtype=opt.compute_dtype))
    else:
        model_cfg = flagship_config(opt.dataset, opt.compute_dtype)
    model = VQModel(model_cfg)
    load_into(model, random_state_dict(model, 0))
    if opt.ckpt and os.path.exists(opt.ckpt):
        load_inference_params(opt.ckpt, model)
        print(f"loaded weights from {opt.ckpt}")
    else:
        print("WARNING: running with randomly initialized weights")
    # defaults per reference (inference_pipeline.py:43,48)
    rows = opt.rows or (20 if opt.dataset == "clevr-infinite" else 100)
    cols = opt.cols or (20 if opt.dataset == "clevr-infinite" else 1)
    resolution = (opt.resolution, opt.resolution)
    cfg = SceneGenConfig(
        dataset=opt.dataset, output_dim=(rows, cols), num_src=opt.num_src, topk=opt.topk,
        topk_position0_compat=opt.topk_position0_compat, use_rgbd_integration=opt.use_rgbd_integration,
        trajectory_shape=opt.trajectory, pose_file=opt.pose_file, image_resolution=resolution,
        splat_stride=opt.splat_stride, tsdf_integrate_stride=opt.tsdf_integrate_stride,
        tsdf_render_chunk=opt.tsdf_render_chunk or None,
    )
    template_dir = opt.template_dir or os.path.join("templates", opt.dataset)
    if opt.batch_seeds:
        n_seeds = len(glob.glob(os.path.join(template_dir, "seed*"))) or 1
        seeds_batch = [load_seed_frames(template_dir, opt.dataset, k, resolution) for k in range(n_seeds)]
        out = opt.output_dir or f"grid_res/{opt.dataset}"
        gen = InfiniteSceneGeneration(model, cfg, seeds_batch[0], device=opt.device)
        rgbs, depths = gen.scene_expansion_batched(seeds_batch)
        gen.grid.visited[:] = True
        for k in range(n_seeds):
            gen.rgb_buf, gen.depth_buf = rgbs[k], depths[k]
            gen.export_frames(f"{out}_seed{k}")
            gen.export_point_clouds(f"{out}_seed{k}")
        print(f"Successfully unrolled {n_seeds} seeds; results at {out}_seed*")
        return
    seeds = load_seed_frames(template_dir, opt.dataset, opt.seed_index, resolution)
    out = opt.output_dir or f"grid_res/{opt.dataset}_seed{opt.seed_index}"
    gen = InfiniteSceneGeneration(model, cfg, seeds, device=opt.device, output_dir=out)
    gen.scene_expansion(progress=True, fused=False)
    print(f"Successfully unrolled; results saved at {out}")


if __name__ == "__main__":
    main()
