"""The unroll's plain reference, step by step from the program's own frames.

The program's batched unroll is autoregressive: each step conditions on
frames it made itself. The reference follows it: for step t it takes the
sources (and, under map re-query, a map fused from the seeds and the
program's frames of steps 0..t-1, re-integrated here) from the program's
output buffers and builds the step's conditioning in float32 with TF32
off, which the caller encodes, quantises and decodes. The plan (the
zig-zag visit order, each step's sources and transforms) is worked out
here again, as the port's `InfiniteSceneGeneration.build_plan` does at
commit e4e59b7.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import tsdf
from portbench.reference.codec import get_codec
from portbench.reference.conditioning import get_x
from portbench.reference.ordering import ORDERS
from portbench.reference.selection import select_sources
from portbench.reference.trajectory import default_intrinsics, prepare_grid
from portbench.reference.warp import inverse_warp_multi_src


def plan(cfg: dict, traffic: dict):
    """(grid, order, steps): per step (target index, source indices padded
    to num_src, mask, R_rels, t_rels, target->source transforms, target
    world->camera), from the seed at grid (0, 0)."""
    res = tuple(cfg["image_resolution"])
    grid = prepare_grid(cfg["dataset"], tuple(traffic["grid"]), 2.0, default_intrinsics(cfg["dataset"], res))
    order = ORDERS[traffic["order"]](grid.rows, grid.cols)
    n = cfg["num_src"]
    grid.visited[:] = False
    grid.visited[grid.index(0, 0)] = True
    steps = []
    for curr in range(1, len(order)):
        tgt = order[curr]
        idxs = [grid.index(*c) for c in select_sources(grid, order, curr, tgt, n, cfg["dataset"])]
        mask = np.zeros(n, np.float32)
        mask[: len(idxs)] = 1.0
        pad = idxs + [idxs[0] if idxs else 0] * (n - len(idxs))
        t_tgt = grid.w2c(grid.index(*tgt))
        rel = [t_tgt @ np.linalg.inv(grid.w2c(i)) for i in pad]
        steps.append((grid.index(*tgt), np.asarray(pad), mask, np.stack([r[:3, :3] for r in rel]).astype(np.float32),
                      np.stack([r[:3, 3] for r in rel]).astype(np.float32),
                      np.stack([np.linalg.inv(r) for r in rel]).astype(np.float32), t_tgt.astype(np.float32)))
        grid.visited[grid.index(*tgt)] = True
    return grid, order, steps


def map_config(cfg: dict, grid):
    """The map's TSDFConfig, sized to the trajectory as the program sizes it."""
    res = tuple(cfg["image_resolution"])
    tsdf.validate_ray_budget(res, 1)
    return tsdf.auto_config(np.stack([grid.c2w(i) for i in range(grid.size)]), grid.K, res,
                            get_codec(cfg["dataset"]).depth_range, voxel_size=cfg["voxel_size"],
                            sdf_trunc=cfg["sdf_trunc"], pool_capacity=cfg.get("pool_capacity"), verbose=False)


@torch.no_grad()
def follow(cfg: dict, traffic: dict, rgb: torch.Tensor, depth: torch.Tensor, on_step) -> None:
    """Every step of the program's request whose outputs are rgb [S, G, H,
    W, 3] and depth [S, G, H, W]: on_step(t, target index, the step's
    conditioning from the program's frames)."""
    dev = rgb.device
    s, g, h, w = depth.shape
    codec = get_codec(cfg["dataset"])
    grid, _, steps = plan(cfg, traffic)
    ks = torch.as_tensor(np.tile(grid.K.astype(np.float32), (cfg["num_src"], 1, 1)), device=dev)
    volume = None
    if traffic["conditioning"] == "map":
        tcfg = map_config(cfg, grid)
        volume = tsdf.create_volume(tcfg, n_scenes=s, device=dev)
        seed = grid.index(0, 0)
        tsdf.integrate(volume, tcfg, depth[:, seed], None, ks[0], torch.as_tensor(grid.w2c(seed).astype(np.float32),
                                                                                   device=dev))
        lo, hi = codec.depth_range
        near, far = max(lo * 0.5, 1e-3), hi * 1.5
    for t, (tgt, src, mask, r_rels, t_rels, t2s, w2c) in enumerate(steps):
        src = torch.as_tensor(src, device=dev)
        n = src.shape[0]
        base = {"dst_img": torch.zeros((s, h, w, 3), device=dev),
                "dst_depth": torch.full((s, h, w), codec.depth_range[0], device=dev)}
        w2c = torch.as_tensor(w2c, device=dev)
        if volume is None:
            batch = dict(base, src_imgs=rgb[:, src], src_depths=depth[:, src], Ks=ks[None].expand(s, n, 3, 3),
                         R_rels=torch.as_tensor(r_rels, device=dev)[None].expand(s, n, 3, 3),
                         t_rels=torch.as_tensor(t_rels, device=dev)[None].expand(s, n, 3),
                         src_masks=torch.as_tensor(mask, device=dev)[None].expand(s, n))
            cond = get_x(batch, cfg["dataset"], depth_range=None, collision=traffic["collision"],
                         splat_stride=traffic["splat_stride"])
        else:
            tgt_depth = tsdf.render_depth(volume, tcfg, ks[0], w2c[None].expand(s, 4, 4), (h, w), near, far)
            tgt_depth = tgt_depth.reshape(s, h, w)
            warped = inverse_warp_multi_src(rgb[:, src], depth[:, src], tgt_depth, ks[None].expand(s, n, 3, 3),
                                            ks[0][None].expand(s, 3, 3),
                                            torch.as_tensor(t2s, device=dev)[None].expand(s, n, 4, 4))
            cond = get_x(dict(base, warped_tgt_features=warped, warped_tgt_depth=tgt_depth), cfg["dataset"])
        on_step(t, tgt, cond)
        if volume is not None:  # the program's frame joins the map, as the program fuses it
            tsdf.integrate(volume, tcfg, depth[:, tgt], (rgb[:, tgt] + 1.0) / 2.0, ks[0], w2c)
