"""Infinite scene generation — port of
`sgam_neurips22_tpu/pipeline/scene_generation.py`: splat conditioning and
map re-query (`use_rgbd_integration`), for one scene (`scene_expansion`)
and for S scenes at once (`scene_expansion_batched`), over the grid,
spiral, cylinder or pose-file trajectory, with the reference's exports.

The plan (per-step target, sources, relative transforms) is built on the
host from the pose table and uploaded once; the unroll is one loop over it
in which every frame stays on the device: source gather -> conditioning
-> encode -> nearest codeword (or a top-k draw) -> decode -> depth decode
-> write into the [G, H, W, 3] RGB and [G, H, W] depth buffers, updated in
place. The splat conditioning splats the sources; map re-query renders the
target depth from the TSDF map (`mapping.tsdf`), warps the sources into
the target view through it (`geometry.warp.inverse_warp_multi_src`), and
fuses each new frame into the map. The batched unroll keeps S scenes'
buffers flat, [S*G, ...] (and S maps in one batched volume), shares the
plan across scenes and runs the model at batch S with flash attention.
`scene_expansion(fused=False)` steps frame by frame instead, planning each
step when it comes and writing each frame out as it is made; `output_dir`
then receives the reference's file layout (`export_frames`,
`export_point_clouds`). `scene_expansion_batched(..., mesh=)` shards the
scenes over data-parallel ranks (`parallel.mesh`): each rank unrolls its
block of scenes with its replica of the model and no collective, and the
buffers are gathered at the end.
"""
from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from sgam_neurips22_tpu_torch.core.device import resolve_device
from sgam_neurips22_tpu_torch.geometry.camera import plane_z_depth
from sgam_neurips22_tpu_torch.geometry.codec import get_codec
from sgam_neurips22_tpu_torch.geometry.splat import COLLISIONS
from sgam_neurips22_tpu_torch.geometry.warp import inverse_warp_multi_src
from sgam_neurips22_tpu_torch.mapping.pointcloud import merge_point_clouds, unproject_to_color_point_cloud, write_ply
from sgam_neurips22_tpu_torch.mapping.tsdf import (
    CLAIM_MAX_FRAMES,
    TSDFConfig,
    TSDFVolume,
    auto_config,
    colorize_points,
    create_volume,
    extract_points,
    fusion_fraction,
    integrate,
    render_depth,
    validate_ray_budget,
)
from sgam_neurips22_tpu_torch.models.conditioning import get_x
from sgam_neurips22_tpu_torch.models.vqgan.model import VQModel
from sgam_neurips22_tpu_torch.models.vqgan.quantize import RowShard
from sgam_neurips22_tpu_torch.parallel import distributed
from sgam_neurips22_tpu_torch.pipeline.ordering import ORDERS
from sgam_neurips22_tpu_torch.pipeline.selection import select_sources
from sgam_neurips22_tpu_torch.pipeline.png import write_png
from sgam_neurips22_tpu_torch.pipeline.trajectory import (
    PoseGrid,
    default_intrinsics,
    prepare_grid,
    prepare_ring,
    prepare_spiral,
    prepare_trajectory,
)

# reference num_src defaults (inference_pipeline.py:68,90)
DEFAULT_NUM_SRC = {"clevr-infinite": 5, "google_earth": 3}
# reference TSDF parameters (inference_pipeline.py:120-131); google_earth
# also caps its surface pool at 2^20 slots
DEFAULT_TSDF = {
    "clevr-infinite": dict(voxel_size=0.05, sdf_trunc=0.5),
    "google_earth": dict(voxel_size=0.01, sdf_trunc=0.03, pool_capacity=1 << 20),
}


@dataclass(frozen=True)
class SceneGenConfig:
    dataset: str = "clevr-infinite"
    output_dim: Tuple[int, int] = (20, 20)
    num_src: Optional[int] = None
    topk: int = 1
    # the reference's topk>1 position-0 sampling bug, opt-in
    # (models.vqgan.quantize.quantize_topk, position0_bug)
    topk_position0_compat: bool = False
    step_size_denom: float = 2.0
    order: str = "zigzag"
    image_resolution: Tuple[int, int] = (256, 256)
    # the camera path (_build_grid): "grid" (output_dim rows x cols), or
    # output_dim[0] frames of "spiral", "cylinder" or "trajectory" (the
    # poses of pose_file, a KITTI-360-style cam0_to_world.txt)
    trajectory_shape: str = "grid"
    pose_file: Optional[str] = None
    collision: str = "nearest"  # geometry.splat.COLLISIONS
    # splat every s-th source pixel with per-source phase offsets
    # (geometry.splat.render_projection_from_srcs); 1 = every pixel, as the
    # reference
    splat_stride: int = 1
    # map re-query conditioning instead of the splat (one scene at a time),
    # and its TSDF map (mapping.tsdf; the JAX package's SceneGenConfig
    # documents each knob's measurements):
    use_rgbd_integration: bool = False
    tsdf_voxel_size: Optional[float] = None  # None = the dataset's (DEFAULT_TSDF)
    tsdf_dims: Optional[Tuple[int, int, int]] = None  # None = auto-sized from the trajectory
    tsdf_origin: Optional[Tuple[float, float, float]] = None  # None = centred on the trajectory
    tsdf_mem_cap_gb: float = 6.0  # the auto-sized volume's memory cap
    tsdf_pool_capacity: Optional[int] = None  # None = auto from the volume
    tsdf_pool_recycle: bool = True  # a full pool cell recycles its oldest slots
    tsdf_integrate_stride: int = 1  # fuse every s-th ray
    tsdf_band_voxels: Optional[int] = None  # fused band half-width (None = auto, <= 8)
    tsdf_render_chunk: Optional[int] = None  # the pool splat's sub-chunk (None = TSDFConfig's)
    tsdf_pool_cells: Optional[int] = None  # spatial pool cells (None = auto)
    # replace the generated depth by the analytic depth of one world plane,
    # so that every frame agrees with every other and the map converges as
    # with trained weights (the bench's --coherent); the model still runs
    coherent_plane_depth: bool = False
    raycast_samples: int = 192
    requery_method: str = "splat"  # "splat" (the surface pool) or "raycast"
    raycast_interp: str = "nearest"  # the raycast's grid sampling: "nearest" or "trilinear"

    def __post_init__(self):
        if self.collision not in COLLISIONS:
            raise ValueError(f"unknown collision mode {self.collision!r}")
        s = int(self.splat_stride)
        h, w = self.image_resolution
        # map re-query never splats, so the packed key's point budget does not apply
        if self.collision == "nearest" and not self.use_rgbd_integration:
            # the packed z-buffer key holds 19 bits of point index
            pts = self.effective_num_src * (h // s) * (w // s)
            if pts >= (1 << 19):
                raise ValueError(
                    f"splat conditioning at {h}x{w} with {self.effective_num_src} "
                    f"sources and splat_stride={s} produces {pts} points/frame, over "
                    "the packed z-buffer's 2^19 point capacity; raise splat_stride or "
                    "set collision='nearest_exact' (unpacked)"
                )
        if s > 1:
            if s >= min(h, w):
                raise ValueError(f"splat_stride {s} >= image size {min(h, w)}")
            if self.collision == "last":
                raise ValueError("splat_stride > 1 requires collision='nearest' or 'nearest_exact'")
            n = self.effective_num_src
            if n < s * s:
                # full phase coverage needs >= s^2 sources; fewer is allowed
                # (google_earth runs 3 at stride 2), and the fills close the rest
                warnings.warn(
                    f"splat_stride={s} with {n} sources covers only {n}/{s * s} phase "
                    "cells; raw splat coverage will rely on hole filling"
                )

    @property
    def effective_num_src(self) -> int:
        return self.num_src or DEFAULT_NUM_SRC[self.dataset]


def _build_grid(cfg: SceneGenConfig, intrinsics: Optional[np.ndarray] = None) -> PoseGrid:
    """The configured trajectory's pose table; intrinsics None = the
    dataset's, scaled to the frames."""
    if intrinsics is None:
        intrinsics = default_intrinsics(cfg.dataset, cfg.image_resolution)
    if cfg.trajectory_shape == "grid":
        return prepare_grid(cfg.dataset, cfg.output_dim, cfg.step_size_denom, intrinsics)
    if cfg.trajectory_shape == "spiral":
        return prepare_spiral(cfg.dataset, cfg.output_dim[0], cfg.step_size_denom, intrinsics)
    if cfg.trajectory_shape == "cylinder":
        return prepare_ring(cfg.dataset, cfg.output_dim[0], cfg.step_size_denom, intrinsics=intrinsics)
    if cfg.trajectory_shape == "trajectory":
        return prepare_trajectory(cfg.dataset, cfg.pose_file, cfg.output_dim[0], intrinsics=intrinsics)
    raise NotImplementedError(cfg.trajectory_shape)


def _tsdf_config(cfg: SceneGenConfig, grid, depth_range: Tuple[float, float]) -> TSDFConfig:
    """The map's TSDFConfig: the dataset's voxel and truncation (a given
    voxel keeps the dataset's truncation ratio), placed by tsdf_dims and
    tsdf_origin, or sized to hold the trajectory's frusta (auto_config)."""
    base = dict(DEFAULT_TSDF[cfg.dataset])
    if cfg.tsdf_voxel_size is not None:
        ref = DEFAULT_TSDF[cfg.dataset]
        base["voxel_size"] = cfg.tsdf_voxel_size
        base["sdf_trunc"] = cfg.tsdf_voxel_size * ref["sdf_trunc"] / ref["voxel_size"]
    validate_ray_budget(cfg.image_resolution, cfg.tsdf_integrate_stride)
    chunk = {} if cfg.tsdf_render_chunk is None else {"render_chunk": cfg.tsdf_render_chunk}
    if cfg.tsdf_dims is not None:
        origin = cfg.tsdf_origin
        if origin is None:  # centre the volume on the trajectory's cameras
            extent = np.asarray(cfg.tsdf_dims) * base["voxel_size"]
            origin = tuple(grid.position.mean(axis=0) - extent / 2)
        return TSDFConfig(
            dims=cfg.tsdf_dims, voxel_size=base["voxel_size"], sdf_trunc=base["sdf_trunc"], origin=origin,
            pool_capacity=cfg.tsdf_pool_capacity or base.get("pool_capacity", 1 << 19),
            pool_recycle=cfg.tsdf_pool_recycle, integrate_stride=cfg.tsdf_integrate_stride,
            band_voxels=cfg.tsdf_band_voxels, pool_cells=cfg.tsdf_pool_cells, **chunk,
        )
    return auto_config(
        np.stack([grid.c2w(i) for i in range(grid.size)]), grid.K, cfg.image_resolution, depth_range,
        voxel_size=base["voxel_size"], sdf_trunc=base["sdf_trunc"], mem_cap_bytes=cfg.tsdf_mem_cap_gb * 1e9,
        pool_capacity=cfg.tsdf_pool_capacity or base.get("pool_capacity"),
        integrate_stride=cfg.tsdf_integrate_stride, band_voxels=cfg.tsdf_band_voxels,
        render_chunk=cfg.tsdf_render_chunk, pool_recycle=cfg.tsdf_pool_recycle, pool_cells=cfg.tsdf_pool_cells,
    )


class InfiniteSceneGeneration:
    """Drives the autoregressive unroll. The host keeps the planning data
    (pose table, visit order); frames live on `device`.

    Args:
      model: a VQModel; it is moved to `device` (in place, as
        nn.Module.to does) and put in eval mode.
      seeds: [(coord (i, j), rgb [H, W, 3] in [-1, 1], z-depth [H, W])],
        numpy or tensors.
      intrinsics: [3, 3] K; None = the dataset's, scaled to the frames.
      device: "cuda" (default) or "cpu"; see core.device.resolve_device.
      output_dir: where `scene_expansion` writes the reference's files:
        each frame as it is made (fused=False), then every frame and the
        point clouds; None writes nothing.
    """

    def __init__(
        self,
        model: VQModel,
        cfg: SceneGenConfig,
        seeds: list,
        intrinsics: Optional[np.ndarray] = None,
        device: str | torch.device = "cuda",
        output_dir: Optional[str] = None,
    ):
        self.device = resolve_device(device)
        self.output_dir = output_dir
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.codec = get_codec(cfg.dataset)
        self.grid = _build_grid(cfg, intrinsics)
        self.order = ORDERS[cfg.order](self.grid.rows, self.grid.cols)
        self.ks = torch.as_tensor(
            np.tile(self.grid.K.astype(np.float32), (cfg.effective_num_src, 1, 1)),
            device=self.device,
        )
        self.tsdf_cfg: Optional[TSDFConfig] = None
        self.volume: Optional[TSDFVolume] = None
        self.batched_volume: Optional[TSDFVolume] = None  # the last batched map unroll's, for telemetry
        if cfg.use_rgbd_integration:
            self.tsdf_cfg = _tsdf_config(cfg, self.grid, self.codec.depth_range)
        if cfg.coherent_plane_depth:
            # the world plane along the first camera's axis at mid depth range
            c2w0 = self.grid.c2w(0)
            n_w = c2w0[:3, 2] / np.linalg.norm(c2w0[:3, 2])
            d_mid = float(np.mean(self.codec.depth_range))
            self._plane_n = torch.as_tensor(n_w, dtype=torch.float32, device=self.device)
            self._plane_d = torch.tensor(float(n_w @ (c2w0[:3, 3] + d_mid * n_w)), dtype=torch.float32,
                                         device=self.device)
        self._seeds = seeds
        self._plan_key = None
        self.reset()

    @property
    def near_far(self) -> Tuple[float, float]:
        """The map's render and plane-depth bounds: half the codec's near
        and 1.5 times its far."""
        lo, hi = self.codec.depth_range
        return max(lo * 0.5, 1e-3), hi * 1.5

    def plane_depth_at(self, idx: int) -> np.ndarray:
        """[H, W] analytic z-depth of the coherent plane at grid pose `idx`
        (coherent_plane_depth; for seed frames on the same plane)."""
        return self._plane_depth(self._w2c(idx)).cpu().numpy()

    def _plane_depth(self, w2c: torch.Tensor) -> torch.Tensor:
        return plane_z_depth(self.ks[0], w2c, self._plane_n, self._plane_d, self.cfg.image_resolution,
                             *self.near_far)

    def _w2c(self, idx: int) -> torch.Tensor:
        return torch.as_tensor(self.grid.w2c(idx).astype(np.float32), device=self.device)

    def reset(self, seeds: Optional[list] = None) -> None:
        """(Re)initialise the frame buffers and visited state from the seeds;
        under map re-query, a new map into which each seed frame is fused."""
        if seeds is not None:
            self._seeds = seeds
        self.rgb_buf, self.depth_buf = self.batched_buffers([self._seeds])
        self.grid.visited[:] = False
        if self.cfg.use_rgbd_integration:
            self.volume = None  # free the old map first
            self.volume = create_volume(self.tsdf_cfg, device=self.device)
        for coord, _, _ in self._seeds:
            idx = self.grid.index(*coord)
            self.grid.visited[idx] = True
            if self.volume is not None:
                integrate(self.volume, self.tsdf_cfg, self.depth_buf[idx], self.rgb_buf[idx], self.ks[0],
                          self._w2c(idx))
        self.curr = 1

    def _step_inputs_host(self, tgt_coord, curr):
        """Numpy inputs of the `curr`-th step: source indices padded to
        num_src (+ mask), source->target relative transforms, the
        target->source transforms and the target's world->camera pose."""
        n = self.cfg.effective_num_src
        src_coords = select_sources(self.grid, self.order, curr, tgt_coord, n, self.cfg.dataset)
        idxs = [self.grid.index(*c) for c in src_coords]
        mask = np.zeros(n, np.float32)
        mask[: len(idxs)] = 1.0
        pad = idxs + [idxs[0] if idxs else 0] * (n - len(idxs))
        t_tgt = self.grid.w2c(self.grid.index(*tgt_coord))
        r_rels = np.zeros((n, 3, 3), np.float32)
        t_rels = np.zeros((n, 3), np.float32)
        t_tgt2srcs = np.zeros((n, 4, 4), np.float32)
        for i, idx in enumerate(pad):
            t_rel = t_tgt @ np.linalg.inv(self.grid.w2c(idx))
            r_rels[i] = t_rel[:3, :3]
            t_rels[i] = t_rel[:3, 3]
            t_tgt2srcs[i] = np.linalg.inv(t_rel)
        return np.asarray(pad, np.int64), mask, r_rels, t_rels, t_tgt2srcs, t_tgt.astype(np.float32)

    def _plan_step(self, tgt_coord, curr: int) -> tuple:
        """The host inputs of the `curr`-th step, which targets tgt_coord:
        (target index, *_step_inputs_host)."""
        return (self.grid.index(*tgt_coord), *self._step_inputs_host(tgt_coord, curr))

    def _upload_plan(self, steps: list) -> dict:
        """A plan from steps of _plan_step: the target indices as host
        ints, every other input stacked on the device."""
        names = ("src_idx", "src_mask", "r_rels", "t_rels", "t_tgt2srcs", "tgt_w2c")
        cols = [list(x) for x in zip(*steps)] if steps else [[]] * (len(names) + 1)
        plan = {"tgt": cols[0]}
        for name, arrs in zip(names, cols[1:]):
            plan[name] = torch.as_tensor(np.stack(arrs), device=self.device) if arrs else None
        return plan

    def build_plan(self) -> dict:
        """The whole unroll's plan: per step the target index (host ints)
        and the sources, mask and transforms (stacked on the device).
        Memoised on (curr, visited), so repeated unrolls of one trajectory
        skip the host planning and the upload."""
        key = (self.curr, self.grid.visited.tobytes())
        if self._plan_key == key:
            return self._plan
        visited = self.grid.visited.copy()
        steps = []
        try:
            for curr in range(self.curr, len(self.order)):
                steps.append(self._plan_step(self.order[curr], curr))
                self.grid.visited[steps[-1][0]] = True
        finally:
            self.grid.visited = visited
        self._plan_key, self._plan = key, self._upload_plan(steps)
        return self._plan

    def step_batch(self, plan: dict, t: int, rgb_flat, depth_flat) -> dict:
        """The NHWC conditioning batch of step t for the S scenes whose
        frames sit flat in rgb_flat [S*G, H, W, 3] / depth_flat [S*G, H, W]
        (this generator's own buffers are the S = 1 case). Scene s reads its
        sources at s*G + src_idx: one leading-axis gather for the batch."""
        h, w = self.cfg.image_resolution
        s, flat_idx = self._sources(plan, t, rgb_flat)
        n = flat_idx.shape[1]
        return {
            "dst_img": torch.zeros((s, h, w, 3), device=self.device),
            "dst_depth": torch.full((s, h, w), self.codec.depth_range[0], device=self.device),
            "src_imgs": rgb_flat[flat_idx],
            "src_depths": depth_flat[flat_idx],
            "Ks": self.ks[None].expand(s, n, 3, 3),
            "R_rels": plan["r_rels"][t][None].expand(s, n, 3, 3),
            "t_rels": plan["t_rels"][t][None].expand(s, n, 3),
            "src_masks": plan["src_mask"][t][None].expand(s, n),
        }

    def _sources(self, plan: dict, t: int, rgb_flat) -> tuple:
        """(S, [S, N] flat indices s*G + src_idx of step t's sources)."""
        g = self.grid.size
        s = rgb_flat.shape[0] // g
        return s, (torch.arange(s, device=self.device) * g)[:, None] + plan["src_idx"][t][None]

    def condition(self, batch: dict):
        """The splat conditioning of a step batch: no depth range, as at
        inference in the reference, with the configured collision rule and
        splat stride."""
        return get_x(batch, self.cfg.dataset, depth_range=None, collision=self.cfg.collision,
                     splat_stride=self.cfg.splat_stride)

    def decode_batch(self, cond, generator: Optional[torch.Generator] = None):
        """(rgb [B, H, W, 3], metric depth [B, H, W]) from the conditioning,
        sample 0 of the configured top-k draw (`generator` draws it at
        topk > 1). The model's attention takes the flash path at batch >= 2
        and the plain one at batch 1, as the JAX pipeline selects its
        kernel."""
        res = self.model(cond.x, extrapolation_mask=cond.extrapolation_mask, topk=self.cfg.topk,
                         generator=generator, topk_position0_bug=self.cfg.topk_position0_compat)
        xrec = res.xrec[:, 0]  # sample 0
        return torch.clamp(xrec[..., :3], -1.0, 1.0), self.codec.decode(xrec[..., 3])

    def requery_batch(self, plan: dict, t: int, rgb_flat=None, depth_flat=None,
                      volume: Optional[TSDFVolume] = None) -> dict:
        """The NHWC conditioning batch of map-requery step t for the S
        scenes of the flat buffers and of `volume` (None: this generator's
        own buffers and map, S = 1): the target depth rendered from each
        scene's map at the shared target pose, and the scene's sources
        warped into the target view through it (every padded source, as
        the JAX pipeline: a repeated source changes no winner). One scene renders at the pose itself, so
        that the raycast serves it; S scenes take the pose S times, which
        only the splat renders."""
        if volume is None:
            rgb_flat, depth_flat, volume = self.rgb_buf, self.depth_buf, self.volume
        h, w = self.cfg.image_resolution
        s, flat_idx = self._sources(plan, t, rgb_flat)
        n = flat_idx.shape[1]
        tgt_w2c = plan["tgt_w2c"][t]
        tgt_depth = render_depth(
            volume, self.tsdf_cfg, self.ks[0], tgt_w2c if s == 1 else tgt_w2c[None].expand(s, 4, 4), (h, w),
            *self.near_far, n_samples=self.cfg.raycast_samples, method=self.cfg.requery_method,
            interp=self.cfg.raycast_interp,
        ).reshape(s, h, w)
        warped = inverse_warp_multi_src(rgb_flat[flat_idx], depth_flat[flat_idx], tgt_depth,
                                        self.ks[None].expand(s, n, 3, 3), self.ks[0][None].expand(s, 3, 3),
                                        plan["t_tgt2srcs"][t][None].expand(s, n, 4, 4))
        return {
            "dst_img": torch.zeros((s, h, w, 3), device=self.device),
            "dst_depth": torch.full((s, h, w), self.codec.depth_range[0], device=self.device),
            "warped_tgt_features": warped,
            "warped_tgt_depth": tgt_depth,
        }

    def _step(self, plan: dict, t: int, rgb_flat, depth_flat, volume: Optional[TSDFVolume], generator,
              coherent: bool = False) -> None:
        """Step t of the plan for the S scenes of the flat buffers: condition
        (the splat, or map re-query from `volume`), decode at batch S, write
        scene s's frame at s*G + tgt, and fuse the frames into `volume`.
        `coherent` writes the coherent plane's depth in place of the
        generated one (the single-scene unroll under coherent_plane_depth:
        JAX's batched core does not)."""
        if volume is None:
            cond = self.condition(self.step_batch(plan, t, rgb_flat, depth_flat))
        else:
            cond = get_x(self.requery_batch(plan, t, rgb_flat, depth_flat, volume), self.cfg.dataset)
        rgb, depth = self.decode_batch(cond, generator)
        if coherent:
            depth = self._plane_depth(plan["tgt_w2c"][t])[None]
        dst = torch.arange(rgb.shape[0], device=self.device) * self.grid.size + plan["tgt"][t]
        rgb_flat[dst] = rgb
        depth_flat[dst] = depth
        if volume is not None:
            integrate(volume, self.tsdf_cfg, depth, (rgb + 1.0) / 2.0, self.ks[0], plan["tgt_w2c"][t])

    def _unroll(self, plan: dict, rgb_flat, depth_flat, volume: Optional[TSDFVolume],
                generator: Optional[torch.Generator], coherent: bool = False) -> None:
        """Every step of the plan (_step) for all scenes of the flat
        buffers; no step reads a device value on the host. At topk > 1 the
        steps draw from `generator` in turn; None is a generator on the
        device seeded with 3, as JAX's default key is PRNGKey(3)."""
        generator = self._generator(generator)
        for t in range(len(plan["tgt"])):
            self._step(plan, t, rgb_flat, depth_flat, volume, generator, coherent)

    def _generator(self, generator: Optional[torch.Generator]) -> Optional[torch.Generator]:
        if generator is None and self.cfg.topk > 1:
            generator = torch.Generator(device=self.device).manual_seed(3)
        return generator

    def one_step_prediction(self, tgt_coord, generator: Optional[torch.Generator] = None) -> None:
        """Generate the frame at tgt_coord as the `curr`-th step, from the
        frames and the map as they stand, and mark it visited (the
        reference's per-step loop; `curr` is the caller's to advance)."""
        plan = self._upload_plan([self._plan_step(tgt_coord, self.curr)])
        self._step(plan, 0, self.rgb_buf, self.depth_buf, self.volume, generator, self.cfg.coherent_plane_depth)
        self.grid.visited[plan["tgt"][0]] = True

    @torch.inference_mode()
    def scene_expansion(self, generator: Optional[torch.Generator] = None, progress: bool = False,
                        fused: bool = True):
        """Unroll the rest of the trajectory. Returns the (rgb [G, H, W, 3],
        depth [G, H, W]) device buffers. `generator` (on the device) draws
        the samples at topk > 1; topk=1 draws nothing. Under map
        re-query, the map (`volume`) holds every frame at the end, and a
        warning reports truncation, pool drops or recycling.

        fused=True plans the whole unroll first and uploads the plan once;
        fused=False plans each step when it comes (one_step_prediction) and,
        with an output_dir, writes each frame as it is made. Both compute the
        same frames. `progress` prints a line a frame (fused=False). With an
        output_dir, every frame and the point clouds are written at the end
        (export_frames, export_point_clouds)."""
        if fused:
            self._unroll(self.build_plan(), self.rgb_buf, self.depth_buf, self.volume, generator,
                         self.cfg.coherent_plane_depth)
            self.grid.visited[:] = True
            self.curr = len(self.order)
        else:
            generator = self._generator(generator)
            total = len(self.order) - self.curr
            for n in range(total):
                tgt = self.order[self.curr]
                self.one_step_prediction(tgt, generator)
                if self.output_dir:
                    self.export_frame(self.output_dir, self.curr, tgt)
                self.curr += 1
                if progress:
                    print(f"frame {n + 1}/{total}", flush=True)
        self._check_fusion()
        if self.output_dir:
            self.export_frames(self.output_dir)
            self.export_point_clouds(self.output_dir)
        return self.rgb_buf, self.depth_buf

    def fusion_stats(self) -> Tuple[float, float, float, float]:
        """(fused / valid fraction, valid depth samples, pool drops, pool
        recycles) of the map; (1, 0, 0, 0) without one."""
        if self.volume is None:
            return 1.0, 0.0, 0.0, 0.0
        return fusion_fraction(self.volume)

    def _check_fusion(self) -> None:
        """Warn where the map truncated the scene, dropped or recycled pool
        slots, or outran the claim key's frame count."""
        if self.volume is None:
            return
        frac, n_valid, dropped, recycled = self.fusion_stats()
        cap = self.tsdf_cfg.pool_capacity
        if n_valid > 0 and frac < 0.99:
            warnings.warn(f"only {frac:.1%} of {n_valid:.0f} valid depth samples landed inside the TSDF volume "
                          f"(dims={self.tsdf_cfg.dims}, origin={self.tsdf_cfg.origin}): the map truncates the scene")
        if dropped > 0:
            warnings.warn(f"surface-voxel pool overflowed ({dropped:.0f} candidates dropped; capacity {cap}); "
                          "raise tsdf_pool_capacity")
        if recycled > 0:
            warnings.warn(f"surface-voxel pool wrapped: {recycled:.0f} oldest slots recycled (capacity {cap}); "
                          "raise tsdf_pool_capacity to keep the whole history resident")
        if int(self.volume.frame) >= CLAIM_MAX_FRAMES:
            warnings.warn(f"volume integrated {int(self.volume.frame)} frames >= claim-key capacity "
                          f"{CLAIM_MAX_FRAMES}; pool dedup degrades beyond that: start a fresh volume")

    @torch.inference_mode()
    def scene_expansion_batched(self, seeds_batch: list, generator: Optional[torch.Generator] = None, mesh=None):
        """Unroll S scenes at once: one plan (this generator's trajectory
        and visited state, as `build_plan` gives it) serves every scene, and
        each step runs the conditioning and the model at batch S. Under map
        re-query the S maps live in one batched volume (`create_volume(...,
        n_scenes=S)`): each seed coord, in sorted order, is fused for all
        scenes in one integrate at the shared pose, then every step renders
        and fuses all S at once; the volume stays in `batched_volume` for
        telemetry. As in the JAX package, the batched map applies no
        coherent_plane_depth and issues no fusion warning, and only the
        splat renders it (requery_method "raycast" raises). This generator's
        own buffers and state are left as they are.

        Args:
          seeds_batch: one seed list [(coord, rgb, depth), ...] per scene;
            every scene must seed the same coords.
          generator: on the device, draws the samples at topk > 1; topk=1
            draws nothing.
          mesh: a data mesh of several ranks (`parallel.mesh.make_mesh`),
            every rank calling with the same arguments: the scene axis is
            sharded over it, S must divide by its size, and each rank
            unrolls its contiguous block of S / n scenes with its replica of
            the model (rank 0's weights, broadcast first), with no
            collective until both buffers are gathered at the end. Map
            re-query gives each rank its own batched volume
            (`batched_volume`: its scenes), whose `stats` are summed over
            the ranks, the batch-global telemetry of JAX's volume. At topk > 1
            each rank draws the whole batch's noise and keeps its scenes'
            rows, so every scene's draws are the unsharded run's. A rank
            runs the model at its own batch, S / n: with one scene a rank
            that is batch 1, whose attention takes the plain path where the
            unsharded batch takes flash attention (`models.vqgan.nn.AttnBlock`),
            so its frames round differently; two or more a rank take the
            unsharded route.
        Returns:
          (rgb [S, G, H, W, 3], depth [S, G, H, W]) on the device.
        """
        self._check_seeds(seeds_batch)
        if mesh is not None and mesh.group is not None:
            s, n = len(seeds_batch), mesh.size
            if s % n:
                raise ValueError(f"{s} scenes do not shard over {n} devices")
            per = s // n
            distributed.replicate_global(self.model, mesh)
            generator = self._generator(generator)
            rgb, depth = self.scene_expansion_batched(seeds_batch[mesh.rank * per: (mesh.rank + 1) * per],
                                                      None if generator is None else RowShard(generator, mesh.rank, n))
            if self.cfg.use_rgbd_integration:  # the batch's telemetry, as JAX's one volume keeps it
                distributed.all_reduce_(self.batched_volume.stats, group=mesh.group)
            return distributed.all_gather_rows(rgb, mesh.group), distributed.all_gather_rows(depth, mesh.group)
        rgb_flat, depth_flat = self.batched_buffers(seeds_batch)
        h, w = self.cfg.image_resolution
        s, g = len(seeds_batch), self.grid.size
        volume = None
        if self.cfg.use_rgbd_integration:
            self.batched_volume = None  # free the last one first
            volume = self.batched_volume = self.seeded_volume(seeds_batch, depth_flat)
        self._unroll(self.build_plan(), rgb_flat, depth_flat, volume, generator)
        return rgb_flat.reshape(s, g, h, w, 3), depth_flat.reshape(s, g, h, w)

    def seeded_volume(self, seeds_batch: list, depth_flat) -> TSDFVolume:
        """The batched map of the S scenes of seeds_batch before their
        first step: a volume of S scenes into which each seed coord, in
        sorted order, is fused for all scenes at once from depth_flat [S*G,
        H, W] (batched_buffers'). Raises for requery_method "raycast",
        which cannot render it."""
        if self.cfg.requery_method != "splat":
            raise NotImplementedError("batched map rendering supports method='splat' only")
        h, w = self.cfg.image_resolution
        s, g = len(seeds_batch), self.grid.size
        volume = create_volume(self.tsdf_cfg, n_scenes=s, device=self.device)
        for coord in sorted(c for c, _, _ in seeds_batch[0]):
            idx = self.grid.index(*coord)
            integrate(volume, self.tsdf_cfg, depth_flat.reshape(s, g, h, w)[:, idx], None, self.ks[0],
                      self._w2c(idx))
        return volume

    @staticmethod
    def _check_seeds(seeds_batch: list) -> None:
        if not seeds_batch:
            raise ValueError("seeds_batch holds no scene")
        coords0 = sorted(c for c, _, _ in seeds_batch[0])
        if any(sorted(c for c, _, _ in seeds) != coords0 for seeds in seeds_batch[1:]):
            raise ValueError("all scenes must seed the same grid coords")

    def batched_buffers(self, seeds_batch: list):
        """The flat (rgb [S*G, H, W, 3], depth [S*G, H, W]) device buffers of
        S scenes, zero but for each scene's seed frames at s*G + index.
        Raises ValueError unless every scene seeds the same coords."""
        self._check_seeds(seeds_batch)
        h, w = self.cfg.image_resolution
        s, g = len(seeds_batch), self.grid.size
        rgb_flat = torch.zeros((s * g, h, w, 3), dtype=torch.float32, device=self.device)
        depth_flat = torch.zeros((s * g, h, w), dtype=torch.float32, device=self.device)
        for si, seeds in enumerate(seeds_batch):
            for coord, rgb, depth in seeds:
                idx = si * g + self.grid.index(*coord)
                rgb_flat[idx] = torch.as_tensor(rgb, dtype=torch.float32)
                depth_flat[idx] = torch.as_tensor(depth, dtype=torch.float32)
        return rgb_flat, depth_flat

    # ------------------------------------------------------------- exports
    def _write_frame(self, out_dir: str, step: int, coord, rgb: np.ndarray, depth: np.ndarray) -> None:
        """im_{step:05d}_{i:02d}_{j:02d}.png and its dm_ / R_ / t_ .npy files."""
        idx = self.grid.index(*coord)
        name = f"{step:05d}_{coord[0]:02d}_{coord[1]:02d}"
        write_png(os.path.join(out_dir, f"im_{name}.png"), np.clip((rgb + 1) / 2 * 255.0, 0, 255).astype(np.uint8))
        np.save(os.path.join(out_dir, f"dm_{name}.npy"), depth)
        np.save(os.path.join(out_dir, f"R_{name}.npy"), self.grid.R[idx])
        np.save(os.path.join(out_dir, f"t_{name}.npy"), self.grid.t[idx])

    def export_frame(self, out_dir: str, step: int, coord) -> None:
        """Write the frame at coord as the step-th of the reference's layout."""
        os.makedirs(out_dir, exist_ok=True)
        idx = self.grid.index(*coord)
        self._write_frame(out_dir, step, coord, self.rgb_buf[idx].cpu().numpy(), self.depth_buf[idx].cpu().numpy())

    def export_frames(self, out_dir: str) -> None:
        """Write every visited frame in the reference's layout, numbered by
        its place in the visit order: im_{step:05d}_{i:02d}_{j:02d}.png
        (8-bit RGB), dm_*.npy (z-depth), R_*.npy and t_*.npy (world ->
        camera)."""
        os.makedirs(out_dir, exist_ok=True)
        rgb, depth = self.rgb_buf.cpu().numpy(), self.depth_buf.cpu().numpy()
        for step, coord in enumerate(self.order):
            idx = self.grid.index(*coord)
            if self.grid.visited[idx]:
                self._write_frame(out_dir, step, coord, rgb[idx], depth[idx])

    def export_point_clouds(self, out_dir: str) -> None:
        """merged_pcds.ply: every visited frame unprojected to coloured
        world points. Under map re-query also rgbd_integrated_mesh.ply, the
        map's surface points, and rgbd_integrated_trimesh.ply, its triangle
        mesh (`mapping.mesh`, capped at 8 M triangles), both coloured by
        reprojection into the frames. A failure to build or run the mesh
        extractor raises."""
        from sgam_neurips22_tpu_torch.mapping.mesh import extract_mesh, write_mesh_ply

        os.makedirs(out_dir, exist_ok=True)
        rgb, depth = self.rgb_buf.cpu().numpy(), self.depth_buf.cpu().numpy()
        visited = [i for i in range(self.grid.size) if self.grid.visited[i]]
        if visited:
            pts, cols = merge_point_clouds(
                unproject_to_color_point_cloud(rgb[i], depth[i], np.asarray(self.grid.K), self.grid.c2w(i))
                for i in visited)
            write_ply(os.path.join(out_dir, "merged_pcds.ply"), pts, cols)
        if self.volume is None:
            return
        w2cs = np.stack([self.grid.w2c(i) for i in visited]) if visited else None

        def colorize(points: np.ndarray) -> np.ndarray:
            if w2cs is None:
                return np.full((len(points), 3), 0.5, np.float32)
            if len(points) * len(w2cs) > 2e9:
                print(f"note: skipping color reprojection for {len(points)} points x {len(w2cs)} frames "
                      "(host cost); exporting gray")
                return np.full((len(points), 3), 0.5, np.float32)
            return colorize_points(points, rgb[visited], depth[visited], np.asarray(self.grid.K), w2cs,
                                   tol=4 * self.tsdf_cfg.voxel_size)

        pts, _ = extract_points(self.volume, self.tsdf_cfg)
        write_ply(os.path.join(out_dir, "rgbd_integrated_mesh.ply"), pts, colorize(pts))
        verts, _ = extract_mesh(self.volume, self.tsdf_cfg, max_triangles=8_000_000)
        if len(verts):
            write_mesh_ply(os.path.join(out_dir, "rgbd_integrated_trimesh.ply"), verts,
                           colorize(verts.reshape(-1, 3)).reshape(verts.shape))
