"""Infinite scene generation, splat-conditioned — port of the splat path of
`sgam_neurips22_tpu/pipeline/scene_generation.py`, for one scene
(`scene_expansion`) and for S scenes at once (`scene_expansion_batched`).

The plan (per-step target, sources, relative transforms) is built on the
host from the pose grid and uploaded once; the unroll is one loop over it
in which every frame stays on the device: source gather -> splat
conditioning -> encode -> nearest codeword (or a top-k draw) -> decode ->
depth decode -> write into the [G, H, W, 3] RGB and [G, H, W] depth
buffers, updated in place. The batched unroll keeps S scenes' buffers
flat, [S*G, ...], shares the plan across scenes and runs the model at
batch S with flash attention.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from sgam_neurips22_tpu_torch.core.device import resolve_device
from sgam_neurips22_tpu_torch.geometry.codec import get_codec
from sgam_neurips22_tpu_torch.geometry.splat import COLLISIONS
from sgam_neurips22_tpu_torch.models.conditioning import get_x
from sgam_neurips22_tpu_torch.models.vqgan.model import VQModel
from sgam_neurips22_tpu_torch.pipeline.ordering import ORDERS
from sgam_neurips22_tpu_torch.pipeline.selection import select_sources
from sgam_neurips22_tpu_torch.pipeline.trajectory import default_intrinsics, prepare_grid

# reference num_src defaults (inference_pipeline.py:68,90)
DEFAULT_NUM_SRC = {"clevr-infinite": 5, "google_earth": 3}


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
    collision: str = "nearest"  # geometry.splat.COLLISIONS
    # splat every s-th source pixel with per-source phase offsets
    # (geometry.splat.render_projection_from_srcs); 1 = every pixel, as the
    # reference
    splat_stride: int = 1

    def __post_init__(self):
        if self.collision not in COLLISIONS:
            raise ValueError(f"unknown collision mode {self.collision!r}")
        s = int(self.splat_stride)
        h, w = self.image_resolution
        if self.collision == "nearest":
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
    """

    def __init__(
        self,
        model: VQModel,
        cfg: SceneGenConfig,
        seeds: list,
        intrinsics: Optional[np.ndarray] = None,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.codec = get_codec(cfg.dataset)
        if intrinsics is None:
            intrinsics = default_intrinsics(cfg.dataset, cfg.image_resolution)
        self.grid = prepare_grid(cfg.dataset, cfg.output_dim, cfg.step_size_denom, intrinsics)
        self.order = ORDERS[cfg.order](self.grid.rows, self.grid.cols)
        self.ks = torch.as_tensor(
            np.tile(self.grid.K.astype(np.float32), (cfg.effective_num_src, 1, 1)),
            device=self.device,
        )
        self._seeds = seeds
        self._plan_key = None
        self.reset()

    def reset(self, seeds: Optional[list] = None) -> None:
        """(Re)initialise the frame buffers and visited state from the seeds."""
        if seeds is not None:
            self._seeds = seeds
        self.rgb_buf, self.depth_buf = self.batched_buffers([self._seeds])
        self.grid.visited[:] = False
        for coord, _, _ in self._seeds:
            self.grid.visited[self.grid.index(*coord)] = True
        self.curr = 1

    def _step_inputs_host(self, tgt_coord, curr):
        """Numpy inputs of the `curr`-th step: source indices padded to
        num_src (+ mask) and source->target relative transforms."""
        n = self.cfg.effective_num_src
        src_coords = select_sources(self.grid, self.order, curr, tgt_coord, n, self.cfg.dataset)
        idxs = [self.grid.index(*c) for c in src_coords]
        mask = np.zeros(n, np.float32)
        mask[: len(idxs)] = 1.0
        pad = idxs + [idxs[0] if idxs else 0] * (n - len(idxs))
        t_tgt = self.grid.w2c(self.grid.index(*tgt_coord))
        r_rels = np.zeros((n, 3, 3), np.float32)
        t_rels = np.zeros((n, 3), np.float32)
        for i, idx in enumerate(pad):
            t_rel = t_tgt @ np.linalg.inv(self.grid.w2c(idx))
            r_rels[i] = t_rel[:3, :3]
            t_rels[i] = t_rel[:3, 3]
        return np.asarray(pad, np.int64), mask, r_rels, t_rels

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
                tgt_coord = self.order[curr]
                steps.append((self.grid.index(*tgt_coord), *self._step_inputs_host(tgt_coord, curr)))
                self.grid.visited[steps[-1][0]] = True
        finally:
            self.grid.visited = visited
        tgt, src_idx, mask, r_rels, t_rels = (list(x) for x in zip(*steps)) if steps else ([],) * 5
        plan = {"tgt": tgt}
        for name, arrs in (("src_idx", src_idx), ("src_mask", mask), ("r_rels", r_rels), ("t_rels", t_rels)):
            plan[name] = torch.as_tensor(np.stack(arrs), device=self.device) if arrs else None
        self._plan_key, self._plan = key, plan
        return plan

    def step_batch(self, plan: dict, t: int, rgb_flat, depth_flat) -> dict:
        """The NHWC conditioning batch of step t for the S scenes whose
        frames sit flat in rgb_flat [S*G, H, W, 3] / depth_flat [S*G, H, W]
        (this generator's own buffers are the S = 1 case). Scene s reads its
        sources at s*G + src_idx: one leading-axis gather for the batch."""
        h, w = self.cfg.image_resolution
        g = self.grid.size
        s = rgb_flat.shape[0] // g
        src_idx = plan["src_idx"][t]
        flat_idx = (torch.arange(s, device=self.device) * g)[:, None] + src_idx[None]  # [S, N]
        n = src_idx.shape[0]
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

    def _unroll(self, plan: dict, rgb_flat, depth_flat, generator: Optional[torch.Generator]) -> None:
        """Every step of the plan for all scenes of the flat buffers, which
        take each new frame in place at s*G + tgt. At topk > 1 the steps
        draw from `generator` in turn; None is a generator on the device
        seeded with 3, as JAX's default key is PRNGKey(3)."""
        if generator is None and self.cfg.topk > 1:
            generator = torch.Generator(device=self.device).manual_seed(3)
        s = rgb_flat.shape[0] // self.grid.size
        scene_base = torch.arange(s, device=self.device) * self.grid.size
        for t, tgt in enumerate(plan["tgt"]):
            rgb, depth = self.decode_batch(self.condition(self.step_batch(plan, t, rgb_flat, depth_flat)), generator)
            dst = scene_base + tgt
            rgb_flat[dst] = rgb
            depth_flat[dst] = depth

    @torch.inference_mode()
    def scene_expansion(self, generator: Optional[torch.Generator] = None):
        """Unroll the rest of the grid. Returns the (rgb [G, H, W, 3],
        depth [G, H, W]) device buffers. `generator` (on the device) draws
        the samples at topk > 1; topk=1 draws nothing."""
        self._unroll(self.build_plan(), self.rgb_buf, self.depth_buf, generator)
        self.grid.visited[:] = True
        self.curr = len(self.order)
        return self.rgb_buf, self.depth_buf

    @torch.inference_mode()
    def scene_expansion_batched(self, seeds_batch: list, generator: Optional[torch.Generator] = None):
        """Unroll S scenes at once: one plan (this generator's trajectory
        and visited state, as `build_plan` gives it) serves every scene, and
        each step runs the splat and the model at batch S. This generator's
        own buffers and state are left as they are.

        Args:
          seeds_batch: one seed list [(coord, rgb, depth), ...] per scene;
            every scene must seed the same coords.
          generator: on the device, draws the samples at topk > 1; topk=1
            draws nothing.
        Returns:
          (rgb [S, G, H, W, 3], depth [S, G, H, W]) on the device.
        """
        rgb_flat, depth_flat = self.batched_buffers(seeds_batch)
        self._unroll(self.build_plan(), rgb_flat, depth_flat, generator)
        h, w = self.cfg.image_resolution
        return rgb_flat.reshape(-1, self.grid.size, h, w, 3), depth_flat.reshape(-1, self.grid.size, h, w)

    def batched_buffers(self, seeds_batch: list):
        """The flat (rgb [S*G, H, W, 3], depth [S*G, H, W]) device buffers of
        S scenes, zero but for each scene's seed frames at s*G + index.
        Raises ValueError unless every scene seeds the same coords."""
        if not seeds_batch:
            raise ValueError("seeds_batch holds no scene")
        coords0 = sorted(c for c, _, _ in seeds_batch[0])
        if any(sorted(c for c, _, _ in seeds) != coords0 for seeds in seeds_batch[1:]):
            raise ValueError("all scenes must seed the same grid coords")
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
