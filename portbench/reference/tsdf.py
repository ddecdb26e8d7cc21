# Frozen copy of sgam_neurips22_tpu_torch/mapping/tsdf.py at commit e4e59b7, kept as the
# benchmark's plain reference: imports point into portbench.reference, and
# the hand kernels are replaced by the plain PyTorch versions of plain_ops.
"""The TSDF map of map-requery generation: scatter-band fusion and
surface-pool rendering — port of `sgam_neurips22_tpu/mapping/tsdf.py`.

The volume is a dense flat f32 grid of signed TSDF sums (every band sample
adds its constant contribution, so sign(sum) == sign(mean), and a voxel is
observed where the sum is not 0), a surface-voxel pool split into spatial
cells, each a ring of slots, and two claim-sized int32 tables: `claim`
(in-frame dedup of pool candidates, generation-keyed) and `inpool` (which
voxels the pool holds). `integrate` fuses one frame per scene with one
scatter-add of its band samples; `render_depth` splats the pool through the
z-buffer kernel (`ops.zbuffer.zbuffer_min`, one call over every sub-chunk
of the pool) or marches rays through the grid.

Differences from the JAX package, none of which changes a value:
- every update is in place on the volume's tensors (JAX donates them);
- a scatter that JAX drops (mode="drop") targets a no-op value (min with
  INT32_MAX, max with 0) or the pool's one trailing dump slot;
- the pool splat computes every sub-chunk of every cell under one validity
  mask, where JAX skips empty or invisible sub-chunks with lax.cond: the
  per-frame loop never reads a device value on the host;
- a division by a constant divides by a tensor (`core.dtypes.div_scalar`),
  so that CUDA rounds it as the CPU does, and every float -> int32 cast has
  XLA's semantics (`core.dtypes.to_int32`).
Arithmetic follows the JAX package run op by op: XLA contracts multiply-
adds into FMAs and folds constant divisions into reciprocal
multiplications when it compiles a jitted program or a lax.cond branch,
which moves a voxel id or a pixel across a boundary now and then.
The pool splat's uint32 keys (12-bit quantised depth above a 20-bit slot,
sentinel 0xFFFFFFFF) are built in int64 and flipped by their sign bit into
the kernel's int32 order, where the sentinel is INT32_MAX.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.plain_ops import resolve_device
from portbench.reference.dtypes import INT32_MAX, div_scalar, to_int32
from portbench.reference.camera import (
    ALL_ROWS,
    XLA_TRANSPOSED_ROWS,
    inv3x3,
    matvec3,
    pixel_grid,
)
from portbench.reference.plain_ops import grid_accumulate
from portbench.reference.plain_ops import zbuffer_min

# packed z-buffer key layout: 12 bits quantized depth + 20 bits pool slot
_POOL_IDX_BITS = 20
MAX_POOL_CAPACITY = 1 << _POOL_IDX_BITS
# claim key layout: frame << 18 | reversed ray position; 2^18 rays cover a
# 512x512 frame, and 13 bits of frame count 8191 integrate() calls a volume
# (beyond that the frame key clamps and in-frame dedup degrades)
_CLAIM_POS_BITS = 18
CLAIM_MAX_FRAMES = (1 << (31 - _CLAIM_POS_BITS)) - 1  # 8191
# the volume's state, as JAX's TSDFVolume holds it


def validate_ray_budget(image_size: Tuple[int, int], stride: int) -> None:
    """Raise at config time when a frame fuses more rays than the claim key
    holds (2^18: 512x512 at stride 1)."""
    h, w = image_size
    rays = -(-h // stride) * (-(-w // stride))
    if rays > (1 << _CLAIM_POS_BITS):
        need = 1
        while (-(-h // need)) * (-(-w // need)) > (1 << _CLAIM_POS_BITS):
            need += 1
        raise ValueError(
            f"rgbd integration at {h}x{w} with tsdf_integrate_stride={stride} "
            f"fuses {rays} rays/frame, over the 2^{_CLAIM_POS_BITS} claim-key "
            f"capacity; set tsdf_integrate_stride>={need} (voxel footprints "
            f"span ~2 px at working depths, so stride 2 is near-lossless)"
        )


@dataclass(frozen=True)
class TSDFConfig:
    """The volume's layout (JAX's TSDFConfig, field for field): see
    `sgam_neurips22_tpu/mapping/tsdf.py` for the measurements behind each."""

    dims: Tuple[int, int, int]  # voxels per axis (X, Y, Z)
    voxel_size: float
    sdf_trunc: float
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # world min corner
    depth_trunc: float = 20.0  # depth at or beyond this is not fused
    band_voxels: Optional[int] = None  # fused band half-width (None = from sdf_trunc)
    pool_capacity: int = 1 << 19  # surface-pool slots
    pool_recycle: bool = True  # a full cell recycles its oldest slots (False: drops the new)
    integrate_stride: int = 1  # fuse every s-th ray
    render_chunk: int = 1 << 18  # the pool splat's sub-chunk, <= 2^20
    pool_cells: Optional[int] = None  # spatial pool cells (None = auto)
    axis_order: Tuple[int, int, int] = (0, 1, 2)  # memory layout of the flat arrays
    claim_bits: int = 24  # claim/inpool tables of min(voxels, 2^claim_bits) entries

    def __post_init__(self):
        if int(np.prod(self.dims)) >= 2**31:
            raise ValueError(f"dims {self.dims} overflow int32 linear indexing")
        if not (0 < self.render_chunk <= (1 << 20)):
            raise ValueError(f"render_chunk {self.render_chunk} not in (0, 2^20]")
        if self.band_voxels is not None and not (1 <= self.band_voxels <= 8):
            raise ValueError(f"band_voxels {self.band_voxels} not in [1, 8]")
        if self.pool_cells is not None and not (1 <= self.pool_cells <= self.dims[self.split_axis]):
            raise ValueError(
                f"pool_cells {self.pool_cells} not in [1, "
                f"dims[{self.split_axis}]={self.dims[self.split_axis]}]"
            )
        if tuple(sorted(self.axis_order)) != (0, 1, 2):
            raise ValueError(f"axis_order {self.axis_order} is not a permutation")

    @property
    def n_voxels(self) -> int:
        return int(np.prod(self.dims))

    @property
    def split_axis(self) -> int:
        """The volume axis the pool cells slab along (the longest)."""
        return int(np.argmax(self.dims))

    @property
    def n_cells(self) -> int:
        if self.pool_cells is not None:
            return self.pool_cells
        auto = -(-self.pool_capacity // self.render_chunk)
        return int(np.clip(auto, 1, min(64, self.dims[self.split_axis])))

    @property
    def cell_cap(self) -> int:
        """Slots per cell; the pool holds n_cells * cell_cap slots."""
        return -(-self.pool_capacity // self.n_cells)

    @property
    def capacity(self) -> int:
        return self.cell_cap * self.n_cells

    @property
    def chunk(self) -> int:
        """The pool splat's sub-chunk size."""
        return min(self.cell_cap, self.render_chunk)

    def cell_bounds(self) -> list:
        """Per-cell voxel-coordinate ranges [(lo, hi_exclusive)] along
        split_axis: coordinate c belongs to cell (c * n_cells) // dims."""
        d, c = self.dims[self.split_axis], self.n_cells
        return [(-(-k * d // c), -(-(k + 1) * d // c)) for k in range(c)]

    @property
    def band(self) -> int:
        """Half-width of the fused band, in voxels, within [1, 8]."""
        if self.band_voxels is not None:
            return self.band_voxels
        return int(np.clip(round(self.sdf_trunc / self.voxel_size), 1, 8))

    @property
    def trunc(self) -> float:
        """Effective truncation distance: the fused band's extent."""
        return self.band * self.voxel_size

    @property
    def claim_size(self) -> int:
        return min(self.n_voxels, 1 << self.claim_bits)

    def claim_index(self, lin: torch.Tensor) -> torch.Tensor:
        """Voxel linear id -> claim-table slot: the id itself where the
        volume fits the table, else Knuth's multiplicative hash of the id
        as uint32 (computed in int64, whose low 32 bits wrap alike)."""
        if self.n_voxels <= self.claim_size:
            return lin
        h = ((lin.long() & 0xFFFFFFFF) * 2654435761) & 0xFFFFFFFF
        return (h >> (32 - self.claim_bits)).to(torch.int32)

    def lin_index(self, g: torch.Tensor) -> torch.Tensor:
        """Voxel coords [..., 3] (world axis order) -> flat index, laid out
        per `axis_order`."""
        o0, o1, o2 = self.axis_order
        d = self.dims
        return (g[..., o0] * d[o1] + g[..., o1]) * d[o2] + g[..., o2]

    def unlin_index(self, lin: torch.Tensor) -> tuple:
        """Flat index -> (x, y, z) voxel coords in world axis order."""
        o0, o1, o2 = self.axis_order
        d = self.dims
        c = [None, None, None]
        c[o2] = lin % d[o2]
        c[o1] = torch.div(lin, d[o2], rounding_mode="floor") % d[o1]
        c[o0] = torch.div(lin, d[o1] * d[o2], rounding_mode="floor")
        return tuple(c)


@dataclass
class TSDFVolume:
    """One volume, or S scenes' volumes folded into the leading axis of
    every array (scene s owns grid[s*V:(s+1)*V], cells [s*C, (s+1)*C), ...)."""

    grid: torch.Tensor  # [S*V] f32 signed TSDF sums; observed where != 0
    inpool: torch.Tensor  # [S*claim_size] int32: v+1 in bucket claim_index(v) while voxel v is pooled
    # [S*capacity + 1] int32 scene-offset voxel ids; cell k owns slots
    # [k*cell_cap, (k+1)*cell_cap) and only voxels of its slab. The last
    # slot takes the writes JAX drops, and is never read as a pool slot.
    pool_slots: torch.Tensor
    cell_counts: torch.Tensor  # [S*n_cells] int32 lifetime slots booked per cell
    stats: torch.Tensor  # [4] f32: valid samples, fused samples, pool drops, pool recycles
    frame: torch.Tensor  # [] int32 frames integrated so far
    claim: torch.Tensor  # [S*claim_size] int32 generation-keyed claim entries

    @property
    def pool_ids(self) -> torch.Tensor:
        """[S*capacity] the pool's slots (JAX's pool_ids)."""
        return self.pool_slots[:-1]

    @property
    def tsdf(self) -> torch.Tensor:
        """The TSDF in [-1, 1], flat [S*V] (sums clipped: the sign is the
        mean's; an unobserved voxel reads 0, so gate on `weight`)."""
        return torch.clamp(self.grid, -1.0, 1.0)

    @property
    def weight(self) -> torch.Tensor:
        """1 where a voxel was observed (any band sample touched it), flat [S*V]."""
        return (self.grid != 0.0).float()

    def to(self, device) -> "TSDFVolume":
        """A copy of the volume on `device`."""
        return TSDFVolume(**{f.name: getattr(self, f.name).to(device, copy=True) for f in dataclasses.fields(self)})


def create_volume(cfg: TSDFConfig, n_scenes: int = 1, device: str | torch.device = "cuda") -> TSDFVolume:
    """An empty volume of `n_scenes` scenes on `device`."""
    dev = resolve_device(device)
    s = int(n_scenes)

    def zeros(n, dtype=torch.int32):
        return torch.zeros(n, dtype=dtype, device=dev)

    return TSDFVolume(
        grid=zeros(s * cfg.n_voxels, torch.float32), inpool=zeros(s * cfg.claim_size),
        pool_slots=zeros(s * cfg.capacity + 1), cell_counts=zeros(s * cfg.n_cells),
        stats=zeros(4, torch.float32), frame=zeros((), torch.int32), claim=zeros(s * cfg.claim_size),
    )


def volume_scenes(vol: TSDFVolume, cfg: TSDFConfig) -> int:
    """Number of scenes folded into a volume's state."""
    return vol.cell_counts.shape[0] // cfg.n_cells


def auto_config(
    c2ws: np.ndarray,
    intrinsics: np.ndarray,
    image_size: Tuple[int, int],
    depth_range: Tuple[float, float],
    voxel_size: float,
    sdf_trunc: float,
    mem_cap_bytes: float = 6e9,
    pool_capacity: Optional[int] = None,
    band_voxels: Optional[int] = None,
    integrate_stride: int = 1,
    render_chunk: Optional[int] = None,
    pool_recycle: bool = True,
    pool_cells: Optional[int] = None,
    verbose: bool = True,
) -> TSDFConfig:
    """Size and place the volume to hold the hull of every camera's frustum
    slab between 0.8*near and 1.2*far (c2ws [G, 4, 4] OpenCV, intrinsics
    [3, 3], depth_range the codec's); coarsen the voxel by 2^(1/3) steps,
    with a warning, until grid + claim + inpool fit mem_cap_bytes. Default
    pool: 6 x the largest volume face, clamped to [2^16, 4*2^20]; memory
    layout from the trajectory's camera axes."""
    h, w = image_size
    lo, hi = depth_range
    near = max(0.8 * lo - sdf_trunc, 1e-3)
    far = 1.2 * hi + sdf_trunc
    corners = np.array([[0, 0, 1], [w, 0, 1], [0, h, 1], [w, h, 1], [w / 2, h / 2, 1]], np.float64)
    rays = corners @ np.linalg.inv(np.asarray(intrinsics, np.float64)).T  # unit z
    pts = []
    for c2w in np.asarray(c2ws, np.float64):
        for d in (near, far):
            pts.append((rays * d) @ c2w[:3, :3].T + c2w[:3, 3])
    pts = np.concatenate(pts, axis=0)
    lo_b = pts.min(axis=0) - 2 * voxel_size
    hi_b = pts.max(axis=0) + 2 * voxel_size

    vox = float(voxel_size)
    while True:
        dims = np.maximum(np.ceil((hi_b - lo_b) / vox).astype(int), 4)
        n_vox = int(np.prod(dims))
        mem = n_vox * 4 + 2 * min(n_vox, 1 << 24) * 4  # grid f32 + claim & inpool i32
        if mem <= mem_cap_bytes and n_vox < 2**31:
            break
        vox *= 2 ** (1.0 / 3.0)
    if vox != voxel_size and verbose:
        n_orig = float(np.prod(np.ceil((hi_b - lo_b) / voxel_size)))
        warnings.warn(
            f"TSDF volume at voxel {voxel_size} would need {n_orig:.3g} voxels; "
            f"coarsened to voxel {vox:.4f} to fit {mem_cap_bytes / 1e9:.1f} GB"
        )
    if pool_capacity is None:
        faces = (dims[0] * dims[1], dims[0] * dims[2], dims[1] * dims[2])
        pool_capacity = int(np.clip(6 * max(faces), 1 << 16, 4 * MAX_POOL_CAPACITY))
    # innermost axis = the world axis the image u-axis sweeps, middle = the
    # v-swept axis, outer = the rest
    r_mean = np.mean([c[:3, :3] for c in np.asarray(c2ws, np.float64)], axis=0)
    o2 = int(np.argmax(np.abs(r_mean[:, 0])))
    v_abs = np.abs(r_mean[:, 1]).copy()
    v_abs[o2] = -1.0
    o1 = int(np.argmax(v_abs))
    o0 = 3 - o1 - o2
    extra = {} if render_chunk is None else {"render_chunk": render_chunk}
    return TSDFConfig(
        dims=tuple(int(d) for d in dims),
        voxel_size=vox,
        sdf_trunc=sdf_trunc if vox == voxel_size else sdf_trunc * vox / voxel_size,
        origin=tuple(float(v) for v in lo_b),
        band_voxels=band_voxels,
        pool_capacity=pool_capacity,
        integrate_stride=integrate_stride,
        pool_recycle=pool_recycle,
        pool_cells=pool_cells,
        axis_order=(o0, o1, o2),
        **extra,
    )


class _Consts(NamedTuple):
    """A config's constants on one device."""

    origin: torch.Tensor  # [3] f32
    dims: torch.Tensor  # [3] int32
    corners: torch.Tensor  # [C, 8, 3] f32 world corners of each pool cell's box
    cell_of: torch.Tensor  # [capacity] int64 cell of each slot
    pos: torch.Tensor  # [capacity] int32 slot position within its cell
    starts: torch.Tensor  # [n_cells * n_sub] int64 first slot of each sub-chunk
    steps: torch.Tensor  # [8, 3] int32 the trilinear corners' offsets


@functools.lru_cache(maxsize=8)
def _consts(cfg: "TSDFConfig", device: torch.device) -> _Consts:
    """The constants of `cfg` on `device`, made once: a host-to-device copy
    from pageable memory may wait for the stream, which the per-frame loop
    must not do."""
    cap, cell_cap = cfg.capacity, cfg.cell_cap
    n_sub = -(-cell_cap // cfg.chunk)
    arrays = (
        (cfg.origin, torch.float32), (cfg.dims, torch.int32), (_cell_corners(cfg), torch.float32),
        (np.arange(cap) // cell_cap, torch.int64), (np.arange(cap) % cell_cap, torch.int32),
        ([c * cell_cap + k * cfg.chunk for c in range(cfg.n_cells) for k in range(n_sub)], torch.int64),
        ([[dx, dy, dz] for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)], torch.int32),
    )
    return _Consts(*(torch.as_tensor(np.asarray(a), dtype=dt).to(device) for a, dt in arrays))


def _camera_rays(intrinsics, extrinsic, h: int, w: int, fma_rows: tuple = ALL_ROWS):
    """(camera centres [..., 3], world ray directions [..., H, W, 3] with
    unit z in the camera frame) for extrinsics [..., 4, 4] world -> camera:
    a point at parameter t along a ray has camera z-depth t. fma_rows as in
    matvec3: JAX's vmapped rays (integrate, the splat's refinement) are all
    fused; its single-pose rays (the raycast) are XLA_TRANSPOSED_ROWS."""
    dirs_cam = matvec3(inv3x3(intrinsics), pixel_grid(h, w, torch.float32, intrinsics.device))
    r_t = extrinsic[..., :3, :3].transpose(-1, -2)
    cam_center = -matvec3(r_t, extrinsic[..., :3, 3])
    return cam_center, matvec3(r_t[..., None, None, :, :], dirs_cam, fma_rows)


def integrate(vol: TSDFVolume, cfg: TSDFConfig, depth, rgb, intrinsics, extrinsic) -> TSDFVolume:
    """Fuse one RGB-D frame a scene, in place, and return the volume.

    For every valid pixel (0 < depth < depth_trunc), 2*band samples along
    its ray at voxel spacing around the measured depth scatter-add their
    constant contribution into the grid (band axis outermost, as JAX's
    one scatter). The sample just in front of the surface is the ray's pool
    candidate: deduplicated in-frame through the claim table (the smallest
    pixel position wins) and across frames through `inpool`, it books the
    next slot of its slab's cell, recycling the cell's oldest slot when the
    cell is full (pool_recycle) or dropping itself. Telemetry accumulates
    in `stats`.

    Args:
      depth: [H, W] or [S, H, W] z-depth (0 = invalid), S the volume's scenes.
      rgb: unused (colour is reconstructed at export time).
      intrinsics: [3, 3]; extrinsic: [4, 4] or [S, 4, 4] world -> camera.
    """
    del rgb
    if depth.dim() == 2:
        depth = depth[None]
    if extrinsic.dim() == 2:
        extrinsic = extrinsic[None].expand(depth.shape[0], 4, 4)
    ns, h, w = depth.shape
    dev = depth.device
    n_vox = cfg.n_voxels
    if vol.cell_counts.shape[0] != ns * cfg.n_cells:
        raise ValueError(
            f"integrate: volume holds {volume_scenes(vol, cfg)} scene(s) but depth batches {ns}"
        )
    band = cfg.band
    cam_center, dirs_world = _camera_rays(intrinsics, extrinsic, h, w)  # [S, 3], [S, H, W, 3]
    s = cfg.integrate_stride
    if s > 1:  # every s-th ray, at its pixel centre
        depth, dirs_world = depth[:, ::s, ::s], dirs_world[:, ::s, ::s]
    rays = depth.shape[1] * depth.shape[2]
    if rays > (1 << _CLAIM_POS_BITS):
        raise ValueError(
            f"integrate: {rays} rays exceed the claim-key capacity 2^{_CLAIM_POS_BITS}; "
            "raise integrate_stride"
        )
    valid = (depth > 0) & (depth < cfg.depth_trunc)
    # sample offsets: +-(0.5, 1.5, ..., band - 0.5) voxels around the surface
    offsets = (torch.arange(2 * band, dtype=torch.float32, device=dev) + 0.5 - band) * cfg.voxel_size
    zs = depth[..., None] + offsets  # [S, H, W, K2]
    pts = cam_center[:, None, None, None, :] + dirs_world[..., None, :] * zs[..., None]
    consts = _consts(cfg, dev)
    g = to_int32(torch.floor(div_scalar(pts - consts.origin, cfg.voxel_size)))
    inb = ((g >= 0) & (g < consts.dims)).all(dim=-1)
    ok = valid[..., None] & inb & (zs > 0)
    scene_off = torch.arange(ns, dtype=torch.int32, device=dev) * n_vox
    lin = torch.where(ok, cfg.lin_index(g) + scene_off[:, None, None, None], 0)
    # the sdf at a sample is (measured depth - z) = -offset: constant per slot;
    # a masked sample adds 0.0 at index 0
    contrib = torch.clamp(div_scalar(-offsets, cfg.trunc), -1.0, 1.0)
    vals = contrib * ok.float()
    # each voxel's samples added one by one in their order, on the card as on
    # the CPU (ops/grid_accumulate: index_add_'s float atomics made the grid,
    # and the frames after it, differ between two runs of the same frames)
    grid_accumulate(vol.grid, lin.movedim(-1, 0).reshape(-1), vals.movedim(-1, 0).reshape(-1))

    # telemetry: did the valid samples land inside the volume?
    center_ok = ok[..., band - 1] | ok[..., band]
    n_valid, n_fused = valid.sum(), (valid & center_ok).sum()

    # pool candidates, deduplicated in-frame by a scatter-max of
    # generation-keyed entries into the persistent claim table: a candidate
    # wins iff it reads itself back
    cand = lin[..., band - 1].reshape(ns, rays)  # scene-offset ids
    cand_lo = cand - scene_off[:, None]  # within-scene ids
    cand_ok = ok[..., band - 1].reshape(ns, rays)
    pos = torch.arange(rays, dtype=torch.int32, device=dev)
    fkey = torch.clamp(vol.frame + 1, max=CLAIM_MAX_FRAMES)
    own = ((fkey << _CLAIM_POS_BITS) | ((1 << _CLAIM_POS_BITS) - 1 - pos)).expand(ns, rays)
    claim_off = (torch.arange(ns, dtype=torch.int32, device=dev) * cfg.claim_size)[:, None]
    cslot = cfg.claim_index(cand_lo) + claim_off
    cslot_l = cslot.reshape(-1).long()
    vol.claim.scatter_reduce_(0, cslot_l, torch.where(cand_ok, own, 0).reshape(-1), "amax")
    first = cand_ok & (vol.claim[cslot_l].reshape(ns, rays) == own)
    new = first & (vol.inpool[cslot_l].reshape(ns, rays) != cand_lo + 1)

    # slots: each candidate books the next slot of its own slab's cell;
    # per-cell ranks from a one-hot cumsum, laid out [S, C, N] so that the
    # scan runs along the innermost axis (along N of [S, N, C], torch's
    # scan walks each of the C columns serially: 5-6 ms a frame on an H100)
    n_cells, cell_cap = cfg.n_cells, cfg.cell_cap
    axis_coord = g[..., band - 1, cfg.split_axis].reshape(ns, rays)
    cell = torch.div(axis_coord * n_cells, cfg.dims[cfg.split_axis], rounding_mode="floor").clamp(0, n_cells - 1)
    onehot = (cell[:, None] == torch.arange(n_cells, dtype=torch.int32, device=dev)[:, None]) & new[:, None]
    ranks = torch.cumsum(onehot.int(), dim=2, dtype=torch.int32)  # [S, C, N] inclusive
    booked = ranks[..., -1]  # [S, C]
    rank = torch.gather(ranks, 1, cell[:, None].long())[:, 0]  # 1-based
    gcell = cell + (torch.arange(ns, dtype=torch.int32, device=dev) * n_cells)[:, None]
    counts = vol.cell_counts[gcell.long()]
    slots = counts + rank - 1  # lifetime position in the cell
    # a frame books at most cell_cap slots a cell (an in-frame ring wrap
    # would book one slot twice); the excess is dropped and counted
    fits = new & (slots < counts + cell_cap)
    dump = ns * cfg.capacity  # pool_slots' trailing slot
    if cfg.pool_recycle:
        slot = torch.where(fits, gcell * cell_cap + slots % cell_cap, dump)
        reused = fits & (slots >= cell_cap)
        # deregister the evicted occupants; .min(0) is set(0) for the
        # non-negative registry, and deterministic under hash collisions
        evict = vol.pool_slots[slot.long()] - scene_off[:, None]
        eslot = torch.where(reused, cfg.claim_index(evict) + claim_off, 0)
        clear = torch.where(reused, 0, INT32_MAX).to(torch.int32)
        vol.inpool.scatter_reduce_(0, eslot.reshape(-1).long(), clear.reshape(-1), "amin")
        n_recycled = reused.sum()
    else:
        fits = fits & (slots < cell_cap)
        slot = torch.where(fits, gcell * cell_cap + slots, dump)
        n_recycled = torch.zeros((), dtype=torch.int64, device=dev)
    vol.pool_slots.index_put_((slot.reshape(-1).long(),), cand.reshape(-1))
    # register the additions (.max: deterministic when two voxels hash alike)
    aslot = torch.where(fits, cslot, 0).reshape(-1).long()
    vol.inpool.scatter_reduce_(0, aslot, torch.where(fits, cand_lo + 1, 0).reshape(-1), "amax")
    dropped = new & ~fits
    dropped_per_cell = (onehot & dropped[:, None]).sum(dim=2, dtype=torch.int32)  # [S, C]
    vol.cell_counts.add_((booked - dropped_per_cell).reshape(-1))
    vol.stats.add_(torch.stack([n_valid, n_fused, dropped.sum(), n_recycled]).float())
    vol.frame.add_(1)
    return vol


# --------------------------------------------------------------------------
# rendering
# --------------------------------------------------------------------------
def _sample_grid(vol: TSDFVolume, cfg: TSDFConfig, pts, interp: str, scene_off=0):
    """(tsdf sum, observed) at world points [..., 3]: one gather a point
    ("nearest") or eight ("trilinear"). `scene_off` selects the scene block
    of a batched volume."""
    dev = pts.device
    consts = _consts(cfg, dev)
    dims = consts.dims
    g = div_scalar(pts - consts.origin, cfg.voxel_size) - 0.5
    if interp == "nearest":
        g = to_int32(torch.round(g))
        inb = ((g >= 0) & (g < dims)).all(dim=-1)
        gc = torch.minimum(g.clamp(min=0), dims - 1)
        v = vol.grid[(cfg.lin_index(gc) + scene_off).long()]
        return v, inb & (v != 0.0)
    g0 = torch.floor(g)
    frac = g - g0
    g0 = to_int32(g0)
    vals, obs = 0.0, torch.ones(pts.shape[:-1], dtype=torch.bool, device=dev)
    for i, (dx, dy, dz) in enumerate((dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)):
        idx = g0 + consts.steps[i]
        inb = ((idx >= 0) & (idx < dims)).all(dim=-1)
        ic = torch.minimum(idx.clamp(min=0), dims - 1)
        v = vol.grid[(cfg.lin_index(ic) + scene_off).long()]
        wgt = (
            (frac[..., 0] if dx else 1 - frac[..., 0])
            * (frac[..., 1] if dy else 1 - frac[..., 1])
            * (frac[..., 2] if dz else 1 - frac[..., 2])
        )
        vals = vals + wgt * v
        obs = obs & inb & (v != 0.0)
    return vals, obs


def _cell_corners(cfg: TSDFConfig) -> np.ndarray:
    """[C, 8, 3] f32 world corners of each pool cell's static box."""
    corners = np.empty((cfg.n_cells, 8, 3), np.float32)
    sel = np.array([[(k >> 2) & 1, (k >> 1) & 1, k & 1] for k in range(8)], np.float64)
    for ci, (alo, ahi) in enumerate(cfg.cell_bounds()):
        lo, hi = np.zeros(3), np.asarray(cfg.dims, np.float64).copy()
        lo[cfg.split_axis], hi[cfg.split_axis] = alo, ahi
        lo = lo * cfg.voxel_size + np.asarray(cfg.origin)
        hi = hi * cfg.voxel_size + np.asarray(cfg.origin)
        corners[ci] = lo * (1 - sel) + hi * sel
    return corners


def _fill_holes(depth: torch.Tensor) -> torch.Tensor:
    """Two passes of: each 0 pixel of depth [S, H, W] takes the smallest
    nonzero depth of its 3x3 neighbourhood (the nearest surface wins)."""
    _, h, w = depth.shape
    big = 3.4e38
    for _ in range(2):
        p = F.pad(torch.where(depth == 0.0, big, depth), (1, 1, 1, 1), value=big)
        neigh = torch.stack([p[:, dy: dy + h, dx: dx + w] for dy in range(3) for dx in range(3)], dim=-1).amin(-1)
        depth = torch.where(depth == 0.0, torch.where(neigh < big, neigh, 0.0), depth)
    return depth


def pool_splat_keys(vol: TSDFVolume, cfg: TSDFConfig, intrinsics, extrinsic, image_size, near: float, far: float,
                    cull: bool = True):
    """The pool splat's z-buffer input and what decodes its output: (pix
    [nck*S, chunk] int32, key [nck*S, chunk] int32, per-slot camera z
    [S, capacity], starts [nck] int64 first slot of each sub-chunk), row
    c*S + s holding sub-chunk c of scene s (extrinsic [S, 4, 4]).

    Every slot of the pool is projected once; a slot is valid where it is
    live in its cell, its cell's box is visible (cull), its depth lies in
    (max(near, 1e-3), far) and its pixel floor(u + 0.5), floor(v + 0.5) on
    the image. Its key is ((zq << 20) | slot within the sub-chunk) - 2^31,
    the uint32 key flipped into int32 order, zq its depth quantised to 12
    bits over (near, far); an invalid slot has pixel 0 and key INT32_MAX."""
    h, w = image_size
    ns = extrinsic.shape[0]
    dev = extrinsic.device
    r, t = extrinsic[:, :3, :3], extrinsic[:, :3, 3]
    n_cells, cell_cap, chunk = cfg.n_cells, cfg.cell_cap, cfg.chunk
    k00, k02, k11, k12 = intrinsics[0, 0], intrinsics[0, 2], intrinsics[1, 1], intrinsics[1, 2]

    # per-cell visibility [S, C] from the cells' static boxes: off the image
    # only counts where the whole box is in front of the camera
    consts = _consts(cfg, dev)
    cam_c = matvec3(r[:, None, None], consts.corners) + t[:, None, None]  # [S, C, 8, 3]
    z_c = cam_c[..., 2]
    zs_c = z_c.clamp(min=1e-6)
    u_c, v_c = k00 * cam_c[..., 0] / zs_c + k02, k11 * cam_c[..., 1] / zs_c + k12
    off_image = (z_c > 1e-3).all(-1) & (
        (u_c < -0.5).all(-1) | (u_c >= w - 0.5).all(-1) | (v_c < -0.5).all(-1) | (v_c >= h - 0.5).all(-1)
    )
    visible = ~((z_c < max(near, 1e-3)).all(-1) | (z_c > far).all(-1) | off_image)
    if not cull:
        visible = torch.ones_like(visible)

    scene_off = (torch.arange(ns, dtype=torch.int32, device=dev) * cfg.n_voxels)[:, None]
    vx, vy, vz = cfg.unlin_index(vol.pool_ids.reshape(ns, cfg.capacity) - scene_off)
    centers = (torch.stack([vx, vy, vz], dim=-1).float() + 0.5) * cfg.voxel_size + consts.origin
    cam = matvec3(r[:, None], centers) + t[:, None]  # [S, capacity, 3]
    z = cam[..., 2]
    zs = z.clamp(min=1e-6)
    ui = to_int32(torch.floor(k00 * cam[..., 0] / zs + k02 + 0.5))
    vi = to_int32(torch.floor(k11 * cam[..., 1] / zs + k12 + 0.5))
    cell_of, pos = consts.cell_of, consts.pos
    live = vol.cell_counts.reshape(ns, n_cells).clamp(max=cell_cap)
    valid = (
        (pos < live[:, cell_of]) & visible[:, cell_of] & (z > max(near, 1e-3)) & (z < far)
        & (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
    )
    pix = torch.where(valid, vi * w + ui, 0)
    zq = to_int32(torch.clamp(div_scalar(z - near, far - near) * 4095.0, 0, 4095))
    key64 = (zq.long() << _POOL_IDX_BITS) | (pos % chunk).long()
    key = torch.where(valid, key64 - 2**31, INT32_MAX).to(torch.int32)

    # sub-chunks: each cell's slots in runs of `chunk`, a short tail run padded
    n_sub = -(-cell_cap // chunk)
    pad = n_sub * chunk - cell_cap

    def rows(x, fill):
        x = F.pad(x.reshape(ns, n_cells, cell_cap), (0, pad), value=fill)
        return x.reshape(ns, n_cells * n_sub, chunk).transpose(0, 1).reshape(-1, chunk).contiguous()

    return rows(pix, 0), rows(key, INT32_MAX), z, consts.starts


def _render_depth_splat(vol, cfg, intrinsics, extrinsic, image_size, near, far, refine=True, cull=True):
    """Target-view z-depth by splatting the surface pool through the packed
    z-buffer (one `zbuffer_min` call over every sub-chunk of every scene),
    then sub-voxel refinement against the TSDF along each hit ray and two
    passes of 3x3 min hole filling. extrinsic [4, 4] -> [H, W], [S, 4, 4]
    -> [S, H, W] (one view a scene of a batched volume)."""
    h, w = image_size
    squeeze = extrinsic.dim() == 2
    if squeeze:
        extrinsic = extrinsic[None]
    ns = extrinsic.shape[0]
    dev = extrinsic.device
    if vol.cell_counts.shape[0] != ns * cfg.n_cells:
        raise ValueError(f"render: volume holds {volume_scenes(vol, cfg)} scene(s) but extrinsics batch {ns}")
    pix, key, z, starts = pool_splat_keys(vol, cfg, intrinsics, extrinsic, image_size, near, far, cull)
    wins = zbuffer_min(pix, key, h, w).reshape(len(starts), ns * h * w)
    # merge the sub-chunks' winners: the smallest key, the first sub-chunk on ties
    best, chunk_sel = wins[0], torch.zeros(ns * h * w, dtype=torch.int64, device=dev)
    for i in range(1, len(starts)):
        chunk_sel = torch.where(wins[i] < best, i, chunk_sel)
        best = torch.minimum(best, wins[i])
    has = (best != INT32_MAX).reshape(ns, h * w)
    slot = starts[chunk_sel] + (best & (MAX_POOL_CAPACITY - 1))
    idx = torch.where(has, slot.reshape(ns, h * w), 0)
    depth = torch.where(has, torch.gather(z, 1, idx), 0.0).reshape(ns, h, w)

    if refine:
        # the sub-voxel zero crossing: the pool voxel sits ~0.5 voxel in
        # front of the surface, so samples at {0, +0.5, +1} voxels bracket it
        cam_center, dirs_world = _camera_rays(intrinsics, extrinsic, h, w)
        dt = 0.5 * cfg.voxel_size
        ts = depth[..., None] + torch.arange(3, dtype=torch.float32, device=dev) * dt
        pts = cam_center[:, None, None, None, :] + dirs_world[:, :, :, None, :] * ts[..., None]
        scene_off = (torch.arange(ns, dtype=torch.int32, device=dev) * cfg.n_voxels).reshape(ns, 1, 1, 1)
        vals, obs = _sample_grid(vol, cfg, pts, "nearest", scene_off)
        prev_v, next_v = vals[..., :-1], vals[..., 1:]
        good = (prev_v > 0) & (next_v < 0) & obs[..., :-1] & obs[..., 1:]
        g0 = good[..., 0]
        hit = g0 | good[..., 1]
        pv = torch.where(g0, prev_v[..., 0], prev_v[..., 1])
        nv = torch.where(g0, next_v[..., 0], next_v[..., 1])
        frac = pv / torch.clamp(pv - nv, min=1e-12)
        t_ref = depth + (torch.where(g0, 0.0, 1.0) + frac) * dt
        depth = torch.where(hit & (depth > 0), t_ref, depth)
    depth = _fill_holes(depth)
    return depth[0] if squeeze else depth


def render_depth(vol, cfg, intrinsics, extrinsic, image_size, near: float, far: float,
                 refine: bool = True) -> torch.Tensor:
    """The map's z-depth at a target pose (0 = no surface), splatting the
    surface pool: [H, W] for extrinsic [4, 4], or [S, H, W] for a batched
    volume and extrinsics [S, 4, 4]. (The port's raycast renders no
    batched volume, so the reference has none.)"""
    return _render_depth_splat(vol, cfg, intrinsics, extrinsic, image_size, near, far, refine=refine)


# --------------------------------------------------------------------------
# export (host-side numpy)
# --------------------------------------------------------------------------