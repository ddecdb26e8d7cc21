"""Pose-graph pair datasets for conditional-generation training — port of
`sgam_neurips22_tpu/training/data/pair_dataset.py` (the reference's
data/clevr-infinite.py and data/google_earth.py): a scene's
transforms.json becomes a pose graph (frames as nodes, an edge between two
frames within the dataset's radius), pickle-cached under
`<dataset_dir>/cache/`; an example is a target frame and n_src graph
neighbours (drawn from the example's own numpy Generator in training, a
seeded shuffle in validation), their RGB-D, the relative transforms, and
zero padding and masks where fewer sources exist.

The graph cache is written and read by this program alone (it is
unpickled): the port's files are named apart from the JAX package's.
"""
from __future__ import annotations

import json
import os
import pickle
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from sgam_neurips22_tpu_torch.training.data.io import load_depth, load_rgb, ray_to_z_np

GL2CV = np.array([[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1.0]])


class PoseGraph:
    """Minimal adjacency structure (replaces networkx for speed; pickle-cached
    like the reference, data/clevr-infinite.py:47-49)."""

    def __init__(self):
        self.nodes: Dict[int, dict] = {}
        self.adj: Dict[int, List[int]] = {}

    def add_node(self, key: int, attrs: dict) -> None:
        self.nodes[key] = attrs
        self.adj.setdefault(key, [])

    def add_edge(self, i: int, j: int) -> None:
        self.adj[i].append(j)
        self.adj[j].append(i)

    def remove_node(self, key: int) -> None:
        for other in self.adj.pop(key, []):
            self.adj[other].remove(key)
        self.nodes.pop(key, None)

    def neighbors(self, key: int) -> List[int]:
        return sorted(self.adj[key])

    def __len__(self) -> int:
        return len(self.nodes)


def _build_graph(
    frames: list,
    scene_dir: Path,
    edge_radius: float,
    rotation_variants: Optional[int] = None,
    require_valid: bool = False,
    drop_isolated: bool = False,
) -> PoseGraph:
    g = PoseGraph()
    for i, fr in enumerate(frames):
        if require_valid and not fr.get("is_valid", True):
            continue
        c2w = np.asarray(fr["transform_matrix"]) @ GL2CV
        w2c = np.linalg.inv(c2w)
        key = int(fr["file_path"][-9:-4]) if rotation_variants else i
        g.add_node(
            key,
            {
                "frame_id": key,
                "R": w2c[:3, :3],
                "t": w2c[:3, 3],
                "position": c2w[:3, 3],
                "rgb_path": str(scene_dir / f"im_{key:05d}.png"),
                "depth_path": str(scene_dir / f"dm_{key:05d}.npy"),
            },
        )
    keys = sorted(g.nodes)
    pos = np.stack([g.nodes[k]["position"] for k in keys]) if keys else np.zeros((0, 3))
    for a in range(len(keys)):
        d = np.linalg.norm(pos[a + 1 :] - pos[a], axis=1)
        for off in np.nonzero(d <= edge_radius)[0]:
            b = a + 1 + int(off)
            if rotation_variants and keys[a] % rotation_variants != keys[b] % rotation_variants:
                continue  # reference google_earth.py:92 matches rotation variant
            g.add_edge(keys[a], keys[b])
    if drop_isolated:
        for k in list(g.nodes):
            if not g.adj[k]:
                g.remove_node(k)  # reference google_earth.py:98-100
    return g


class PairDatasetBase:
    """Common target+neighbors sampling (reference clevr-infinite.py:81-172)."""

    dataset: str = ""
    edge_radius: float = 3.0
    rotation_variants: Optional[int] = None
    require_valid: bool = False
    drop_isolated: bool = False
    depth_is_ray: bool = False
    depth_sentinel: Optional[float] = None  # e.g. 65504 -> -99999 (GE)

    def __init__(
        self,
        split: str,
        dataset_dir: str,
        n_src: int = 2,
        image_resolution=(256, 256),
        use_cache: bool = True,
        frame_store=None,
    ):
        self.split = split
        self.dataset_dir = dataset_dir
        self.n_src = n_src
        self.image_resolution = tuple(image_resolution)
        # optional packed frame store (training/data/packed.PackedFrameStore):
        # RGB decode + resize + ray->z were done once at pack time; frames
        # gather through C++ threads instead of per-file PNG decode
        self.frame_store = None
        if frame_store is not None:
            if (frame_store.height, frame_store.width) != self.image_resolution:
                raise ValueError(
                    f"frame store is {frame_store.height}x{frame_store.width}, "
                    f"dataset wants {self.image_resolution}"
                )
            self.frame_store = frame_store
        self.K = np.load(os.path.join(dataset_dir, "K.npy")).astype(np.float64)
        if self.dataset == "google_earth":
            # K stored at 512 (reference google_earth.py:50-51)
            self.K[0] *= self.image_resolution[1] / 512
            self.K[1] *= self.image_resolution[0] / 512
        self.graphs: List[PoseGraph] = []
        self.cumsum = [0]
        cache_dir = Path(dataset_dir) / "cache"
        os.makedirs(cache_dir, exist_ok=True)
        for scene_dir in sorted(Path(dataset_dir, split).glob("*")):
            if not (scene_dir / "transforms.json").exists():
                continue
            # a name of its own: the JAX package's cache beside it pickles its own PoseGraph class
            cache = cache_dir / f"{scene_dir.name}_graph_{split}.torch.pkl"
            if use_cache and cache.exists():
                with open(cache, "rb") as f:
                    g = pickle.load(f)
            else:
                with open(scene_dir / "transforms.json") as f:
                    frames = json.load(f)["frames"]
                g = _build_graph(
                    frames, scene_dir, self.edge_radius,
                    self.rotation_variants, self.require_valid, self.drop_isolated,
                )
                if use_cache:
                    with open(cache, "wb") as f:
                        pickle.dump(g, f)
            self.graphs.append(g)
            self.cumsum.append(len(g) + self.cumsum[-1])

    def __len__(self) -> int:
        return self.cumsum[-1]

    def _locate(self, idx: int):
        for gi in range(len(self.graphs)):
            if idx < self.cumsum[gi + 1]:
                rel = idx - self.cumsum[gi]
                return gi, sorted(self.graphs[gi].nodes)[rel]
        raise IndexError(idx)

    def _load_depth(self, path: str, is_dst: bool = False) -> np.ndarray:
        d = load_depth(path, self.image_resolution)
        if self.depth_sentinel is not None and not is_dst:
            # the reference replaces the 65504 sentinel in SOURCE depths only
            # (google_earth.py:174-183); the target keeps it, and
            # tgt_pixel_mask marks those pixels instead
            d[d == self.depth_sentinel] = -99999.0
        if self.depth_is_ray:
            d = ray_to_z_np(d, self.K)
        return d.astype(np.float32)

    def _extras(self, tgt, srcs, dm_dst) -> dict:
        """Dataset-specific extra batch keys (reference google_earth.py:196-209)."""
        return {}

    def _load_frames(self, tgt: dict, srcs: list):
        """(dst rgb, dst depth, src rgbs, src depths) — via the packed frame
        store when every frame is in it, else per-file decode."""
        store = self.frame_store
        if store is not None:
            paths = [tgt["rgb_path"], *[s["rgb_path"] for s in srcs]]
            ids = [store.record_id(p) for p in paths]
            if all(i is not None for i in ids):
                rgb, depth = store.gather(ids)
                dm_srcs = []
                for d in depth[1:]:
                    if self.depth_sentinel is not None:
                        # source depths get the sentinel replaced; the target
                        # keeps it (reference google_earth.py:174-183)
                        d[d == self.depth_sentinel] = -99999.0
                    dm_srcs.append(d)
                return rgb[0], depth[0], list(rgb[1:]), dm_srcs
        img_dst = load_rgb(tgt["rgb_path"], self.image_resolution)
        dm_dst = self._load_depth(tgt["depth_path"], is_dst=True)
        img_srcs = [load_rgb(s["rgb_path"], self.image_resolution) for s in srcs]
        dm_srcs = [self._load_depth(s["depth_path"]) for s in srcs]
        return img_dst, dm_dst, img_srcs, dm_srcs

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None) -> dict:
        gi, key = self._locate(idx)
        g = self.graphs[gi]
        tgt = g.nodes[key]
        neighbors = g.neighbors(key)
        if self.split == "train":
            rng = rng or np.random.default_rng()
            picks = rng.choice(len(neighbors), self.n_src) if neighbors else []
            src_keys = [neighbors[int(p)] for p in picks]
        else:
            # deterministic per-example shuffle (reference :89-93)
            state = np.random.RandomState(seed=idx)
            arr = np.array(neighbors)
            state.shuffle(arr)
            src_keys = [int(k) for k in arr[: self.n_src]]
        srcs = [g.nodes[k] for k in src_keys]

        img_dst, dm_dst, img_srcs, dm_srcs = self._load_frames(tgt, srcs)

        t_tgt = np.eye(4)
        t_tgt[:3, :3] = tgt["R"]
        t_tgt[:3, 3] = tgt["t"]
        r_rels, t_rels, ks = [], [], []
        for s in srcs:
            t_src = np.eye(4)
            t_src[:3, :3] = s["R"]
            t_src[:3, 3] = s["t"]
            t_rel = t_tgt @ np.linalg.inv(t_src)  # reference :129
            r_rels.append(t_rel[:3, :3])
            t_rels.append(t_rel[:3, 3])
            ks.append(self._scaled_k(img_dst.shape[:2]))

        mask = np.zeros(self.n_src, np.float32)
        mask[: len(srcs)] = 1.0
        while len(ks) < self.n_src:  # zero-pad (reference :149-155)
            ks.append(np.eye(3))
            r_rels.append(np.eye(3))
            t_rels.append(np.zeros(3))
            img_srcs.append(np.zeros_like(img_dst))
            dm_srcs.append(np.zeros_like(dm_dst))

        out = {
            "Ks": np.stack(ks),
            "R_rels": np.stack(r_rels),
            "t_rels": np.stack(t_rels),
            "dst_img": img_dst,
            "src_imgs": np.stack(img_srcs),
            "dst_depth": dm_dst,
            "src_depths": np.stack(dm_srcs),
            "src_masks": mask,
        }
        out.update(self._extras(tgt, srcs, dm_dst))
        return {k: v.astype(np.float32) for k, v in out.items()}

    def _scaled_k(self, hw) -> np.ndarray:
        return self.K


class ClevrInfinitePairs(PairDatasetBase):
    """CLEVR-Infinite (reference data/clevr-infinite.py): edge radius 3,
    ray depths on disk."""

    dataset = "clevr-infinite"
    edge_radius = 3.0
    depth_is_ray = True

    def _scaled_k(self, hw) -> np.ndarray:
        h, w = hw
        # reference :119-122 rescales K by resolution/full-res
        k = self.K * self.image_resolution[1] / w
        k = k * self.image_resolution[0] / h
        k[2, 2] = 1.0
        return k


class GoogleEarthPairs(PairDatasetBase):
    """GoogleEarth-Infinite (reference data/google_earth.py): validity filter,
    frame_id%4 rotation-variant edges within 0.3, isolated nodes dropped,
    65504 depth sentinel."""

    dataset = "google_earth"
    edge_radius = 0.3
    rotation_variants = 4
    require_valid = True
    drop_isolated = True
    depth_sentinel = 65504.0

    def _extras(self, tgt, srcs, dm_dst) -> dict:
        # reference google_earth.py:196-209: frame ids (-1 padding) and the
        # target validity mask over the UNREPLACED sentinel
        ids = [s["frame_id"] for s in srcs] + [-1] * (self.n_src - len(srcs))
        return {
            "tgt_frame_id": np.array([tgt["frame_id"]], np.float32),
            "src_frame_ids": np.asarray(ids, np.float32),
            "tgt_pixel_mask": (dm_dst != self.depth_sentinel)[None].astype(np.float32),
        }
