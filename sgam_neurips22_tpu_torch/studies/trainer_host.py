"""The trainer's host side on one card, shared by chip_smoke.py's trainer
phases and `studies/trainer_loader.py`: a seeded CLEVR-Infinite-style
dataset on disk, and what Trainer.fit's loop costs over train_step alone
and where its host time goes.
"""
from __future__ import annotations

import json
import struct
import threading
import time
import zlib
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch


def write_png_paeth(path: str, img: np.ndarray) -> None:
    """An 8-bit RGB PNG whose every row carries the Paeth filter, as
    Pillow's and Blender's encoders often choose it."""
    x = img.astype(np.int16)
    h, w, c = x.shape
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    cc = np.zeros_like(x)
    cc[1:, 1:] = x[:-1, :-1]
    p = a + b - cc
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
    rows = ((x - pred) % 256).astype(np.uint8).reshape(h, w * c)
    raw = np.concatenate([np.full((h, 1), 4, np.uint8), rows], axis=1).tobytes()

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_train_dataset(root: Path, h: int, w: int, seed: int, scenes: int = 8, frames: int = 18,
                        paeth_every: int = 2) -> dict:
    """A CLEVR-Infinite-style dataset at h x w from `seed`: a train split of
    `scenes` scenes and a val split of one, each of `frames` frames along a
    line 0.5 apart (so each frame has graph neighbours within the radius
    of 3), each an RGB PNG (a smooth pattern with noise; every
    `paeth_every`-th Paeth-filtered, the others unfiltered) and a ray
    depth .npy, U(8, 14); transforms.json, K.npy, train.txt / val.txt, and
    the codebook phase's packed shards. Returns the PNG paths by filter."""
    from sgam_neurips22_tpu_torch.pipeline.png import read_png, write_png
    from sgam_neurips22_tpu_torch.training.data.codebook_dataset import CodebookDataset
    from sgam_neurips22_tpu_torch.training.data.io import load_rgb_u8
    from sgam_neurips22_tpu_torch.training.data.packed import shard_path, write_shard

    rng = np.random.default_rng(seed)
    np.save(root / "K.npy", np.array([[355.5555 * w / 256, 0, w / 2], [0, 355.5555 * h / 256, h / 2], [0, 0, 1.0]]))
    yy, xx = np.mgrid[0:h, 0:w]
    by_filter: dict = {"none": [], "paeth": []}
    for split, n_scenes in (("train", scenes), ("val", 1)):
        paths = []
        for s in range(n_scenes):
            scene = root / split / f"scene_{s:04d}"
            scene.mkdir(parents=True)
            poses = []
            for i in range(frames):
                c2w = np.eye(4)
                c2w[:3, 3] = [0.5 * i, 0.1 * s, 0.0]
                poses.append({"transform_matrix": c2w.tolist(), "file_path": f"./im_{i:05d}.png"})
                img = (np.stack([xx * (1 + s), yy * 2, xx + yy + 8 * i], -1) + rng.integers(0, 16, (h, w, 3))) % 256
                path = str(scene / f"im_{i:05d}.png")
                paeth = i % paeth_every == 0
                (write_png_paeth(path, img) if paeth else write_png(path, img.astype(np.uint8)))
                if not np.array_equal(read_png(path), img):
                    raise AssertionError(f"{path}: the PNG does not read back")
                np.save(scene / f"dm_{i:05d}.npy", rng.uniform(8, 14, (h, w)).astype(np.float32))
                by_filter["paeth" if paeth else "none"].append(path)
                paths.append(path)
            with open(scene / "transforms.json", "w") as f:
                json.dump({"frames": poses}, f)
        (root / f"{split}.txt").write_text("\n".join(paths))
        ds = CodebookDataset(split, str(root), "clevr-infinite", (h, w))
        write_shard(shard_path(str(root), split, (h, w)), [load_rgb_u8(p, (h, w)) for p in ds.paths],
                    [ds[i]["image"][..., 3] for i in range(len(ds))])
    return by_filter


def _thread_group(t: threading.Thread) -> str:
    if t is threading.main_thread():
        return "main"
    if t.name.startswith("loader"):  # the Loader's decode pool
        return "loader_decode"
    return "loader_producer" if "produce" in t.name else "other"


def _thread_cpu() -> dict:
    """CPU seconds so far of each live thread (keyed by its Thread: an
    ident can pass to a later thread)."""
    out = {}
    for t in threading.enumerate():
        try:
            out[t] = time.clock_gettime(time.pthread_getcpuclockid(t.ident))
        except (OSError, TypeError):  # the thread ended meanwhile
            pass
    return out


def _cpu_by_group(before: dict, after: dict) -> dict:
    """CPU seconds by thread group between two `_thread_cpu` readings, over
    the threads alive at both."""
    out: dict = {}
    for t, t1 in after.items():
        if t in before:
            out[_thread_group(t)] = out.get(_thread_group(t), 0.0) + t1 - before[t]
    return out


def fit_timing(trainer, counters, steps: int = 5, profile: Optional[Callable] = None) -> dict:
    """ms/step of `steps` steps through Trainer.fit (after one untimed step;
    image logging off, as past the early image steps) against train_step
    alone on the same batches, on the card. Each is timed from one
    synchronize before its first step to one after its last, so the host
    runs ahead of the device as in training. Beside them, over the fit
    window: where the main thread's time went a step (waiting for the
    loader's batch, inside train_step's call, the final synchronize, the
    rest of the loop), the CPU time a step of the process and of each group
    of threads (main, the loader's decode pool and its producer), the
    device's time from each step's start to the next (CUDA events), and
    the launches a step. `profile(fn, timed_s)`, where given, profiles one
    more train_step (`utils.trace_events.profile_unroll`) for the device's busy
    time and idle shares."""
    from sgam_neurips22_tpu_torch.training import trainer as trainer_mod
    from sgam_neurips22_tpu_torch.training.train_step import train_step
    from sgam_neurips22_tpu_torch.utils.logging import MetricLogger

    start = trainer.state.step
    batches, events, waits = [], [], {}
    fit = {"host_step_s": 0.0}

    def timed_step(state, batch, *args):
        i = state.step - start  # 0: the untimed step; 1..steps timed; steps + 1 ends the window
        if i == 1:
            torch.cuda.synchronize()
            for fn in counters:
                fn.launches = 0
            fit.update(t0=time.perf_counter(), cpu0=time.process_time(), threads0=_thread_cpu())
        elif i == steps + 1:
            t = time.perf_counter()
            torch.cuda.synchronize()
            fit.update(t1=time.perf_counter(), sync_s=time.perf_counter() - t, cpu1=time.process_time(),
                       threads1=_thread_cpu(), launches={fn.__name__: fn.launches for fn in counters})
        if 1 <= i <= steps + 1:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        if 1 <= i <= steps:
            batches.append(batch)
            t = time.perf_counter()
            out = train_step(state, batch, *args)
            fit["host_step_s"] += time.perf_counter() - t
            return out
        return train_step(state, batch, *args)

    loader = trainer.data.train_loader

    def timed_loader():
        it = iter(loader())
        try:
            while True:
                t = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                waits[trainer.state.step - start] = time.perf_counter() - t
                yield batch
        finally:
            it.close()

    trainer.metrics = MetricLogger(trainer.logdir, use_wandb=False)  # the CLI closed the run's logger
    trainer.images.early, trainer.images.every = set(), 10 ** 9
    trainer.max_steps = start + steps + 1
    trainer_mod.train_step = timed_step
    trainer.data.train_loader = timed_loader
    try:
        trainer.fit(epochs=10)
    finally:
        trainer_mod.train_step = train_step
        del trainer.data.train_loader
    window_s = fit["t1"] - fit["t0"]
    wait_s = sum(s for i, s in waits.items() if 2 <= i <= steps + 1)  # the batches fetched inside the window
    per = 1e3 / steps

    torch.cuda.synchronize()
    alone_events, alone_host_s = [torch.cuda.Event(enable_timing=True)], 0.0
    t0, cpu0 = time.perf_counter(), time.process_time()
    alone_events[0].record()
    for b in batches:
        t = time.perf_counter()
        train_step(trainer.state, b, trainer.lpips, trainer._step_cfg(trainer.state.step))
        alone_host_s += time.perf_counter() - t
        alone_events.append(torch.cuda.Event(enable_timing=True))
        alone_events[-1].record()
    torch.cuda.synchronize()
    alone_s, alone_cpu_s = time.perf_counter() - t0, time.process_time() - cpu0
    rep = {
        "timed_steps": steps,
        "fit_ms_per_step": window_s * per, "train_step_ms_per_step": alone_s * per,
        "fit_overhead_share": window_s / alone_s - 1,
        "fit_main_thread_ms_per_step": {
            "loader_wait": wait_s * per, "train_step_call": fit["host_step_s"] * per,
            "final_sync": fit["sync_s"] * per,
            "rest_of_loop": (window_s - wait_s - fit["host_step_s"] - fit["sync_s"]) * per},
        "train_step_alone_call_ms_per_step": alone_host_s * per,
        "process_cpu_ms_per_step": {"fit": (fit["cpu1"] - fit["cpu0"]) * per, "train_step_alone": alone_cpu_s * per},
        "fit_thread_cpu_ms_per_step": {k: v * per for k, v in
                                       sorted(_cpu_by_group(fit["threads0"], fit["threads1"]).items())},
        "fit_device_step_ms": [a.elapsed_time(b) for a, b in zip(events, events[1:])],
        "train_step_device_step_ms": [a.elapsed_time(b) for a, b in zip(alone_events, alone_events[1:])],
        "launches_per_step": {k: v / steps for k, v in fit["launches"].items()},
    }
    if profile is not None:
        prof = profile(lambda: train_step(trainer.state, batches[0], trainer.lpips, trainer.train_cfg), alone_s / steps)
        busy = prof["device_busy_ms_per_frame"]
        rep.update({"device_busy_ms_per_step": busy, "device_kernel_ms_per_step": prof["device_kernel_ms_per_frame"],
                    "profile_lost_launches": prof["lost_launches"],
                    "device_idle_share_fit": None if busy is None else 1 - busy / rep["fit_ms_per_step"],
                    "device_idle_share_train_step": None if busy is None else 1 - busy / rep["train_step_ms_per_step"],
                    "profiled_step_wall_ms": prof["profiled_wall_s"] * 1e3,
                    "ms_per_step_by_layer": prof["ms_per_frame_by_layer"]})
    return rep
