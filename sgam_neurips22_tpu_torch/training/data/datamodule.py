"""Data module: phase-switched datasets and the batching loader — port of
`sgam_neurips22_tpu/training/data/datamodule.py` (the reference's
data/utils/utils.py `DataModuleFromConfig`): 'conditional_generation'
wires the pose-graph pair datasets, 'codebook' the file-list RGB-D
datasets; the test split is the validation split.

The loader assembles batches in a background thread, `prefetch` ahead of
the consumer, and decodes a batch's examples on a thread pool, as the JAX
loader does (the PNG reader and numpy release the interpreter lock), or,
with `processes`, on spawned worker processes, as the reference's
DataLoader does with `num_workers` > 0: the decode's own Python then does
not hold this process's interpreter lock, which the train step's launches
wait for. Each example draws from its own numpy Generator, spawned from
the epoch's and handed to the thread or process that decodes it, so the
batches equal the JAX loader's bit for bit at the same seed, whatever the
workers' order. `device_put` moves each batch to the device:
`to_device` copies it from pinned host memory without blocking.

With `process_count` > 1 (data-parallel ranks, `parallel.distributed`)
`batch_size` is the global batch: every rank walks the same epoch-seeded
order, spawns the same per-position streams of the whole batch, and
decodes only its `process_index`-th slice of it, as the JAX loader does
(the DistributedSampler discipline), on threads, worker processes and the
packed paths alike.
"""
from __future__ import annotations

import multiprocessing
import os
import queue
import threading
from concurrent.futures import Executor, ProcessPoolExecutor, ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from sgam_neurips22_tpu_torch.core.registry import register
from sgam_neurips22_tpu_torch.training.data.codebook_dataset import CodebookDataset
from sgam_neurips22_tpu_torch.training.data.decode import get_example, init_worker, worker_example
from sgam_neurips22_tpu_torch.training.data.pair_dataset import ClevrInfinitePairs, GoogleEarthPairs

PAIR_DATASETS = {"clevr-infinite": ClevrInfinitePairs, "google_earth": GoogleEarthPairs}


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays as tensors on `device`: on CUDA each array is
    pinned, then copied with non_blocking=True."""
    if device.type != "cuda":
        return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    return {k: torch.from_numpy(v).pin_memory().to(device, non_blocking=True) for k, v in batch.items()}


class Loader:
    """Shuffling batcher with background prefetch and parallel example
    decode, on `workers` threads or, with `processes`, `workers` spawned
    processes (each receives the dataset once, so it must pickle); the last
    partial batch is dropped (the reference's drop_last=True). With
    `process_count` > 1 it yields this rank's rows of each global batch of
    `batch_size`, which must divide by the ranks."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        prefetch: int = 2,
        workers: int = 8,
        device_put: Optional[Callable[[Dict[str, np.ndarray]], Any]] = None,
        processes: bool = False,
        process_count: int = 1,
        process_index: int = 0,
    ):
        if batch_size % process_count:
            raise ValueError(f"batch_size {batch_size} not divisible by {process_count} processes")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.workers = max(1, workers)
        self.device_put = device_put
        self.processes = processes
        self.process_count = process_count
        self.process_index = process_index
        self._epoch = 0

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        return idx

    def _local(self, n: int) -> slice:
        """This rank's rows of a global batch of n (all of it in one process)."""
        per = n // self.process_count
        return slice(self.process_index * per, (self.process_index + 1) * per)

    def _assemble(self, idxs, rng: np.random.Generator, pool: Optional[Executor]) -> Dict[str, np.ndarray]:
        sl = self._local(len(idxs))
        if hasattr(self.dataset, "assemble_batch"):
            # a packed shard: one native call builds the whole batch
            return self.dataset.assemble_batch(idxs[sl])
        # each global position's stream, spawned before slicing: a rank
        # decodes example i with the stream one process would
        rngs = rng.spawn(len(idxs))[sl]
        idxs = idxs[sl]
        if pool is None:
            examples = [get_example(self.dataset, i, r) for i, r in zip(idxs, rngs)]
        elif self.processes:
            examples = list(pool.map(worker_example, [int(i) for i in idxs], rngs))
        else:
            examples = list(pool.map(lambda i, r: get_example(self.dataset, i, r), idxs, rngs))
        return {k: np.stack([e[k] for e in examples]) for k in examples[0]}

    def _pool(self) -> Optional[Executor]:
        if hasattr(self.dataset, "assemble_batch"):
            return None
        if self.processes:
            # spawned, not forked: this process holds CUDA state and threads
            return ProcessPoolExecutor(self.workers, mp_context=multiprocessing.get_context("spawn"),
                                       initializer=init_worker, initargs=(self.dataset,))
        return ThreadPoolExecutor(self.workers, thread_name_prefix="loader") if self.workers > 1 else None

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        idx = self._indices()
        self._epoch += 1
        rng = np.random.default_rng(self.seed + 1000 + self._epoch)
        n = len(self)
        if n == 0:
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()
        cancelled = threading.Event()
        pool = self._pool()

        def put_or_cancel(item) -> bool:
            # never block forever on a consumer that went away (an early
            # break out of the epoch): poll the cancel flag
            while not cancelled.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for b in range(n):
                    if cancelled.is_set():
                        return
                    batch = self._assemble(idx[b * self.batch_size: (b + 1) * self.batch_size], rng, pool)
                    if self.device_put is not None:
                        batch = self.device_put(batch)
                    if not put_or_cancel(batch):
                        return
                put_or_cancel(stop)
            except BaseException as e:  # handed to the consumer, which raises it
                if not cancelled.is_set():
                    put_or_cancel(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            cancelled.set()
            try:  # unblock a producer waiting to put, and drop its batches
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=30.0)
            if pool is not None:
                pool.shutdown(wait=True, cancel_futures=True)


@register("sgam_neurips22_tpu.DataModule", "data.utils.utils.DataModuleFromConfig")
class DataModule:
    """Phase-switched dataset wiring (the reference's
    DataModuleFromConfig). `packed`: True needs the packed shard (or frame
    store), 'auto' uses it where it exists and loads, False never does.
    `num_workers`: 0 decodes on 8 threads of this process; N > 0 on N
    worker processes, as the reference's DataLoader (datasets with a
    packed frame store or shard keep this process: they gather in C++)."""

    def __init__(
        self,
        batch_size: int,
        dataset: str,
        phase: str,
        dataset_dir: str,
        image_resolution=(256, 256),
        n_src: int = 2,
        num_workers: int = 0,
        depth_range=None,
        use_depth: bool = True,
        seed: int = 0,
        device_put=None,
        packed: str | bool = "auto",
        process_count: int = 1,
        process_index: int = 0,
        **_: Any,
    ):
        self.batch_size = batch_size
        self.seed = seed
        self.device_put = device_put
        self.num_workers = int(num_workers)
        self.process_count, self.process_index = process_count, process_index
        if phase == "conditional_generation":
            cls = PAIR_DATASETS[dataset]
            self.train_ds = cls("train", dataset_dir, n_src, image_resolution,
                                frame_store=self._frame_store("train", dataset_dir, image_resolution, packed))
            self.val_ds = cls("val", dataset_dir, n_src, image_resolution,
                              frame_store=self._frame_store("val", dataset_dir, image_resolution, packed))
        elif phase == "codebook":
            self.train_ds = self._codebook_ds("train", dataset_dir, dataset, image_resolution, use_depth, packed)
            self.val_ds = self._codebook_ds("val", dataset_dir, dataset, image_resolution, use_depth, packed)
        else:
            raise NotImplementedError(phase)
        self.test_ds = self.val_ds

    @staticmethod
    def _frame_store(split, dataset_dir, image_resolution, packed):
        from sgam_neurips22_tpu_torch.training.data.packed import PackedFrameStore, frame_store_path

        if not packed:
            return None
        path = frame_store_path(dataset_dir, split, image_resolution)
        if os.path.exists(path):
            try:
                return PackedFrameStore(path)
            except Exception as e:
                # 'auto' falls back on any failure of the packed path: no
                # compiler, a stale library, a truncated sidecar
                if packed is True:
                    raise
                print(f"packed frame store unusable ({e}); falling back to PNGs")
        elif packed is True:
            raise FileNotFoundError(f"packed=True but no frame store at {path}")
        return None

    @staticmethod
    def _codebook_ds(split, dataset_dir, dataset, image_resolution, use_depth, packed):
        from sgam_neurips22_tpu_torch.training.data.packed import PackedCodebookDataset, shard_path

        if packed:
            path = shard_path(dataset_dir, split, image_resolution)
            if os.path.exists(path):
                try:
                    ds = PackedCodebookDataset(path)
                    want = 4 if use_depth else 3
                    if ds.channels != want:
                        ds.close()
                        raise OSError(f"shard has {ds.channels} channels, config wants {want}")
                    return ds
                except Exception as e:
                    if packed is True:
                        raise
                    print(f"packed shard unusable ({e}); falling back to PNGs")
            elif packed is True:
                raise FileNotFoundError(f"packed=True but no shard at {path}")
        return CodebookDataset(split, dataset_dir, dataset, image_resolution, use_depth=use_depth)

    def _loader(self, ds, shuffle: bool = False) -> Loader:
        # validation and test keep seed 0: their order is sequential, the
        # epoch generator drives only the training split's source sampling
        processes = self.num_workers > 0 and getattr(ds, "frame_store", None) is None
        return Loader(ds, self.batch_size, shuffle=shuffle, seed=self.seed if shuffle else 0,
                      device_put=self.device_put, workers=self.num_workers if processes else 8, processes=processes,
                      process_count=self.process_count, process_index=self.process_index)

    def train_loader(self) -> Loader:
        return self._loader(self.train_ds, shuffle=True)

    def val_loader(self) -> Loader:
        return self._loader(self.val_ds)

    def test_loader(self) -> Loader:
        return self._loader(self.test_ds)
