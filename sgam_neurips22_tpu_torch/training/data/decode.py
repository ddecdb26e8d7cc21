"""One example of a dataset, as the Loader decodes it on its threads or
in worker processes. This module imports numpy alone, so that a spawned
worker starts without torch."""
from __future__ import annotations

import numpy as np

_DATASET = None  # a worker process's dataset, set by `init_worker`


def get_example(dataset, i: int, rng: np.random.Generator) -> dict:
    """Example i, drawing from `rng` where the dataset draws at all."""
    try:
        return dataset.__getitem__(int(i), rng=rng)
    except TypeError:
        return dataset[int(i)]


def init_worker(dataset) -> None:
    global _DATASET
    _DATASET = dataset


def worker_example(i: int, rng: np.random.Generator) -> dict:
    return get_example(_DATASET, i, rng)
