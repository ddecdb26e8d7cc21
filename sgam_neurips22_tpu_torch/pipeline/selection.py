"""Source-view selection for each generation step — numpy copy of
`sgam_neurips22_tpu/pipeline/selection.py`: every visited pose within a
per-dataset radius of the target (1.0 CLEVR, 0.3 otherwise), nearest first,
at most num_src; a pose-file trajectory takes the num_src frames before the
target instead."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from sgam_neurips22_tpu_torch.pipeline.trajectory import PoseGrid

RADIUS = {"clevr-infinite": 1.0}
DEFAULT_RADIUS = 0.3


def source_radius(dataset: str) -> float:
    return RADIUS.get(dataset, DEFAULT_RADIUS)


def select_sources(
    grid: PoseGrid,
    visit_order: Sequence[Tuple[int, int]],
    curr: int,
    tgt_coord: Tuple[int, int],
    num_src: int,
    dataset: str,
) -> List[Tuple[int, int]]:
    """Coordinates of the source views for the `curr`-th generation step.
    On a pose-file trajectory these are the num_src previous rows, as the
    reference takes them: near the start some rows are negative, and
    index the trajectory from its end, as numpy and torch indexing do."""
    if grid.trajectory_shape == "trajectory":
        return [(tgt_coord[0] - i - 1, 0) for i in range(num_src)]
    tgt_pos = grid.position[grid.index(*tgt_coord)]
    radius = source_radius(dataset)
    cands = []
    for i in range(curr):
        coord = visit_order[i]
        idx = grid.index(*coord)
        if not grid.visited[idx]:
            continue
        dist = float(np.linalg.norm(grid.position[idx] - tgt_pos))
        if dist <= radius:
            cands.append((coord, dist))
    cands.sort(key=lambda x: x[1])
    return [c for c, _ in cands[:num_src]]
