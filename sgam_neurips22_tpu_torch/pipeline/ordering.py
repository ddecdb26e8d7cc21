"""Visit orders over the pose grid — numpy copy of
`sgam_neurips22_tpu/pipeline/ordering.py`."""
from __future__ import annotations

from typing import List, Tuple

Coord = Tuple[int, int]


def zig_zag_order(rows: int, cols: int) -> List[Coord]:
    """Anti-diagonal zig-zag (the default)."""
    diagonals: List[List[Coord]] = [[] for _ in range(rows + cols - 1)]
    for i in range(rows):
        for j in range(cols):
            s = i + j
            if s % 2 == 0:
                diagonals[s].insert(0, (i, j))
            else:
                diagonals[s].append((i, j))
    return [c for d in diagonals for c in d]


def row_major_order(rows: int, cols: int) -> List[Coord]:
    """Boustrophedon rows."""
    return [(i, j if i % 2 == 0 else cols - j - 1) for i in range(rows) for j in range(cols)]


def column_major_order(rows: int, cols: int) -> List[Coord]:
    """Boustrophedon columns."""
    return [(i if j % 2 == 0 else rows - i - 1, j) for j in range(cols) for i in range(rows)]


ORDERS = {
    "zigzag": zig_zag_order,
    "row_major": row_major_order,
    "column_major": column_major_order,
}
