"""The data mesh — the port's counterpart of `sgam_neurips22_tpu/parallel/mesh.py`.

JAX's mesh is a 1-D array of devices with a `data` axis: parameters
replicated, the batch axis sharded. Here each rank is one process on one
device, so a mesh is this rank's view of that axis: its size (the number
of ranks), this rank's place on it, its device and the process group the
collectives run over. The four placement helpers keep JAX's names for the
one rank's view: `batch_sharding` / `shard_batch` take this rank's rows of
a global batch, `replicated` / `replicate` put a value as it is on the
rank's device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from sgam_neurips22_tpu_torch.parallel import distributed


@dataclass(frozen=True)
class Mesh:
    size: int  # ranks on the data axis
    rank: int  # this rank's index on it
    device: torch.device
    group: Optional[Any] = None  # the process group; None in a plain process

    @property
    def shape(self) -> dict:
        return {"data": self.size}


def make_mesh(n_devices: Optional[int] = None, device: str | torch.device = "cuda") -> Mesh:
    """The data mesh of this process. Under a process group it spans every
    rank (JAX's rule: a multi-process mesh must hold every process's
    devices), so an `n_devices` other than the world size raises; in a
    plain process it is this one device, and `n_devices` > 1 raises: a
    process drives one device, and several are ranks of their own
    (`distributed.launch`, or the train CLI's --n_devices)."""
    from sgam_neurips22_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    group = distributed.data_group()
    if group is None:
        if n_devices not in (None, 1):
            raise ValueError(f"n_devices={n_devices} in a single process: each device is a rank of its own; "
                             "start them with distributed.launch (the train CLI: --n_devices)")
        return Mesh(1, 0, dev, None)
    world = distributed.process_count()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices} on a {world}-rank process group: the mesh must span every rank "
                         "(omit n_devices)")
    return Mesh(world, distributed.process_index(), dev, group)


class Sharding:
    """One rank's placement of a value: its rows of the leading (batch)
    axis, or the whole value."""

    def __init__(self, mesh: Mesh, rows: bool):
        self.mesh, self.rows = mesh, rows

    def local(self, x: Any) -> torch.Tensor:
        t = torch.as_tensor(x)
        if self.rows:
            n = t.shape[0]
            if n % self.mesh.size:
                raise ValueError(f"a batch of {n} rows does not shard over {self.mesh.size} ranks")
            per = n // self.mesh.size
            t = t[self.mesh.rank * per: (self.mesh.rank + 1) * per]
        return t.to(self.mesh.device)


def batch_sharding(mesh: Mesh) -> Sharding:
    """Shard the leading (batch) dimension over the ranks."""
    return Sharding(mesh, rows=True)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, rows=False)


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's rows of every leaf of a global batch, on its device."""
    return distributed._tree_map(batch_sharding(mesh).local, batch)


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Every leaf on this rank's device, as it is (every rank passes the
    same values; `distributed.replicate_global` broadcasts rank 0's)."""
    return distributed._tree_map(replicated(mesh).local, tree)


def local_batch_multiple(mesh: Mesh) -> int:
    """The global batch size must be a multiple of this."""
    return mesh.size
