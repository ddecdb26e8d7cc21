"""Multi-process data parallelism — the port's counterpart of
`sgam_neurips22_tpu/parallel/distributed.py`.

The JAX package forms one global data mesh over every chip of every host
(`jax.distributed.initialize`): parameters are replicated, the global batch
is sharded, and XLA inserts the all-reduces, so every mean, every BatchNorm
statistic and every gradient is over the global batch. Here a rank is one
process that drives one card (or, under gloo, the CPU or a shared card),
and the all-reduces that XLA inserted are explicit calls on torch's process
group: NCCL between cards, gloo on the CPU. One Python thread feeding
several cards in turn would multiply the host's launch time by the card
count, and the host already bounds the batch-1 unroll.

Ranks and flags keep the JAX package's meaning: `--coordinator` (host:port
of process 0), `--num_processes` and `--process_id` name one launcher per
host, each of which spawns one rank per local card (`launch`); the global
rank is process_id x local ranks + local rank. The rendezvous is a TCP
store on the coordinator (127.0.0.1 on one host). Data loading follows the
JAX discipline: every rank walks the same epoch-seeded order and decodes
only its slice of each global batch (`training.data.datamodule.Loader`).

Without a process group every helper is the single-process no-op, so
call sites need no branch; `data_group()` is None there.
"""
from __future__ import annotations

import datetime
import os
import socket
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

BUCKET_BYTES = 25 << 20  # the bucket size of the flattened all-reduces (torch DDP's default)

# this process's place among the ranks of its host, set by `initialize`
_LOCAL = {"rank": 0, "size": 1}


def cluster(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
            process_id: Optional[int] = None) -> tuple:
    """The multi-host flags (coordinator, num_processes, process_id), each
    given or else from SGAM_COORDINATOR / SGAM_NUM_PROCESSES /
    SGAM_PROCESS_ID; None where neither says."""
    coordinator = coordinator or os.environ.get("SGAM_COORDINATOR")
    if num_processes is None and "SGAM_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["SGAM_NUM_PROCESSES"])
    if process_id is None and "SGAM_PROCESS_ID" in os.environ:
        process_id = int(os.environ["SGAM_PROCESS_ID"])
    return coordinator, num_processes, process_id


def initialize(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    local_rank: int = 0,
    local_size: int = 1,
    device: str | torch.device = "cuda",
) -> Optional[dist.ProcessGroup]:
    """Join (or form) the process group of this rank and return it; None,
    and nothing done, when neither the arguments nor the environment ask
    for several processes. Arguments fall back to SGAM_COORDINATOR /
    SGAM_NUM_PROCESSES / SGAM_PROCESS_ID (`cluster`); SGAM_DIST_INIT_TIMEOUT (seconds,
    900 by default) bounds the rendezvous and every collective.

    `num_processes` launchers of `local_size` ranks each make a world of
    num_processes x local_size ranks; this one is rank process_id x
    local_size + local_rank. The backend is NCCL for ranks on cards and
    gloo on the CPU; NCCL takes one card a rank and raises when there are
    more local ranks than cards (pass backend="gloo" to share a card). On a
    card, `torch.cuda.set_device` selects this rank's card, `cuda:{local_rank
    mod cards}`, before anything is allocated."""
    coordinator, num_processes, process_id = cluster(coordinator, num_processes, process_id)
    if coordinator is None and num_processes is None and local_size == 1:
        return None
    if coordinator is None:
        raise ValueError("several processes need a coordinator (host:port of process 0)")
    num_processes, process_id = num_processes or 1, process_id or 0
    if not 0 <= process_id < num_processes or not 0 <= local_rank < local_size:
        raise ValueError(f"process {process_id} of {num_processes}, local rank {local_rank} of {local_size}")
    kind = torch.device(device).type
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
        cards = torch.cuda.device_count()
        if backend == "nccl" and local_size > cards:
            raise ValueError(f"NCCL takes one card a rank: {local_size} local ranks on {cards} card(s); "
                             "pass backend='gloo' to put several ranks on one card")
        torch.cuda.set_device(local_rank % cards)
    elif backend == "nccl":
        raise ValueError("NCCL needs ranks on cards; the CPU takes backend='gloo'")
    _LOCAL.update(rank=local_rank, size=local_size)
    timeout = datetime.timedelta(seconds=int(os.environ.get("SGAM_DIST_INIT_TIMEOUT", "900")))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}", world_size=num_processes * local_size,
                            rank=process_id * local_size + local_rank, timeout=timeout)
    if backend == "nccl":
        # NCCL builds its communicator, and allocates its buffers, at the first
        # collective: now, before the rank fills its card (inside a training
        # step that allocation failed for want of memory)
        barrier()
    return dist.group.WORLD


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    if is_initialized():
        dist.destroy_process_group()
    _LOCAL.update(rank=0, size=1)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def data_group() -> Optional[dist.ProcessGroup]:
    """The group that the training step and the sharded unroll reduce
    over: every rank, once a group is formed (one rank too, so that a
    world of 1 runs the same collectives); None in a plain process."""
    return dist.group.WORLD if is_initialized() else None


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_primary() -> bool:
    """True on the rank that owns the host-side side effects (config
    snapshot, metrics, images, checkpoints): the reference's rank_zero_only."""
    return process_index() == 0


def local_rank() -> int:
    """This process's rank among its host's: its card is cuda:{local_rank}."""
    return _LOCAL["rank"]


def barrier() -> None:
    """Wait for every rank (a no-op without a group)."""
    if is_initialized():
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


# ------------------------------------------------------------ collectives
# gloo takes card tensors as they are on this torch build (all-reduce,
# broadcast and all-gather, probed on the card), so two gloo ranks sharing
# a card need no copy through the host.
def all_reduce_(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> torch.Tensor:
    """In-place all-reduce of one tensor; returns it."""
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's tensor (all of one shape) concatenated along dim 0 in
    rank order."""
    src = t.contiguous()
    out = torch.empty((dist.get_world_size(group) * src.shape[0], *src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out


def _buckets(tensors: Sequence[torch.Tensor], bucket_bytes: int) -> List[List[int]]:
    """Indices of `tensors` in runs of one dtype and device, each run at
    most `bucket_bytes` (a larger tensor is a bucket of its own)."""
    out: List[List[int]] = []
    size = 0
    for i, t in enumerate(tensors):
        b = t.numel() * t.element_size()
        last = tensors[out[-1][0]] if out else None
        if not out or last.dtype != t.dtype or last.device != t.device or size + b > bucket_bytes:
            out.append([])
            size = 0
        out[-1].append(i)
        size += b
    return out


def _bucketed(tensors: Sequence[torch.Tensor], fn: Callable[[torch.Tensor], None], bucket_bytes: int) -> None:
    for idx in _buckets(tensors, bucket_bytes):
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        fn(flat)
        offset = 0
        for i in idx:
            n = tensors[i].numel()
            tensors[i].copy_(flat[offset: offset + n].view_as(tensors[i]))
            offset += n


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group=None,
                     bucket_bytes: int = BUCKET_BYTES) -> Sequence[torch.Tensor]:
    """The mean over the ranks of each tensor, in place, through a few
    flattened all-reduces (one a bucket, not one a tensor). Every rank gets
    the same bits. A no-op without a group."""
    if group is None:
        return tensors
    n = dist.get_world_size(group)
    _bucketed(tensors, lambda flat: all_reduce_(flat, group=group).div_(n), bucket_bytes)
    return tensors


def broadcast_tensors_(tensors: Sequence[torch.Tensor], src: int = 0, group=None,
                       bucket_bytes: int = BUCKET_BYTES) -> Sequence[torch.Tensor]:
    """Rank `src`'s values of each tensor, in place, in flattened buckets."""
    if group is None:
        return tensors
    _bucketed(tensors, lambda flat: dist.broadcast(flat, src=src, group=group), bucket_bytes)
    return tensors


class _AllReduceSum(torch.autograd.Function):
    """sum over the ranks, whose backward is the sum over the ranks of the
    incoming gradients: the gradient of a global sum as XLA derives it."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_(t.clone(memory_format=torch.contiguous_format), group=group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(memory_format=torch.contiguous_format), group=ctx.group), None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """A differentiable all-reduce sum (the BatchNorm statistics over the
    global batch)."""
    return _AllReduceSum.apply(t, group)


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank `src`'s picklable object on every rank (the run name)."""
    if not is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


# ------------------------------------------------------------- placement
def _tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _to(x: Any, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else torch.as_tensor(x)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def shard_local_batch(batch: Any, mesh) -> Any:
    """This rank's rows of the global batch (each leaf's leading dim is
    global batch / ranks, as the loader decodes them), as tensors on the
    rank's device; one process: the batch on its device."""
    return _tree_map(lambda x: _to(x, mesh.device), batch)


def replicate_global(tree: Any, mesh) -> Any:
    """The values of rank 0 on every rank: each tensor of `tree` (a module's
    parameters and buffers, a dict or list of tensors) on the rank's device,
    overwritten in place by rank 0's. Returns the tree."""
    if isinstance(tree, torch.nn.Module):
        tree.to(mesh.device)
        tensors = [t.data for t in (*tree.parameters(), *tree.buffers())]
    else:
        tree = _tree_map(lambda x: _to(x, mesh.device), tree)
        tensors = []
        _tree_map(tensors.append, tree)
    with torch.no_grad():
        broadcast_tensors_(tensors, group=mesh.group)
    return tree


# ---------------------------------------------------------------- launch
def free_port() -> int:
    """A free TCP port on 127.0.0.1 for the rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(local: int, fn: Callable, args: tuple, n_local: int, init: Dict[str, Any],
                torch_threads: Optional[int]) -> None:
    if torch_threads:
        torch.set_num_threads(torch_threads)
    initialize(local_rank=local, local_size=n_local, **init)
    try:
        fn(*args)
    finally:
        shutdown()


def launch(fn: Callable, n_local: int, args: tuple = (), coordinator: Optional[str] = None,
           num_processes: int = 1, process_id: int = 0, backend: Optional[str] = None,
           device: str | torch.device = "cuda", torch_threads: Optional[int] = None) -> None:
    """Run fn(*args) in `n_local` spawned ranks of this host, each inside
    its process group (`initialize` with its local rank), and wait for all
    of them; a rank that raises makes this raise. `fn` must be importable
    by name (a module-level function); ranks return nothing, they write
    what they make. Without a coordinator, one host's ranks meet on a free
    port of 127.0.0.1."""
    import torch.multiprocessing as mp

    if n_local < 1:
        raise ValueError(f"launch of {n_local} ranks")
    coordinator = coordinator or f"127.0.0.1:{free_port()}"
    init = dict(coordinator=coordinator, num_processes=num_processes, process_id=process_id, backend=backend,
                device=str(device))
    mp.start_processes(_rank_entry, args=(fn, args, n_local, init, torch_threads), nprocs=n_local, join=True,
                       start_method="spawn")
