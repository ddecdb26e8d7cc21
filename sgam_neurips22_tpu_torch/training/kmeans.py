"""k-means for the online codebook refresh — port of
`sgam_neurips22_tpu/training/kmeans.py`.

The reference re-clusters buffered pre-quantization features into the
codewords that went inactive. The bookkeeping runs in each train step on
the device; the refresh runs between steps, at most every `frequency`
steps. The random init is apart from Lloyd's iterations (`kmeans_init`,
from an explicit CPU `torch.Generator`; `lloyd`), so a test can start the
iterations from JAX's own init rows.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


def kmeans_init(data: torch.Tensor, k: int, generator: torch.Generator) -> torch.Tensor:
    """k distinct random rows of data [M, D] ('points' init, as scipy's
    minit='points'), drawn on the CPU from `generator`."""
    if k > data.shape[0]:
        raise ValueError(f"k-means of {data.shape[0]} rows into {k} clusters: k exceeds the rows")
    idx = torch.randperm(data.shape[0], generator=generator)[:k]
    return data[idx.to(data.device)]


def lloyd(data: torch.Tensor, centroids: torch.Tensor, iters: int = 20) -> torch.Tensor:
    """Lloyd's iterations from `centroids` [k, D] over data [M, D]: each row
    goes to its nearest centroid (the first on ties), each centroid moves
    to its rows' mean, and a centroid without rows keeps its place."""
    k = centroids.shape[0]
    sq = torch.sum(data**2, dim=1, keepdim=True)
    for _ in range(iters):
        d2 = sq + torch.sum(centroids**2, dim=1)[None, :] - 2.0 * (data @ centroids.T)
        assign = torch.argmin(d2, dim=1)
        sums = torch.zeros((k, data.shape[1]), dtype=data.dtype, device=data.device).index_add_(0, assign, data)
        counts = torch.bincount(assign, minlength=k)
        mean = sums / counts.clamp_min(1).to(data.dtype)[:, None]
        centroids = torch.where(counts[:, None] > 0, mean, centroids)
    return centroids


def kmeans(data: torch.Tensor, k: int, generator: torch.Generator, iters: int = 20) -> torch.Tensor:
    """[k, D] centroids of data [M, D]: `kmeans_init`, then `lloyd`."""
    return lloyd(data, kmeans_init(data, k, generator), iters)


@dataclass
class KMeansState:
    """The online refresh's bookkeeping: timeout [n_embed] int32 (<= 0 is
    inactive) and the ring buffer [buffer_size, P, D] of pre-quantization
    features on the device, and the write pointer, a host int (it moves by
    one a step, so reading it needs no device sync)."""

    timeout: torch.Tensor
    buffer: torch.Tensor
    ptr: int = 0


def init_kmeans_state(n_embed: int, buffer_size: int, positions: int, dim: int, word_timeout: int,
                      device: str | torch.device = "cpu") -> KMeansState:
    return KMeansState(
        timeout=torch.full((n_embed,), word_timeout, dtype=torch.int32, device=device),
        buffer=torch.zeros((buffer_size, positions, dim), dtype=torch.float32, device=device),
    )


def kmeans_bookkeeping(state: KMeansState, indices0: torch.Tensor, pre_quant0: torch.Tensor,
                       word_timeout: int) -> KMeansState:
    """One step's update, in place: the codewords batch element 0 used get
    their timeout back, every timeout drops by one, and element 0's
    features go into the ring buffer (the reference uses element 0 only)."""
    used = torch.zeros(state.timeout.shape, dtype=torch.bool, device=state.timeout.device)
    used[indices0.reshape(-1).long()] = True
    state.timeout.copy_(torch.where(used, word_timeout, state.timeout) - 1)
    state.buffer[state.ptr % state.buffer.shape[0]] = pre_quant0.reshape(-1, pre_quant0.shape[-1]).float()
    state.ptr += 1
    return state


def should_refresh(state: KMeansState, step: int, inactive_threshold: float, frequency: int,
                   start_global_step: int = 0) -> bool:
    """Whether to refresh at `step`: the frequency and the buffer's fill are
    checked on the host first; only then is the inactive count read."""
    if step < start_global_step or frequency <= 0 or step % frequency != 0:
        return False
    if state.ptr < state.buffer.shape[0]:
        return False
    inactive = int(torch.sum(state.timeout <= 0).item())
    return inactive / state.timeout.shape[0] > inactive_threshold


def refresh_codebook(codebook: torch.Tensor, state: KMeansState, word_timeout: int,
                     generator: torch.Generator) -> int:
    """Re-cluster the buffered features into as many centroids as there are
    inactive codewords, write them over those rows of `codebook` (in
    place) and give them their timeout back. Returns the number of rows
    refreshed."""
    inactive = torch.nonzero(state.timeout <= 0)[:, 0]
    k = int(inactive.shape[0])
    if k == 0:
        return 0
    feats = state.buffer.reshape(-1, state.buffer.shape[-1])
    centroids = kmeans(feats, k, generator)
    with torch.no_grad():
        codebook[inactive] = centroids.to(codebook.dtype)
    state.timeout[inactive] = word_timeout
    return k
