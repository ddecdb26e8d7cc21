"""Profiling hooks — port of `sgam_neurips22_tpu/utils/profiling.py`:

- `trace(logdir)`: a context manager around `torch.profiler.profile`
  (host activity, and the card's where CUDA is available, with input
  shapes and Python stacks, the counterpart of XLA's `args.source`) that
  writes a Chrome trace (`trace_<time>_<pid>.json`, for chrome://tracing
  or Perfetto) under `logdir`, with metadata for the trace tools: the card
  (`nvidia-smi`'s name and power limit, the name alone where nvidia-smi
  fails, or "cpu"), the port's matmul
  precision mode (`core.device`), torch's and CUDA's versions, and
  whether the block ran primed: on a card, between short spin kernels
  that open the session and a long one that closes it, which take the
  device records a session loses at its edges (`trace_events.
  primed_session`; the reader drops them). Read it
  with `python -m sgam_neurips22_tpu_torch.parse_trace` and `.roofline`
  (`utils/trace_events`);
- `StepTimer`: a light wall-clock timer per named section with summary
  statistics, for quick attribution of a hot loop without a trace.
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import time
from collections import defaultdict
from typing import Dict, Iterator, List

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    from torch.profiler import ProfilerActivity, profile

    from sgam_neurips22_tpu_torch.core.device import matmul_precision
    from sgam_neurips22_tpu_torch.utils.trace_events import lead_primers, profiler_primer

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, record_shapes=True, with_stack=True) as prof:
        if cuda:  # primers take the records a session loses at its edges; the reader drops them
            lead_primers(torch)
        yield
        if cuda:
            profiler_primer(torch)
            torch.cuda.synchronize()
        for key, value in (("card", _card() if cuda else "cpu"), ("matmul_precision", matmul_precision()),
                           ("torch", torch.__version__), ("cuda", str(torch.version.cuda)),
                           ("primed", str(cuda).lower())):
            prof.add_metadata(key, value)
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}.json"))


def _card() -> str:
    """nvidia-smi's name and power limit of the card, or its name where
    nvidia-smi cannot tell: the trace is written either way."""
    from sgam_neurips22_tpu_torch.utils.trace_events import card_line

    try:
        return card_line()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(0)}, power limit unknown"


class StepTimer:
    def __init__(self) -> None:
        self.times: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, vals in self.times.items():
            v = sorted(vals)
            out[name] = {
                "n": len(v),
                "mean_ms": 1e3 * sum(v) / len(v),
                "p50_ms": 1e3 * v[len(v) // 2],
                "max_ms": 1e3 * v[-1],
            }
        return out

    def report(self) -> str:
        return "\n".join(
            f"{name:30s} n={s['n']:4d} mean={s['mean_ms']:8.2f}ms p50={s['p50_ms']:8.2f}ms max={s['max_ms']:8.2f}ms"
            for name, s in sorted(self.summary().items())
        )
