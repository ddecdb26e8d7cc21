"""Summarize a torch profiler trace: the top device records by total time.
The counterpart of `tools/parse_trace.py`, which reads XProf's trace.

    python -m sgam_neurips22_tpu_torch.parse_trace DIR [--top 30] [--frames N] [--device 0]

DIR holds Chrome traces written by `utils/profiling.trace` (`.json` or
`.json.gz`); the newest is read through `utils/trace_events`. Rows are
device records (kernels, memcpys, memsets) summed by name, largest first,
with the JAX tool's columns in its order: total ms, %, count, avg us,
ms/frame (with --frames N: total / N) and the name, then in brackets the
source, which XLA writes as `args.source`: here the op that launched the
first such record, its input shapes, and the innermost frame of this
package around it (with Python stacks). `--device` takes the card's index
(or `cpu`) where the JAX tool took a process label. The header adds what
XProf never needed: busy time (the union of the device's record
intervals, where kernel time is their sum), the idle share over the
trace's span, and the launches that left no device record, with which
busy and idle are not given. A trace of a CPU run has the CPU ops' own
time as its records.
"""
from __future__ import annotations

import argparse
from collections import Counter
from typing import List, NamedTuple

from sgam_neurips22_tpu_torch.utils import trace_events as te


class Row(NamedTuple):
    name: str
    total_us: float
    count: int
    source: str


def source(r: te.Record) -> str:
    """The launching op, its input shapes and its innermost port frame."""
    if r.op is None:
        return ""
    frame = f" @ {r.op.source}" if r.op.source else ""
    return f"{r.op.name} {[list(d) for d in r.op.dims]}{frame}"


def summarize(trace: te.Trace, device) -> List[Row]:
    """The device's records summed by name, largest first."""
    total, count, src = Counter(), Counter(), {}
    for r in trace.records:
        if r.device != device:
            continue
        total[r.name] += r.dur_us
        count[r.name] += 1
        src.setdefault(r.name, source(r))
    return [Row(name, us, count[name], src[name]) for name, us in total.most_common()]


def header(trace: te.Trace, device) -> str:
    kernel, busy, idle = te.kernel_us(trace, device), te.busy_us(trace, device), te.idle_share(trace, device=device)
    n = sum(r.device == device for r in trace.records)
    links = Counter(r.link or "none" for r in trace.records if r.device == device)
    busy_s = "not given (lost launches)" if busy is None else f"{busy / 1e3:.2f} ms"
    idle_s = "not given" if idle is None else f"{idle:.3f}"
    return (f"# device {device}: kernel time {kernel / 1e3:.2f} ms over {n} records; busy (union) {busy_s}; "
            f"idle share {idle_s} of {trace.wall_us / 1e3:.2f} ms; lost launches {trace.lost} of {trace.launches}; "
            f"records without a launch {trace.orphans}; linked to ops by {dict(sorted(links.items()))}; "
            f"card {trace.metadata.get('card', 'not recorded')}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("profile_dir")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--device", default=None, help="the card's index, or cpu (default: the first in the trace)")
    args = ap.parse_args(argv)

    path = te.newest(args.profile_dir)
    print(f"# {path}")
    report(te.from_file(path), args.top, args.frames, args.device)


def report(trace: te.Trace, top: int = 30, frames=None, device=None) -> None:
    """Print the header and the top rows of one device of the trace."""
    device = te.pick_device(trace, device)
    rows = summarize(trace, device)
    grand = sum(r.total_us for r in rows)
    print(header(trace, device))
    hdr = f"{'total ms':>10} {'%':>6} {'count':>7} {'avg us':>9}"
    if frames:
        hdr += f" {'ms/frame':>9}"
    print(hdr + "  name")
    for r in rows[:top]:
        line = (f"{r.total_us / 1e3:10.2f} {100.0 * r.total_us / max(grand, 1):6.1f} "
                f"{r.count:7d} {r.total_us / max(r.count, 1):9.1f}")
        if frames:
            line += f" {r.total_us / 1e3 / frames:9.3f}"
        print(line + f"  {r.name}" + (f"  [{r.source}]" if r.source else ""))


if __name__ == "__main__":
    main()
