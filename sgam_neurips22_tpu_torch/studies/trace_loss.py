"""Where torch profiler sessions lose device records, on one card.

    python3 -m sgam_neurips22_tpu_torch.studies.trace_loss [--out DIR]

From the repository root, on a machine with a card. Each session is read
by `utils/trace_events` (live, `from_profile`), which counts the launches
whose device record the session lost and the records without a launch.
The kernel is one small elementwise add (`x.add_(1)` on 1024 floats, ~2 us
of device time). Settings, in this order, in one process:

- many: SESSIONS sessions of CALLS kernels each (CUDA activity only, as
  `device_ms` takes them): plain; with `profiler_primer`'s spin kernels
  first and last in each session; with the host waiting WAIT_S after the
  session's final synchronize, before the profiler stops; with the host
  waiting WAIT_S after the session starts, before the first launch; with
  the leading spin kernel waited for (synchronize) before the work; and
  as `device_ms` runs them, `trace_events.primed_session` (its losses
  among the work's launches only);
- long: one session each of LONG kernels (10^4 to 4 x 10^5), CUDA
  activity only, and 10^5 once more with host activity, shapes and
  Python stacks (as `utils/profiling.trace` records);
- idle: the many-sessions setting after IDLE_S of the process doing
  nothing, before the long sessions;
- again: the many-sessions setting once more, after the long sessions.

Before each many-sessions setting a clock probe: a session (host and CUDA
activity) that waits PROBE_MARGIN_S, launches one spin kernel between two
reads of the host's clock (`time.time_ns`), synchronizes and waits again;
it gives the spin kernel's launch (host clock of the profiler) and device
record (CUPTI's clock) less the host clock before the launch, in us.
Run with KINETO_LOG_LEVEL=1 to have Kineto print its own counts of each
session's dropped activities.

Prints the card's name and power limit, then one JSON line a setting
(sessions with a lost launch, launches lost of launched and where they sat
counted from the session's last launch, records without a launch,
"Activity Buffer Request" events, the seconds);
--out DIR also writes DIR/trace_loss.json.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

SESSIONS = 200
CALLS = 50
LONG = (10_000, 100_000, 400_000)
WAIT_S = 0.02
IDLE_S = 60.0
PROBE_MARGIN_S = 0.2
MANY = ({"primer": False}, {"primer": True}, {"primer": False, "wait": WAIT_S}, {"primer": False, "start_wait": WAIT_S},
        {"primer": True, "primer_sync": True})


def places(trace) -> dict:
    """How many lost launches sat where: the last launch, the 9 before it,
    further from the end, and the first."""
    from_end = [trace.launches - 1 - i for i in trace.lost_at]
    return {"last": sum(d == 0 for d in from_end), "last_10": sum(0 < d < 10 for d in from_end),
            "earlier": sum(d >= 10 for d in from_end), "first": sum(i == 0 for i in trace.lost_at)}


def session(torch, fn, calls: int, primer: bool = False, host: bool = False, wait: float = 0.0,
            start_wait: float = 0.0, primer_sync: bool = False) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from sgam_neurips22_tpu_torch.utils import trace_events as te

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    t0 = time.perf_counter()
    with profile(activities=acts, record_shapes=host, with_stack=host) as prof:
        time.sleep(start_wait)
        if primer:
            te.profiler_primer(torch)
            if primer_sync:
                torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        if primer:
            te.profiler_primer(torch)
        torch.cuda.synchronize()
        time.sleep(wait)
    events = list(prof.profiler.kineto_results.events())
    trace = te.from_profile(prof)
    return {"launches": trace.launches, "lost": trace.lost, "lost_where": places(trace), "orphans": trace.orphans,
            "records": len(trace.records),
            "buffer_requests": sum(ev.name() == "Activity Buffer Request" for ev in events),
            "seconds": time.perf_counter() - t0}


def many(torch, fn, primer: bool, wait: float = 0.0, start_wait: float = 0.0, primer_sync: bool = False) -> dict:
    runs = [session(torch, fn, CALLS, primer, wait=wait, start_wait=start_wait, primer_sync=primer_sync)
            for _ in range(SESSIONS)]
    return {"sessions": SESSIONS, "calls": CALLS, "primer": primer, "wait_s": wait, "start_wait_s": start_wait,
            "primer_sync": primer_sync,
            "sessions_with_loss": sum(r["lost"] > 0 for r in runs), "lost": sum(r["lost"] for r in runs),
            "lost_where": {k: sum(r["lost_where"][k] for r in runs) for k in runs[0]["lost_where"]},
            "launches": sum(r["launches"] for r in runs), "orphans": sum(r["orphans"] for r in runs),
            "first_lossy": next((i for i, r in enumerate(runs) if r["lost"]), None),
            "seconds": sum(r["seconds"] for r in runs)}


def clock_probe(torch) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sgam_neurips22_tpu_torch.utils import trace_events as te

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROBE_MARGIN_S)
        t0 = time.time_ns()
        te.profiler_primer(torch, 2_000_000)
        torch.cuda.synchronize()
        t1 = time.time_ns()
        time.sleep(PROBE_MARGIN_S)
    events = list(prof.profiler.kineto_results.events())
    spin = [e for e in events if e.device_type() == DeviceType.CUDA and te.PRIMER_KERNEL in e.name()]
    launch = [e for e in events if spin and e.device_type() == DeviceType.CPU
              and e.correlation_id() == spin[0].correlation_id() and te.LAUNCH.match(e.name())]
    return {"setting": "clock_probe", "host_window_us": (t1 - t0) / 1e3,
            "launch_minus_host_us": (launch[0].start_ns() - t0) / 1e3 if launch else None,
            "record_minus_host_us": (spin[0].start_ns() - t0) / 1e3 if spin else None}


def primed(torch, fn) -> dict:
    from sgam_neurips22_tpu_torch.utils import trace_events as te

    runs = [te.primed_session(torch, fn, CALLS) for _ in range(SESSIONS)]
    return {"sessions": SESSIONS, "calls": CALLS, "primed_session": True,
            "sessions_with_loss": sum(t.lost > 0 for t in runs), "lost": sum(t.lost for t in runs),
            "launches": sum(t.launches for t in runs), "orphans": sum(t.orphans for t in runs)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    import torch

    from sgam_neurips22_tpu_torch.utils.trace_events import card_line

    if not torch.cuda.is_available():
        print("trace_loss: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    x = torch.zeros(1024, device="cuda")

    def fn():
        x.add_(1.0)

    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    rows = []
    for setting in ("many", "idle"):
        if setting == "idle":
            time.sleep(IDLE_S)
        rows.append(clock_probe(torch))
        print(json.dumps(rows[-1]), flush=True)
        for kw in MANY:
            rows.append({"setting": setting, **many(torch, fn, **kw)})
            print(json.dumps(rows[-1]), flush=True)
        rows.append({"setting": setting, **primed(torch, fn)})
        print(json.dumps(rows[-1]), flush=True)
    for n in LONG:
        rows.append({"setting": "long", "calls": n, **session(torch, fn, n)})
        print(json.dumps(rows[-1]), flush=True)
    rows.append({"setting": "long_with_host", "calls": LONG[1], **session(torch, fn, LONG[1], host=True)})
    print(json.dumps(rows[-1]), flush=True)
    rows.append(clock_probe(torch))
    print(json.dumps(rows[-1]), flush=True)
    for kw in MANY:
        rows.append({"setting": "again", **many(torch, fn, **kw)})
        print(json.dumps(rows[-1]), flush=True)
    rows.append({"setting": "again", **primed(torch, fn)})
    print(json.dumps(rows[-1]), flush=True)
    if args.out:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "trace_loss.json").write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
