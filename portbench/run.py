"""The port's benchmark: one run of one cell.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the port
(`sgam_neurips22_tpu_torch`). The cell, its configuration
(`portbench/configs/<config>.json`), its traffic mix
(`portbench/traffic/<traffic>.json`), its comparison limits
(`portbench/limits/<workload>.json`) and its per-layer metrics
(`portbench/metrics/<metric>.py`) are found by the names in
`BENCHMARK.json`; the traffic's `kind` picks the cell's code (`unroll.py`,
`train.py`).

A run: set-up (weights from the seed on the card, the program, the warm-up
of the cell's own shapes; `setup_s` is from process start to the first
timed request or step), the window of `--seconds`, the peak of device
memory, with `--trace 1` a profiled session of a few more requests or
steps (`trace_calls`) read into the per-layer metrics, then the check
against the plain reference with the program freed. It prints the numbers
compared beside their limits as the last lines of standard error, and as
the last line of standard output one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the end-to-end metrics, or with `--trace 1` the
per-layer ones), `device`, with `--trace 1` `breakdown`, and last `checks`.

It exits non-zero, printing no result, when no card (or fewer than the
cell's) is visible, when a traced session cannot be read whole in three
tries, and when JAX or the JAX package is loaded in the process.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# build and kernel caches at fixed paths inside the checkout: only a cell's
# first run there builds; the program takes these over its own defaults
CACHE = ROOT / ".bench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["USE_FLAX"] = "0"

import torch  # noqa: E402

from portbench import trace as tr  # noqa: E402
from portbench import work  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "sgam_neurips22_tpu")  # top-level module names, compared whole
TRACE_TRIES = 3
SPAN_TOLERANCE = 0.05  # a traced session's device span against CUDA events over the same calls


def load_spec(workload: str, root: Path = ROOT) -> dict:
    """The cell's entries and files, found by name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    end_to_end = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    per_layer = [m for m in bench["per_layer"] if workload in m["workloads"]]
    return {
        "workload": cell, "chips": cell["chips"],
        "config": json.loads((root / config["file"]).read_text()),
        "traffic": json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text()),
        "limits": json.loads((BENCH / "limits" / f"{workload}.json").read_text()),
        "end_to_end": end_to_end, "per_layer": per_layer,
    }


def reader(metric: str):
    """The `read(ctx)` of portbench/metrics/<metric>.py."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_driver(kind: str):
    if kind == "unroll":
        from portbench.unroll import Cell
    elif kind == "train":
        from portbench.train import Cell
    else:
        raise SystemExit(f"unknown traffic kind {kind!r}")
    return Cell


class Context:
    """What a per-layer metric's reader reads: the traced sessions (`busy`,
    CUDA activity alone, with its `units` frames or steps, its host
    `window_s` and device `busy_s`; `trace`, the same calls again with the
    host's ops and Python stacks, for device time by layer and the hand
    ops' rooflines), the measured window (`window`: units and seconds), the
    device memory's peak and the model FLOPs of a unit."""

    def __init__(self, cell, busy, trace, units, window_s, window, peak_bytes):
        self.busy, self.trace, self.units, self.window_s, self.window = busy, trace, units, window_s, window
        self.peak_bytes = peak_bytes
        self.busy_s = sum(tr.union_us(v) for v in busy.intervals.values()) / 1e6
        self._cell, self._flops = cell, None

    def flops_per_unit(self) -> float:
        if self._flops is None:
            self._flops = self._cell.flops_per_unit()
        return self._flops

    def layer_s(self, patterns) -> float:
        """Device seconds of the records launched under a Python frame that
        matches one of `patterns` (regular expressions)."""
        rx = re.compile("|".join(patterns))
        return sum(r.dur_us for r in self.trace.records if any(rx.search(f) for f in tr.frames_of(r))) / 1e6

    def layer_ms_per_unit(self, patterns):
        """`layer_s` in ms a frame or step; None where the layer ran nothing."""
        s = self.layer_s(patterns)
        return 1e3 * s / self.units if s else None

    def idle_pct(self):
        """1 - the device's busy time a unit in the CUDA-only session times
        the window's units, over the window's seconds, in %."""
        if not self.units or not self.window["seconds"]:
            return None
        return 100.0 * (1.0 - self.busy_s / self.units * self.window["units"] / self.window["seconds"])

    def mfu_pct(self):
        """The model FLOPs of a unit times the window's units, over its
        seconds and the card's bf16 peak, in %."""
        if not self.window["seconds"]:
            return None
        return 100.0 * self.flops_per_unit() * self.window["units"] / self.window["seconds"] / work.PEAK_FLOP_PER_S

    def peak_gib(self):
        return self.peak_bytes / 2**30 if self.peak_bytes else None

    def roofline(self, name: str):
        """The hand op `name`'s summed work bound over its summed device
        time, in %; None where the session ran none of it."""
        row = next(r for r in HAND_OPS if r[0] == name)
        bound, device_s = roofline_parts(self.trace, *row[1:])
        return 100.0 * bound / device_s if device_s else None


# the hand attention ops: (name, their kernels, the kernel counted once a
# call, the op whose first input gives [B, S, C], the work function)
HAND_OPS = (("flash_fwd", "flash_fwd_kernel", "flash_fwd_kernel", "sgam::flash_attention_fwd", work.flash_fwd),
            ("flash_bwd", "flash_dq_kernel|flash_dkv_kernel", "flash_dq_kernel", "sgam::flash_attention_dq",
             work.flash_bwd))


def roofline_parts(trace, kernels: str, counted: str, op: str, fn) -> tuple:
    """(summed work bound s, summed device s) of a hand op's calls in the
    trace: one bound a call of the `counted` kernel, from the dims of the
    `op` around its launch."""
    rows = [r for r in trace.records if re.search(kernels, r.name)]
    bound = sum(work.bound_s(*fn(*tr.op_dims(r, op)[0])) for r in rows
                if re.search(counted, r.name) and tr.op_dims(r, op))
    return bound, sum(r.dur_us for r in rows) / 1e6


def hand_op_floor(trace) -> list:
    """The hand ops whose device time in the session reads under their work
    bound: a trace that read its kernels short."""
    bad = []
    for name, kernels, counted, op, fn in HAND_OPS:
        bound, device_s = roofline_parts(trace, kernels, counted, op, fn)
        if device_s and device_s < bound:
            bad.append(name)
    return bad


def session(cell, calls: int, layers: bool):
    """(Trace without primers, frames or steps, host seconds, faults) of
    one primed profiler session of `calls` more requests or steps: CUDA
    activity alone for the device's busy and idle time, or with `layers`
    also the host's ops with their shapes and Python stacks, which slow the
    host but not the device's records. Faults: launches lost, a device span
    that disagrees with CUDA events over the same calls, and (with
    `layers`) a hand op read under its work bound."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if layers else [ProfilerActivity.CUDA]
    with profile(activities=activities, record_shapes=layers, with_stack=layers) as prof:
        tr.lead_primers(torch)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        units = sum(cell.trace_call() for _ in range(calls))
        end.record()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        tr.close_primer(torch)
    results = prof.profiler.kineto_results
    frames = tr.frames_from_tree(results.experimental_event_tree()) if layers else None
    trace = tr.without_primers(tr.build(tr.raw_from_kineto(results.events()), frames))
    spans = [(r.start_us, r.start_us + r.dur_us) for r in trace.records]
    span_s = (max(b for _, b in spans) - min(a for a, _ in spans)) / 1e6 if spans else 0.0
    events_s = start.elapsed_time(end) / 1e3
    faults = []
    if trace.lost or not trace.records:
        faults.append(f"{trace.lost} of {trace.launches} launches lost, {len(trace.records)} records")
    if abs(span_s - events_s) > SPAN_TOLERANCE * events_s:
        faults.append(f"device span {span_s:.6f} s against {events_s:.6f} s of CUDA events")
    if layers:
        faults += [f"{k} under its work bound" for k in hand_op_floor(trace)]
    return trace, units, host_s, faults


def traced_session(cell, traffic: dict, window: dict, peak_bytes: int):
    """(Context, sessions retaken): a session for the device's busy time and
    one for its layers (`session`), each taken again, up to TRACE_TRIES
    times, until it shows no fault."""
    got, retaken = {}, 0
    for layers in (False, True):
        for attempt in range(TRACE_TRIES):
            got[layers] = session(cell, traffic["trace_calls"], layers)
            if not got[layers][3]:
                break
            retaken += 1
            print(f"traced session retaken ({'layers' if layers else 'busy'} {attempt + 1}): "
                  f"{'; '.join(got[layers][3])}", file=sys.stderr)
        else:
            raise SystemExit(f"no traced session read whole in {TRACE_TRIES} tries")
    records = got[True][0].records
    framed = [tr.frames_of(r) for r in records]
    print(f"layer session: {len(records)} records, {sum(map(bool, framed))} with Python frames, "
          f"{sum(any('sgam_neurips22_tpu_torch/' in f for f in fs) for fs in framed)} under the port", file=sys.stderr)
    busy, units, host_s, _ = got[False]
    return Context(cell, busy, got[True][0], units, host_s, window, peak_bytes), retaken


def breakdown(ctx: Context) -> dict:
    """From the busy session: the device ops that took most time, and the
    longest idle gaps, each by the kernel that ended it."""
    by_name: dict = {}
    for r in ctx.busy.records:
        key = tr.short_name(r.name)
        by_name[key] = by_name.get(key, 0.0) + r.dur_us / 1e6
    records = sorted(ctx.busy.records, key=lambda r: r.start_us)
    starts = [r.start_us for r in records]
    gaps: dict = {}
    for intervals in ctx.busy.intervals.values():
        for at, length in tr.gaps(intervals):
            label = "before " + tr.short_name(records[min(bisect.bisect_left(starts, at), len(records) - 1)].name)
            gaps[label] = gaps.get(label, 0.0) + length / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"device_ops": top(by_name), "idle_gaps": top(gaps)}


def run(spec: dict, seed: int, seconds: float, trace: bool, device, fault=None) -> dict:
    """One run of the cell on `device`; the result object, `checks` last."""
    cell = cell_driver(spec["traffic"]["kind"])(spec["config"], spec["traffic"], seed, device, fault)
    cuda = device.type == "cuda"
    cell.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T0
    window = cell.window(seconds)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    out_metrics, extra = {}, {}
    if trace:
        ctx, retaken = traced_session(cell, spec["traffic"], window, peak)
        print(f"traced sessions retaken: {retaken}", file=sys.stderr)
        for m in spec["per_layer"]:
            value = reader(m["name"])(ctx)
            if value is not None:
                out_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = {"busy_s": ctx.busy_s, "window_s": ctx.window_s}
        bd = breakdown(ctx)
        del ctx
    else:
        ends = dict(window["metrics"], setup_s=setup_s)
        out_metrics = {m["name"]: {"value": ends[m["name"]], "unit": m["unit"]} for m in spec["end_to_end"]}
    readings = cell.check()
    checks = {k: {"value": readings[k], "limit": v} for k, v in spec["limits"].items()}
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": window["attempted"], "failed": 0, "metrics": out_metrics,
        "device": {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else device.type,
                   "count": spec["chips"], "memory_peak_bytes": peak, **extra},
        "readings": {k: v for k, v in readings.items() if k not in spec["limits"]},
    }
    if trace:
        result["breakdown"] = bd
    result["checks"] = checks
    return result


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_spec(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        print(f"{args.workload} needs {spec['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible", file=sys.stderr)
        return 3
    result = run(spec, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"modules loaded that the port must not load: {found}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
