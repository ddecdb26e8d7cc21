"""The port's one reader of torch profiler sessions: device records, the op
that launched each, busy time as a union of intervals, and the launches a
trace lost.

A session comes in two forms, and both are read into one `Trace`:
- a live `torch.profiler.profile` (`from_profile`), through its raw Kineto
  events (`prof.profiler.kineto_results.events()`): no export, and
  seconds faster than `key_averages()` on a trace of tens of thousands of
  kernels;
- a Chrome trace file written by `utils/profiling.trace` (or any
  `export_chrome_trace`), `.json` or `.json.gz` (`from_file`, `newest`).

Each device record (a kernel, a memcpy or a memset) is linked by CUPTI's
`correlation` id to the runtime or driver call that launched it, and that
call to the innermost CPU op around it: by the op's `External id` where the
call carries one, else by time nesting on the call's thread. A record keeps
the chain of ops around its launch, innermost first, and the innermost
frame of this package around the op where the session recorded Python
stacks (`Op.source`). A trace that holds no device activity at all (a CPU
run) has the CPU ops' own time as its records, on the device "cpu".

Busy time is the union of a device's record intervals (records on several
streams overlap: NCCL's beside compute); the sum of their durations is
kept beside it as kernel time. A launch (`LAUNCH`) whose device record is
missing is counted as lost, and where any is lost `busy_us` and
`idle_share` give None, never a low number. Device records without a
launch (launched before the session began) are counted apart.

Also here, shared by chip_smoke.py and the studies: CUDA-event and
profiler timing (`cuda_ms`, `device_ms`, `kernel_split`, `profile_unroll`),
the layer groups of kernel names (`KERNEL_GROUPS`), and the card's peaks.
"""
from __future__ import annotations

import glob
import gzip
import json
import os
import re
import subprocess
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

# NVIDIA H100 SXM5 80GB HBM3 data-sheet peaks (dense, no sparsity), which
# assume its 700 W power limit: HBM3 bandwidth, f32 on the CUDA cores, TF32
# and bf16 on the tensor cores. A card set to a lower limit
# (`nvidia-smi --query-gpu=name,power.limit`) runs slower under load: state
# its name and limit beside any share of these.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12
L2_BYTES = 50 * 2**20  # the L2: 52,428,800 bytes, as cudaDeviceProp.l2CacheSize gives it on the card

# the calls that put work on a device: each should have one device record
LAUNCH = re.compile(r"^(cudaLaunch\w*Kernel\w*|cuLaunch\w*Kernel\w*|cudaMemcpy\w*Async\w*|cudaMemsetAsync\w*)$")
_RUNTIME = re.compile(r"^cuda?[A-Z]")  # CUDA runtime (cuda*) and driver (cu*) calls
_PYTHON = re.compile(r"\(\d+\): |^<built-in ")  # Python frames ("file(line): function") of a session with stacks
_PORT_FRAME = re.compile(r"sgam_neurips22_tpu_torch/[\w/]+\.py\(\d+\): .*")
_TOOL_FRAMES = ("sgam_neurips22_tpu_torch/utils/profiling.py", "sgam_neurips22_tpu_torch/utils/trace_events.py")
_DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}

PRIMER_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel: profiler_primer's, left out of every reading
ZB_KERNELS = "zbuffer_tile_kernel|zbuffer_l2_kernel"  # the z-buffer's own kernels in a profile
KERNEL_GROUPS = (  # kernel name -> layer, first match wins
    ("nccl", "collectives (NCCL)"),
    ("flash_fwd_kernel", "ours: flash_attention_fwd"),
    ("flash_dq_kernel", "ours: flash_attention_dq"),
    ("flash_dkv_kernel", "ours: flash_attention_dkv"),
    (ZB_KERNELS, "ours: zbuffer_min"),
    ("search_kernel|finalize_kernel", "ours: nearest_codeword"),
    ("ga_zero|ga_prep|ga_spine|ga_count|ga_scatter|ga_walk", "ours: grid_accumulate"),
    ("fprop|dgrad|wgrad|cudnn|nchwToNhwc|nhwcToNchw|conv|fft|pointwise_mult_and_sum_complex|gemm_cf32",
     "conv (cuDNN: implicit GEMM, FFT)"),
    ("gemm", "matmul (attention, plain GEMMs)"),
    ("batch_norm|bn_", "BatchNorm (discriminator)"),
    ("adam|Adam|multi_tensor", "optimizer (Adam)"),
    ("softmax|SoftMax", "softmax"),
    ("reduce_kernel", "reductions (GroupNorm stats, splat z range)"),
    ("", "elementwise / copies / index"),
)
# profiler sessions whose device time could not be read (device_ms, profile_unroll): what and why
PROFILER_MISSES: List[str] = []


class Op(NamedTuple):
    """A CPU op of the session: its `External id`, name, the shapes, types
    and scalar values of its inputs as the profiler recorded them (with
    `record_shapes`), and the innermost frame of this package around it
    ("file.py(line): function", with Python stacks; else "")."""
    id: int
    name: str
    dims: tuple
    types: tuple
    concrete: tuple
    source: str


class Record(NamedTuple):
    """One device record: `kind` is kernel, memcpy, memset (or op, the CPU
    ops' own time in a trace without device activity), `ops` the CPU ops
    around its launch, innermost first, and `link` how the launch was tied
    to them: "External id", "nesting", or "" (no op, or no launch)."""
    name: str
    kind: str
    device: object  # the card's index, or "cpu"
    stream: int
    start_us: float
    dur_us: float
    correlation: int
    ops: Tuple[Op, ...]
    link: str

    @property
    def op(self) -> Optional[Op]:
        return self.ops[0] if self.ops else None


class Trace(NamedTuple):
    records: List[Record]
    launches: int  # LAUNCH calls in the session
    lost: int  # LAUNCH calls without a device record
    lost_at: Tuple[int, ...]  # their places among the launches, in time order (0: the first)
    orphans: int  # device records without a launch
    wall_us: float  # from the session's first event to its last
    metadata: dict
    path: str
    intervals: Dict[object, List[Tuple[float, float]]]  # busy intervals by device


class _Raw(NamedTuple):
    kind: str  # op, python, runtime, or a device record's kind
    name: str
    tid: object
    start: float
    dur: float
    corr: int  # CUPTI correlation of a launch or a device record
    ext: int  # an op's own External id; a launch's or record's link to one
    device: object
    stream: int
    dims: tuple
    types: tuple
    concrete: tuple


def _tuple(x) -> tuple:
    """Nested lists as nested tuples (hashable)."""
    return tuple(_tuple(v) if isinstance(v, (list, tuple)) else v for v in (x or ()))


def _raw_from_chrome(events: list) -> List[_Raw]:
    out = []
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X" or cat is None:
            continue
        a = e.get("args") or {}
        if cat in ("cpu_op", "user_annotation"):
            kind = "op"
        elif cat == "python_function":
            kind = "python"
        elif cat in ("cuda_runtime", "cuda_driver"):
            kind = "runtime"
        elif cat in _DEVICE_CATS:
            kind = _DEVICE_CATS[cat]
        else:
            continue
        device = a.get("device", e.get("pid")) if kind in _DEVICE_CATS.values() else None
        out.append(_Raw(kind, e.get("name", "?"), e.get("tid"), float(e["ts"]), float(e.get("dur", 0.0)),
                        int(a.get("correlation", 0) or 0), int(a.get("External id", 0) or 0), device,
                        int(a.get("stream", e.get("tid", 0)) or 0) if kind in _DEVICE_CATS.values() else 0,
                        _tuple(a.get("Input Dims")), _tuple(a.get("Input type")),
                        tuple(a.get("Concrete Inputs") or ())))
    return out


def _raw_from_kineto(events) -> List[_Raw]:
    """The raw events of a live session. On a CPU op `correlation_id()` is
    its External id; on a launch and a device record it is CUPTI's
    correlation, and `linked_correlation_id()` the op's External id."""
    from torch.autograd import DeviceType

    out = []
    for ev in events:
        name = ev.name()
        start, dur = ev.start_ns() / 1e3, ev.duration_ns() / 1e3
        if ev.device_type() == DeviceType.CUDA:
            if ev.is_user_annotation():
                continue
            kind = "memcpy" if name.startswith("Memcpy") else "memset" if name.startswith("Memset") else "kernel"
            out.append(_Raw(kind, name, None, start, dur, ev.correlation_id(), ev.linked_correlation_id(),
                            ev.device_index(), ev.device_resource_id(), (), (), ()))
        elif ev.device_type() == DeviceType.CPU:
            tid = ev.start_thread_id()
            if _RUNTIME.match(name):
                out.append(_Raw("runtime", name, tid, start, dur, ev.correlation_id(), ev.linked_correlation_id(),
                                None, 0, (), (), ()))
            elif _PYTHON.search(name):
                out.append(_Raw("python", name, tid, start, dur, 0, 0, None, 0, (), (), ()))
            elif name != "Activity Buffer Request":
                concrete = tuple("" if c is None else str(c) for c in (ev.concrete_inputs() or ()))
                out.append(_Raw("op", name, tid, start, dur, 0, ev.correlation_id(), None, 0,
                                _tuple(ev.shapes()), tuple(ev.dtypes() or ()), concrete))
    return out


def _port_frame(name: str) -> str:
    m = _PORT_FRAME.search(name)
    return "" if m is None or m.group(0).startswith(_TOOL_FRAMES) else m.group(0)


def _nest(raw: List[_Raw]):
    """Per thread, the ops, Python frames and launches in time order, each
    nested in what encloses it: {op id: (its chain of op ids, innermost
    first; its source frame; its own time)}, {launch correlation: chain},
    and the outermost ops' intervals."""
    by_tid = defaultdict(list)
    for r in raw:
        if r.kind in ("op", "python", "runtime"):
            by_tid[r.tid].append(r)
    chains, launched, top = {}, {}, []
    order = {"op": 0, "python": 0, "runtime": 1}
    for items in by_tid.values():
        items.sort(key=lambda r: (r.start, order[r.kind], -r.dur))
        # (end, chain of op ids, port frame); an end is clipped to its
        # parent's: a Python frame whose exit the tracer missed runs on to
        # the session's end
        stack: list = []
        for r in items:
            while stack and stack[-1][0] <= r.start:
                stack.pop()
            end, chain, frame = stack[-1] if stack else (float("inf"), (), "")
            if r.kind == "runtime":
                launched[r.corr] = (r, chain)
                continue
            if r.kind == "python":
                stack.append((min(end, r.start + r.dur), chain, _port_frame(r.name) or frame))
                continue
            if not chain:
                top.append((r.start, r.start + r.dur))
            own = (r.ext,) + chain
            chains[r.ext] = (own, frame, r)
            stack.append((min(end, r.start + r.dur), own, frame))
    return chains, launched, top


def _self_time(chains) -> Dict[int, float]:
    """Each op's own time: its duration less its direct children's."""
    child = defaultdict(float)
    for own, _, r in chains.values():
        if len(own) > 1:
            child[own[1]] += r.dur
    return {ext: max(r.dur - child[ext], 0.0) for ext, (_, _, r) in chains.items()}


def _build(raw: List[_Raw], metadata: dict, path: str) -> Trace:
    chains, launched, top = _nest(raw)
    ops = {ext: Op(ext, r.name, r.dims, r.types, r.concrete, frame) for ext, (_, frame, r) in chains.items()}

    def chain_of(ids) -> Tuple[Op, ...]:
        return tuple(ops[i] for i in ids if i in ops)

    device = [r for r in raw if r.kind in _DEVICE_CATS.values()]
    span = [r.start for r in raw] + [r.start + r.dur for r in raw]
    wall = (max(span) - min(span)) if span else 0.0
    launch_calls = {c for c, (r, _) in launched.items() if LAUNCH.match(r.name)}
    if not device and not launch_calls:  # no device activity: the CPU ops' own time
        own = _self_time(chains)
        records = [Record(r.name, "op", "cpu", 0, r.start, own[ext], 0, chain_of(ids), "")
                   for ext, (ids, _, r) in chains.items()]
        return Trace(records, 0, 0, (), 0, wall, metadata, path, {"cpu": top})
    records, seen, orphans = [], set(), 0
    intervals = defaultdict(list)
    for r in device:
        seen.add(r.corr)
        hit = launched.get(r.corr)
        if hit is None:
            orphans += 1
            records.append(Record(r.name, r.kind, r.device, r.stream, r.start, r.dur, r.corr, (), ""))
        else:
            call, nested = hit
            if call.ext and call.ext in ops:
                link, ids = "External id", chains[call.ext][0]
            else:
                link, ids = ("nesting" if nested else ""), nested
            records.append(Record(r.name, r.kind, r.device, r.stream, r.start, r.dur, r.corr, chain_of(ids), link))
        intervals[r.device].append((r.start, r.start + r.dur))
    order = sorted(launch_calls, key=lambda c: launched[c][0].start)
    lost_at = tuple(i for i, c in enumerate(order) if c not in seen)
    return Trace(records, len(order), len(lost_at), lost_at, orphans, wall, metadata, path, dict(intervals))


def from_profile(prof) -> Trace:
    """The Trace of a finished live `torch.profiler.profile`."""
    return _build(_raw_from_kineto(prof.profiler.kineto_results.events()), {}, "")


def from_file(path: str) -> Trace:
    """The Trace of a Chrome trace file (`.json` or `.json.gz`), with the
    file's top-level entries other than its events as metadata; without
    its primers where `utils/profiling.trace` primed the session."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    meta = {k: v for k, v in data.items() if k != "traceEvents"}
    trace = _build(_raw_from_chrome(data.get("traceEvents", [])), meta, path)
    return without_primers(trace) if meta.get("primed") == "true" else trace


def newest(profile_dir: str) -> str:
    """The newest Chrome trace under profile_dir (SystemExit if none)."""
    paths = [p for pat in ("*.json", "*.json.gz")
             for p in glob.glob(os.path.join(profile_dir, "**", pat), recursive=True)]
    if not paths:
        raise SystemExit(f"no *.json or *.json.gz trace under {profile_dir}")
    return max(paths, key=os.path.getmtime)


def union_us(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def pick_device(trace: Trace, device=None):
    """A device of the trace: `device` ("cpu" or a card's index, as an int
    or a string), or the first card in it, or "cpu"."""
    if device is not None:
        return "cpu" if str(device) == "cpu" else int(device)
    cards = sorted(d for d in trace.intervals if d != "cpu")
    return cards[0] if cards else "cpu"


def kernel_us(trace: Trace, device=None) -> float:
    """The summed duration of the records (of one device)."""
    return sum(r.dur_us for r in trace.records if device is None or r.device == device)


def busy_us(trace: Trace, device=None) -> Optional[float]:
    """The union of one device's record intervals (of every device's,
    device by device, summed); None where a launch was lost."""
    if trace.lost:
        return None
    return sum(union_us(v) for d, v in trace.intervals.items() if device is None or d == device)


def idle_share(trace: Trace, wall_us: Optional[float] = None, device=None) -> Optional[float]:
    """1 - busy / wall (the session's own span unless `wall_us` is given);
    None where a launch was lost or there is no wall."""
    busy, wall = busy_us(trace, device), trace.wall_us if wall_us is None else wall_us
    return None if busy is None or not wall else 1.0 - busy / wall


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace,
    template arguments and parameters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or name


def group_of(name: str) -> str:
    return next(label for pat, label in KERNEL_GROUPS if re.search(pat, name))


# ---------------------------------------------------------------- timing on the card
def card_line(index: int = 0) -> str:
    """The card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them."""
    out = subprocess.run(["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def cuda_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_rows(trace: Trace) -> list:
    """[(device us, record name, calls)] of a trace, largest first: every
    record's time summed by name."""
    agg: dict = {}
    for r in trace.records:
        row = agg.setdefault(r.name, [0.0, 0])
        row[0] += r.dur_us
        row[1] += 1
    return sorted(((us, name, n) for name, (us, n) in agg.items()), reverse=True)


# short spin kernels that open a primed session: late in a process a card's
# sessions drop the records of their first launches, up to ~14 of them
# (PERF.md §7: studies/trace_loss.py and chip_smoke's misses)
PRIMER_LEAD = 32


def profiler_primer(torch, cycles: int = 5_000_000) -> None:
    """A spin kernel (`torch.cuda._sleep`; 5e6 cycles, about 2.5 ms) that
    stands in for the work at a session's edges, where traces lose device
    records (PERF.md §7)."""
    torch.cuda._sleep(cycles)


def lead_primers(torch) -> None:
    """PRIMER_LEAD short spin kernels (~25 us each), waited for: they take
    the records a session drops at its start."""
    for _ in range(PRIMER_LEAD):
        profiler_primer(torch, 50_000)
    torch.cuda.synchronize()


def without_primers(trace: Trace, lead: int = PRIMER_LEAD) -> Trace:
    """A primed session's trace without its primers: their records and
    their time from the wall, and from the lost launches the first `lead`
    and the last (the primers' places), so that `lost` counts only the
    work's."""
    records = [r for r in trace.records if PRIMER_KERNEL not in r.name]
    primed_us = sum(r.dur_us for r in trace.records if PRIMER_KERNEL in r.name)  # the host waited them out
    lost_at = tuple(i - lead for i in trace.lost_at if lead <= i < trace.launches - 1)
    intervals: dict = defaultdict(list)
    for r in records:
        intervals[r.device].append((r.start_us, r.start_us + r.dur_us))
    return trace._replace(records=records, launches=max(trace.launches - lead - 1, 0), lost=len(lost_at),
                          lost_at=lost_at, intervals=dict(intervals), wall_us=max(trace.wall_us - primed_us, 0.0))


def primed_session(torch, fn, calls: int = 1, activities=None) -> Trace:
    """`calls` calls of fn() in one profiler session (CUDA activity only
    unless `activities` are given), opened by PRIMER_LEAD short spin
    kernels that the host waits for (`lead_primers`) and closed by one
    long spin kernel: late in a process the first launches of a session
    lose their records (PERF.md §7), and these take the loss. The
    trace comes back without the primers (`without_primers`)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=activities or [ProfilerActivity.CUDA]) as prof:
        lead_primers(torch)
        for _ in range(calls):
            fn()
        profiler_primer(torch)
        torch.cuda.synchronize()
    return without_primers(from_profile(prof))


def device_ms(torch, fn, iters: int = 50, warmup: int = 5, match: Optional[str] = None) -> Optional[float]:
    """Device time per fn() call: the summed time of every device record
    that `iters` calls made (only those whose name matches the regex
    `match`, if given), over `iters`. Unlike cuda_ms it leaves out the
    gaps while the host prepares each launch. The calls run in a primed
    session (`primed_session`); one that lost a launch of theirs or holds
    no device time is taken once more; if that one fails too, the
    miss goes into PROFILER_MISSES and the time comes from CUDA events
    (cuda_ms), or is None where `match` asks for some kernels only."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(2):
        trace = primed_session(torch, fn, iters)
        if trace.records and not trace.lost:
            return sum(r.dur_us for r in trace.records if match is None or re.search(match, r.name)) / 1e3 / iters
    PROFILER_MISSES.append(f"device_ms(match={match!r}): {trace.lost} of {trace.launches} launches lost")
    return None if match else cuda_ms(torch, fn, iters, warmup)


def kernel_split(torch, fn, sessions: int = 8, warmup: int = 3) -> dict:
    """The device records one fn() call makes, in launch order, with their
    device us: one primed profiler session a call, `sessions` of them, averaged
    over the sessions that lost no launch and whose sequence of names is
    the most common. {"kernels": [(name, us)], "sessions": kept / run,
    "lost_sessions": sessions that lost a launch}; kernels is None where
    no session was whole."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    seqs, lost = [], 0
    for _ in range(sessions):
        trace = primed_session(torch, fn)
        lost += bool(trace.lost)
        if not trace.lost:
            seqs.append(tuple((r.name, r.dur_us) for r in sorted(trace.records, key=lambda r: r.start_us)))
    names = [tuple(n for n, _ in q) for q in seqs if q]
    if not names:
        return {"kernels": None, "sessions": f"0/{sessions}", "lost_sessions": lost}
    common = max(set(names), key=names.count)
    kept = [q for q in seqs if tuple(n for n, _ in q) == common]
    return {"kernels": [(short_name(common[j]), sum(q[j][1] for q in kept) / len(kept))
                        for j in range(len(common))],
            "sessions": f"{len(kept)}/{sessions}", "lost_sessions": lost}


def profile_unroll(torch, unroll, frames: int, timed_s: float) -> dict:
    """Device time by kernel over one more call of unroll(), which makes
    `frames` frames, grouped by layer; busy time (the union of the device's
    record intervals) and kernel time (their sum) a frame, and the idle
    share: 1 - busy / the timed unroll's wall time (the profiler itself
    slows the host, so its own wall is not used). The call runs in a primed
    session (CUDA activity only: host ops cost ~30 s to sort). Where the
    session lost a launch of the call's or holds no device time, every
    time of it (busy, kernel, by layer, the top kernels) and the idle share
    are None (not measured), the conv kernels' names are still given, and
    the miss goes into PROFILER_MISSES."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trace = primed_session(torch, unroll)
    wall = time.perf_counter() - t0
    busy = busy_us(trace) if trace.records else None
    if busy is None:
        PROFILER_MISSES.append(f"profile_unroll: {trace.lost} of {trace.launches} launches lost, "
                               f"{len(trace.records)} records")
    measured = busy is not None
    rows = device_rows(trace)
    groups: dict = {}
    for us, name, _ in rows:
        groups[group_of(name)] = groups.get(group_of(name), 0.0) + us / 1e3 / frames
    return {
        "profiled_wall_s": wall, "device_busy_ms_per_frame": busy / 1e3 / frames if measured else None,
        "device_kernel_ms_per_frame": kernel_us(trace) / 1e3 / frames if measured else None,
        "device_idle_share": 1.0 - busy / 1e6 / timed_s if measured else None,
        "trace_launches": trace.launches, "lost_launches": trace.lost, "records_without_launch": trace.orphans,
        "ms_per_frame_by_layer": dict(sorted(groups.items(), key=lambda kv: -kv[1])) if measured else None,
        "conv_kernels": sorted({k[:120] for _, k, _ in rows if group_of(k).startswith("conv")}),
        "top": [{"kernel": k[:120], "ms": us / 1e3, "calls": n} for us, k, n in rows[:25]] if measured else None,
    }
