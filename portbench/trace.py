"""The benchmark's reader of a torch profiler session: device records, the
ops and Python frames behind each launch, busy time as a union of
intervals, lost launches, and a session's own checks.

Frozen copy of the arithmetic of sgam_neurips22_tpu_torch/utils/trace_events.py
at commit e4e59b7 (`_raw_from_kineto`, `_nest`, `_build`, `union_us`,
`short_name`, the primers and `without_primers`), with three additions for
putting device time on the program's layers:
- every op keeps the whole chain of Python frames around it (not only the
  innermost frame of the port);
- a backward op, which autograd runs on its own thread, takes the frames
  of the forward op that recorded its node (the same `sequence_nr` on the
  forward thread), and the ops inside it take none: the frames a session
  gives them are the caller's, waiting in `backward` or `grad`;
- Python frames are put on the op thread they run on (`python_threads`).

Each device record is linked by CUPTI's correlation id to the runtime call
that launched it, and that call to the innermost CPU op around it (by the
op's External id, else by time nesting on its thread). A launch whose
device record is missing is counted as lost.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

LAUNCH = re.compile(r"^(cudaLaunch\w*Kernel\w*|cuLaunch\w*Kernel\w*|cudaMemcpy\w*Async\w*|cudaMemsetAsync\w*)$")
_RUNTIME = re.compile(r"^cuda?[A-Z]")
_PYTHON = re.compile(r"\(\d+\): |^<built-in ")
_BACKWARD = "autograd::engine::evaluate_function"
PRIMER_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel
# late in a process a card's sessions drop the records of their first
# launches (the port's PERF.md, "traces lose device work"): this many short
# spin kernels open each session and take the loss
PRIMER_LEAD = 32


class Op(NamedTuple):
    id: int
    name: str
    dims: tuple
    frames: Tuple[str, ...]  # Python frames around the op, outermost first


class Record(NamedTuple):
    name: str
    device: object
    start_us: float
    dur_us: float
    ops: Tuple[Op, ...]  # the CPU ops around its launch, innermost first


class Trace(NamedTuple):
    records: List[Record]
    launches: int
    lost: int
    lost_at: Tuple[int, ...]  # the lost launches' places in launch order (0: the first)
    orphans: int
    intervals: Dict[object, List[Tuple[float, float]]]


class _Raw(NamedTuple):
    kind: str  # op, python, runtime, kernel, memcpy, memset
    name: str
    tid: object
    start: float
    dur: float
    corr: int
    ext: int
    device: object
    dims: tuple
    seq: int
    fwd_tid: object


def _tuple(x) -> tuple:
    return tuple(_tuple(v) if isinstance(v, (list, tuple)) else v for v in (x or ()))


def raw_from_kineto(events) -> List[_Raw]:
    """The raw events of a finished live session."""
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
                            ev.device_index(), (), -1, None))
        elif ev.device_type() == DeviceType.CPU:
            tid = ev.start_thread_id()
            if _RUNTIME.match(name):
                out.append(_Raw("runtime", name, tid, start, dur, ev.correlation_id(), ev.linked_correlation_id(),
                                None, (), -1, None))
            elif _PYTHON.search(name):
                out.append(_Raw("python", name, tid, start, dur, 0, 0, None, (), -1, None))
            elif name != "Activity Buffer Request":
                out.append(_Raw("op", name, tid, start, dur, 0, ev.correlation_id(), None, _tuple(ev.shapes()),
                                ev.sequence_nr(), ev.fwd_thread_id()))
    return out


def python_threads(raw: List[_Raw]) -> dict:
    """{thread id of Python frames: thread id of ops}: the Python tracer may
    name a thread otherwise than the op recorder does; each of its threads
    is the op thread whose ops start most often inside its frames."""
    starts = defaultdict(list)
    for r in raw:
        if r.kind in ("op", "runtime"):
            starts[r.tid].append(r.start)
    for v in starts.values():
        v.sort()
    frames = defaultdict(list)
    for r in raw:
        if r.kind == "python":
            frames[r.tid].append(r)
    out = {}
    for tid, evs in frames.items():
        if tid in starts:
            out[tid] = tid
            continue
        evs = sorted(evs, key=lambda r: -r.dur)[:200]
        hits = {t: sum(bisect.bisect_left(v, r.start + r.dur) - bisect.bisect_left(v, r.start) for r in evs)
                for t, v in starts.items()}
        if hits:
            out[tid] = max(hits, key=hits.get)
    return out


def _nest(raw: List[_Raw]):
    """Per thread, ops, Python frames and launches in time order, each
    nested in what encloses it: {op id: (chain of op ids, innermost first;
    Python frames, outermost first; the raw op)}, {launch correlation:
    (the call, its chain)}."""
    threads = python_threads(raw)
    by_tid = defaultdict(list)
    for r in raw:
        if r.kind in ("op", "runtime"):
            by_tid[r.tid].append(r)
        elif r.kind == "python" and r.tid in threads:
            by_tid[threads[r.tid]].append(r)
    chains, launched = {}, {}
    order = {"op": 0, "python": 0, "runtime": 1}
    for items in by_tid.values():
        items.sort(key=lambda r: (r.start, order[r.kind], -r.dur))
        stack: list = []  # (end, chain of op ids, frames); an end is clipped to its parent's
        for r in items:
            while stack and stack[-1][0] <= r.start:
                stack.pop()
            end, chain, frames = stack[-1] if stack else (float("inf"), (), ())
            if r.kind == "runtime":
                launched[r.corr] = (r, chain)
                continue
            if r.kind == "python":
                stack.append((min(end, r.start + r.dur), chain, frames + (r.name,)))
                continue
            own = (r.ext,) + chain
            chains[r.ext] = (own, frames, r)
            stack.append((min(end, r.start + r.dur), own, frames))
    return chains, launched


def frames_from_tree(tree) -> Dict[int, Tuple[str, ...]]:
    """{op id (its External id): the Python frames around it, outermost
    first} from a session's event tree
    (`prof.profiler.kineto_results.experimental_event_tree()`), which holds
    the Python calls that the session's flat event list leaves out."""
    out: Dict[int, Tuple[str, ...]] = {}
    stack = [(root, ()) for root in tree]
    while stack:
        node, frames = stack.pop()
        tag = str(node.tag)
        if tag.endswith("PyCall"):
            frames = frames + (node.name,)
        elif tag.endswith("TorchOp"):
            out[node.correlation_id] = frames
        stack.extend((child, frames) for child in node.children)
    return out


def build(raw: List[_Raw], frames_by_op: Optional[Dict[int, Tuple[str, ...]]] = None) -> Trace:
    """The Trace of a session's raw events; `frames_by_op` (from
    `frames_from_tree`) gives the ops' Python frames where the raw events
    hold none."""
    chains, launched = _nest(raw)
    if frames_by_op:
        chains = {ext: (own, frames or frames_by_op.get(ext, ()), r) for ext, (own, frames, r) in chains.items()}
    forward = {(r.tid, r.seq): frames for _, frames, r in chains.values()
               if r.seq >= 0 and frames and not r.name.startswith(_BACKWARD)}
    ops = {}
    for ext, (own, frames, r) in chains.items():
        # the event tree gives an op on autograd's thread the frames of the
        # caller waiting in `backward` or `grad`: a backward op takes its
        # forward op's frames instead, and the ops inside it take none
        back = next((chains[i][2] for i in own if chains[i][2].name.startswith(_BACKWARD)), None)
        if back is not None:
            frames = forward.get((back.fwd_tid, back.seq), ()) if back is r else ()
        ops[ext] = Op(ext, r.name, r.dims, frames)
    records, seen, orphans = [], set(), 0
    intervals = defaultdict(list)
    for r in raw:
        if r.kind not in ("kernel", "memcpy", "memset"):
            continue
        seen.add(r.corr)
        hit = launched.get(r.corr)
        ids: tuple = ()
        if hit is None:
            orphans += 1
        else:
            call, nested = hit
            ids = chains[call.ext][0] if call.ext and call.ext in ops else nested
        records.append(Record(r.name, r.device, r.start, r.dur, tuple(ops[i] for i in ids if i in ops)))
        intervals[r.device].append((r.start, r.start + r.dur))
    calls = sorted((c for c, (r, _) in launched.items() if LAUNCH.match(r.name)), key=lambda c: launched[c][0].start)
    lost_at = tuple(i for i, c in enumerate(calls) if c not in seen)
    return Trace(records, len(calls), len(lost_at), lost_at, orphans, dict(intervals))


def union_us(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def gaps(intervals) -> List[Tuple[float, float]]:
    """(start, length) of each idle stretch between the union's pieces."""
    out, end = [], None
    for a, b in sorted(intervals):
        if end is not None and a > end:
            out.append((end, a - end))
        end = b if end is None else max(end, b)
    return out


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces of its own,
    template arguments and parameters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or name


def lead_primers(torch) -> None:
    """PRIMER_LEAD short spin kernels (~25 us each), waited for."""
    for _ in range(PRIMER_LEAD):
        torch.cuda._sleep(50_000)
    torch.cuda.synchronize()


def close_primer(torch) -> None:
    """One long spin kernel (~2.5 ms) at the session's end, waited for."""
    torch.cuda._sleep(5_000_000)
    torch.cuda.synchronize()


def without_primers(trace: Trace, lead: int = PRIMER_LEAD) -> Trace:
    """The trace without its primers' records, and without their launches
    (the first `lead` and the last) among the launches and the lost."""
    records = [r for r in trace.records if PRIMER_KERNEL not in r.name]
    intervals: dict = defaultdict(list)
    for r in records:
        intervals[r.device].append((r.start_us, r.start_us + r.dur_us))
    lost_at = tuple(i - lead for i in trace.lost_at if lead <= i < trace.launches - 1)
    return trace._replace(records=records, launches=max(trace.launches - lead - 1, 0), lost=len(lost_at),
                          lost_at=lost_at, intervals=dict(intervals))


def frames_of(record: Record) -> Tuple[str, ...]:
    """The Python frames behind a record: those of every op around its
    launch, innermost op first (a kernel that a Python autograd function's
    backward launches also gets the frames of the forward op behind it)."""
    return tuple(f for op in record.ops for f in op.frames)


def op_dims(record: Record, op_name: str) -> Optional[tuple]:
    """The input shapes of the op named `op_name` around the record's launch."""
    return next((op.dims for op in record.ops if op.name == op_name), None)
