"""Roofline of a torch profiler trace: each op's device time against the
least time its work needs on the card. The counterpart of
`tools/roofline.py`, which reads XProf's trace.

    python -m sgam_neurips22_tpu_torch.roofline DIR [--frames N] [--top 30] [--min_ms X] [--device 0]

DIR holds Chrome traces written by `utils/profiling.trace`; the newest is
read (`utils/trace_events`). XLA attaches `model_flops` and
`bytes_accessed` to every device event; a torch trace carries neither, so
the work comes from a model of the op that launched the device records,
from the input shapes, types and scalars the trace recorded
(`record_shapes`). Rows are groups of (op, shapes): an op's bound reads the
same work whatever implements it, a hand kernel, its plain version or a
library call.

    bound = max(bytes / HBM bandwidth, FLOPs / the peak of the op's type)

summed over the group's calls, a call's bytes being those it reads and
writes (each input read once, each output written once). Peaks
(`utils/trace_events`): NVIDIA's H100 SXM5 data sheet, dense, at the
card's 700 W power limit: 3.35 TB/s, 67 TFLOP/s f32, 495 TFLOP/s TF32, 989
TFLOP/s bf16 and fp16. An f32 matmul or convolution takes the TF32 peak
where the trace's matmul precision mode (`core.device`, in its metadata)
turns TF32 on, or does not say.

A row can take less than its bound where its operands sat in the 50 MiB
L2 (its producer had just written them), which has no published bandwidth
to bound it by. Such a row is marked `L2` where its time still reaches the
L2 floor (`l2_floor_s`: each call's bytes beyond the L2's size over the
HBM bandwidth, or its FLOPs over the peak) and `UNDER FLOOR` where it does
not: there the work model or the trace is wrong. The work model (`work`):

- convolutions (`aten::convolution`, 2D, not transposed; the cuDNN or
  oneDNN op under it groups with it): 2 N Cout Ho Wo (Cin / groups) kh kw
  FLOPs, bytes of input + weight + output; `aten::convolution_backward`,
  that per gradient its output_mask asks for, bytes of grad_output, input,
  weight and each gradient;
- `aten::mm`, `addmm`, `bmm`, `baddbmm`: 2 M N K FLOPs (times the batch),
  bytes of the inputs and the output;
- the port's six hand ops (`torch.ops.sgam`), the FLOPs and bytes of
  chip_smoke's bounds and PERF.md's table, at the f32 rate of the CUDA
  cores, with the 3xTF32 bound beside it (three TF32 products a product);
  grid_accumulate's bytes count its samples and one read and write of each
  voxel it touches, which a trace does not hold: there they count the
  samples alone, a lower bound;
- elementwise ops (`ELEMENTWISE`) whose tensor inputs share one shape, as
  their output does: bytes of the inputs plus the output, no FLOPs.

Every other op has no model: its time is summed apart and no bound is made
up for it. The gap (time - bound) ranks where time is recoverable. As in
the JAX tool, gathers and scatters (the z-buffer merge, the grid
accumulation) touch their operands sparsely: their byte bound counts each
element once, which only a resident operand reaches; the serial issue of
their atomics or passes is the real floor there.
"""
from __future__ import annotations

import argparse
import ast
import math
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

from sgam_neurips22_tpu_torch.utils import trace_events as te

ITEMSIZE = {"float": 4, "c10::BFloat16": 2, "c10::Half": 2, "double": 8, "int": 4, "long int": 8,
            "short int": 2, "signed char": 1, "unsigned char": 1, "bool": 1, "c10::complex<float>": 8}
SCALAR_TYPES = {0: "unsigned char", 1: "signed char", 2: "short int", 3: "int", 4: "long int", 5: "c10::Half",
                6: "float", 7: "double", 11: "bool", 15: "c10::BFloat16"}  # c10::ScalarType codes
TF32_MODES = ("default", "bfloat16")  # core.device's modes that run f32 matmuls and convolutions in TF32
HAND_OPS = ("sgam::zbuffer_min", "sgam::nearest_codeword", "sgam::flash_attention_fwd", "sgam::flash_attention_dq",
            "sgam::flash_attention_dkv", "sgam::grid_accumulate")
_UNARY = ("abs", "neg", "exp", "log", "sqrt", "rsqrt", "reciprocal", "sigmoid", "silu", "relu", "tanh", "gelu",
          "sign", "floor", "ceil", "round", "clamp", "clamp_min", "clamp_max", "leaky_relu", "hardtanh")
_BINARY = ("add", "sub", "mul", "div", "maximum", "minimum", "pow", "where", "lerp", "addcmul", "addcdiv",
           "threshold_backward", "silu_backward", "sigmoid_backward", "tanh_backward", "gelu_backward")
ELEMENTWISE = frozenset([f"aten::{n}" for n in _UNARY + _BINARY] + [f"aten::{n}_" for n in _UNARY + _BINARY]
                        + ["aten::copy_", "aten::_to_copy", "aten::fill_", "aten::zero_"])


class Work(NamedTuple):
    flops: float
    read: float  # bytes of the inputs, each read once
    written: float  # bytes of the outputs, each written once
    dtype: str  # the arithmetic's input type ("float", "c10::BFloat16", ...)
    hand: bool  # one of HAND_OPS: bound at the f32 rate of the CUDA cores, and a 3xTF32 column

    @property
    def bytes(self) -> float:
        return self.read + self.written


def _tensors(op: te.Op) -> List[tuple]:
    """(dims, type) of each tensor input (a 0-d tensor has dims ())."""
    return [(tuple(d), t) for d, t in zip(op.dims, op.types) if t in ITEMSIZE]


def _numel(dims) -> int:
    return math.prod(dims) if dims else 1


def _nbytes(dims, dtype: str) -> int:
    return _numel(dims) * ITEMSIZE[dtype]


def _scalar(op: te.Op, i: int):
    """The op's i-th scalar input, parsed ('[1, 1]' -> [1, 1], 'False' ->
    False), or None."""
    if i >= len(op.concrete) or op.concrete[i] in ("", None):
        return None
    try:
        return ast.literal_eval(str(op.concrete[i]))
    except (ValueError, SyntaxError):
        return None


def _conv_out(op: te.Op, first: int):
    """(N, Cout, Ho, Wo, Cin / groups, kh, kw) of a 2D convolution whose
    input and weight are the op's first two tensor inputs and whose stride,
    padding, dilation, transposed and groups follow at `first`; None where
    it is not a plain 2D convolution or a scalar is missing."""
    (x, _), (w, _) = _tensors(op)[:2]
    stride, padding, dilation, transposed = (_scalar(op, first + i) for i in range(4))
    groups = _scalar(op, first + 5)
    if len(x) != 4 or len(w) != 4 or transposed is not False or None in (stride, padding, dilation, groups):
        return None
    n, _, h, wd = x
    cout, cin_g, kh, kw = w
    ho = (h + 2 * padding[0] - dilation[0] * (kh - 1) - 1) // stride[0] + 1
    wo = (wd + 2 * padding[1] - dilation[1] * (kw - 1) - 1) // stride[1] + 1
    return n, cout, ho, wo, cin_g, kh, kw


def _conv(op: te.Op) -> Optional[Work]:
    shape = _conv_out(op, 3)  # (input, weight, bias, stride, padding, dilation, transposed, output_padding, groups)
    if shape is None:
        return None
    n, cout, ho, wo, cin_g, kh, kw = shape
    (x, dt), (w, _) = _tensors(op)[:2]
    return Work(2.0 * n * cout * ho * wo * cin_g * kh * kw,
                _nbytes(x, dt) + _nbytes(w, dt), _nbytes((n, cout, ho, wo), dt), dt, False)


def _conv_backward(op: te.Op) -> Optional[Work]:
    # (grad_output, input, weight, bias_sizes, stride, padding, dilation, transposed, output_padding, groups, mask)
    ts = _tensors(op)
    mask = _scalar(op, 10)
    if len(ts) < 3 or not isinstance(mask, list):
        return None
    (g, dt), (x, _), (w, _) = ts[:3]
    shape = _conv_out(te.Op(op.id, op.name, op.dims[1:], op.types[1:], op.concrete[1:], ""), 3)
    if shape is None:
        return None
    n, cout, ho, wo, cin_g, kh, kw = shape
    grads = int(bool(mask[0])) + int(bool(mask[1]))
    out = (_nbytes(x, dt) if mask[0] else 0) + (_nbytes(w, dt) if mask[1] else 0)
    return Work(grads * 2.0 * n * cout * ho * wo * cin_g * kh * kw,
                _nbytes(g, dt) + _nbytes(x, dt) + _nbytes(w, dt), out, dt, False)


def _matmul(op: te.Op) -> Optional[Work]:
    ts = _tensors(op)
    if op.name in ("aten::addmm", "aten::baddbmm"):
        bias, ts = ts[0], ts[1:]
    else:
        bias = None
    if len(ts) < 2:
        return None
    (a, dt), (b, _) = ts[:2]
    batched = op.name in ("aten::bmm", "aten::baddbmm")
    if len(a) != 2 + batched or len(b) != 2 + batched:
        return None
    m, k = a[-2:]
    n = b[-1]
    lead = a[:-2]
    out = (*lead, m, n)
    read = _nbytes(a, dt) + _nbytes(b, dt) + (_nbytes(*bias) if bias else 0)
    return Work(2.0 * _numel(lead) * m * n * k, read, _nbytes(out, dt), dt, False)


def hand_work(name: str, dims, concrete=(), touched: int = 0) -> Optional[Work]:
    """The work of one call of a hand op from its inputs' shapes: the
    FLOPs and bytes its bound in chip_smoke and PERF.md counts. `touched`
    (grid_accumulate's voxels touched, which depend on the data) is 0 where
    unknown."""
    if name == "sgam::zbuffer_min":  # each point's pix and key read once, the image written once
        (b, p), h, w = dims[0], int(concrete[2]), int(concrete[3])
        return Work(0.0, 2 * 4 * b * p, 4 * b * h * w, "int", True)
    if name == "sgam::nearest_codeword":  # the latents and the codebook read, an index and a distance written
        (p, d), (k, _) = dims[0], dims[1]
        return Work(2.0 * p * k * d, 4 * (p * d + k * d), 8 * p, "float", True)
    if name in ("sgam::flash_attention_fwd", "sgam::flash_attention_dq", "sgam::flash_attention_dkv"):
        b, s, c = dims[0]
        if name == "sgam::flash_attention_fwd":  # q k v read, out and lse written; Q K^T and P V
            return Work(4.0 * b * s * s * c, 4 * 3 * b * s * c, 4 * (b * s * c + b * s), "float", True)
        n_out, products = (1, 3) if name == "sgam::flash_attention_dq" else (2, 4)  # q k v dout lse dd read
        return Work(2.0 * products * b * s * s * c, 4 * (4 * b * s * c + 2 * b * s), 4 * n_out * b * s * c,
                    "float", True)
    if name == "sgam::grid_accumulate":  # each sample's id and value read, each touched voxel read and written
        (n,) = dims[1]
        return Work(float(n), 8 * n + 4 * touched, 4 * touched, "float", True)
    return None


def _elementwise(op: te.Op) -> Optional[Work]:
    ts = _tensors(op)
    if not ts or len({d for d, _ in ts}) != 1:
        return None
    dims, dt = ts[0]
    if op.name in ("aten::fill_", "aten::zero_"):  # written only
        return Work(0.0, 0.0, _nbytes(dims, dt), dt, False)
    if op.name == "aten::copy_":  # src read, self written
        return Work(0.0, _nbytes(dims, ts[1][1] if len(ts) > 1 else dt), _nbytes(dims, dt), dt, False)
    out = dt
    if op.name == "aten::_to_copy":
        code = _scalar(op, 1)
        out = SCALAR_TYPES.get(code, dt) if isinstance(code, int) else dt
    return Work(0.0, sum(_nbytes(d, t) for d, t in ts), _nbytes(dims, out), dt, False)


def work(op: te.Op) -> Optional[Work]:
    """The modelled work of one call of `op`, or None (no model)."""
    try:
        if op.name in HAND_OPS:
            return hand_work(op.name, op.dims, op.concrete)
        if op.name == "aten::convolution":
            return _conv(op)
        if op.name == "aten::convolution_backward":
            return _conv_backward(op)
        if op.name in ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm"):
            return _matmul(op)
        if op.name in ELEMENTWISE:
            return _elementwise(op)
    except (IndexError, TypeError, ValueError, KeyError):
        return None
    return None


def flop_peak(w: Work, precision: Optional[str]) -> float:
    """The card's peak for the work's arithmetic: bf16 / fp16 on the
    tensor cores; f32 at TF32's where the precision mode turns it on or
    is unknown, else on the CUDA cores (the hand ops always there)."""
    if w.dtype in ("c10::BFloat16", "c10::Half"):
        return te.BF16_FLOP_PER_S
    if not w.hand and (precision is None or precision in TF32_MODES):
        return te.TF32_FLOP_PER_S
    return te.F32_FLOP_PER_S


def bound_parts(w: Work, precision: Optional[str]) -> tuple:
    """(seconds of one call's bytes over the HBM bandwidth, seconds of its
    FLOPs over the peak of their type)."""
    return w.bytes / te.HBM_BYTES_PER_S, (w.flops / flop_peak(w, precision) if w.flops else 0.0)


def bound_s(w: Work, precision: Optional[str]) -> float:
    """The least time one call's work needs: its bytes over the HBM
    bandwidth, or its FLOPs over the peak of their type."""
    return max(bound_parts(w, precision))


def l2_floor_s(w: Work, precision: Optional[str]) -> float:
    """The least time one call's work needs even where as much of its
    operands as the L2 holds is served from there: its bytes beyond the
    L2's size over the HBM bandwidth, or its FLOPs over the peak."""
    return max(max(0.0, w.bytes - te.L2_BYTES) / te.HBM_BYTES_PER_S, bound_parts(w, precision)[1])


def tc_bound_s(w: Work) -> Optional[float]:
    """A hand op's bound on the tensor cores: three TF32 products a product
    (3xTF32); None for other ops."""
    return 3 * w.flops / te.TF32_FLOP_PER_S if w.hand else None


class Row(NamedTuple):
    op: str
    dims: tuple
    types: tuple
    calls: int
    time_s: float
    work: Work  # summed over the calls
    bound_s: float
    l2_floor_s: float
    tc_bound_s: Optional[float]  # hand ops: three TF32 products a product
    source: str

    @property
    def under(self) -> str:
        """"" where the time reaches the bound; "L2" where it is under the
        bound but reaches the L2 floor (operands served from the L2);
        "UNDER FLOOR" where it is under both (a wrong work model or trace)."""
        if self.time_s >= self.bound_s:
            return ""
        return "L2" if self.time_s >= self.l2_floor_s else "UNDER FLOOR"


def _owner(r: te.Record):
    """The outermost op around a record's launch that has a work model
    (a convolution's cuDNN calls group with it, a hand op's fills with the
    hand op), or None."""
    for op in reversed(r.ops):
        if work(op) is not None:
            return op
    return None


def rows(trace: te.Trace, device=None) -> tuple:
    """([Row] of the modelled groups, largest gap first; {innermost op:
    [seconds, records]} of the records without a model), over one device's
    records (every device's where None)."""
    precision = trace.metadata.get("matmul_precision")
    groups: Dict[tuple, dict] = {}
    unmodelled: Dict[str, list] = defaultdict(lambda: [0.0, 0])
    for r in trace.records:
        if device is not None and r.device != device:
            continue
        op = _owner(r)
        if op is None:
            row = unmodelled[r.op.name if r.op else f"(no op) {te.short_name(r.name)}"]
            row[0] += r.dur_us
            row[1] += 1
            continue
        g = groups.setdefault((op.name, op.dims, op.types, op.concrete), {"us": 0.0, "ops": {}, "src": op.source})
        g["us"] += r.dur_us
        g["ops"][op.id] = op
    out = []
    for (name, dims, types, _), g in groups.items():
        ws = [work(op) for op in g["ops"].values()]
        total = Work(sum(w.flops for w in ws), sum(w.read for w in ws), sum(w.written for w in ws), ws[0].dtype,
                     ws[0].hand)
        out.append(Row(name, dims, types, len(ws), g["us"] / 1e6, total, sum(bound_s(w, precision) for w in ws),
                       sum(l2_floor_s(w, precision) for w in ws), tc_bound_s(total), g["src"]))
    out.sort(key=lambda r: r.time_s - r.bound_s, reverse=True)
    return out, {name: (us / 1e6, n) for name, (us, n) in unmodelled.items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("profile_dir")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--frames", type=int, default=None, help="divide totals by N for per-frame columns")
    ap.add_argument("--min_ms", type=float, default=0.0, help="hide op groups below this total time")
    ap.add_argument("--device", default=None, help="the card's index, or cpu (default: the first in the trace)")
    args = ap.parse_args(argv)

    path = te.newest(args.profile_dir)
    print(f"# {path}")
    report(te.from_file(path), args.top, args.frames, args.min_ms, args.device)


def report(trace: te.Trace, top: int = 30, frames=None, min_ms: float = 0.0, device=None) -> None:
    """Print the header, the modelled rows by gap and the rows without a
    model of one device of the trace."""
    device = te.pick_device(trace, device)
    table, unmodelled = rows(trace, device)
    tot_t = sum(r.time_s for r in table)
    tot_bound = sum(r.bound_s for r in table)
    other = sum(t for t, _ in unmodelled.values())
    print(f"# device kernel time {tot_t * 1e3:.1f} ms; roofline bound {tot_bound * 1e3:.1f} ms; "
          f"headroom {100 * (1 - tot_bound / max(tot_t, 1e-12)):.0f}%; no model {other * 1e3:.1f} ms over "
          f"{sum(n for _, n in unmodelled.values())} records; device {device}; "
          f"matmul precision {trace.metadata.get('matmul_precision', 'not recorded')}; "
          f"card {trace.metadata.get('card', 'not recorded')}; rows under their bound: "
          f"{sum(r.under == 'L2' for r in table)} L2, {sum(r.under == 'UNDER FLOOR' for r in table)} UNDER FLOOR; "
          f"lost launches {trace.lost} of {trace.launches}")
    per = f" {'ms/frame':>9}" if frames else ""
    print(f"{'total ms':>9} {'bound ms':>9} {'gap ms':>8} {'bw%':>5} {'mxu%':>5}{per}  {'count':>6}  "
          f"{'3xTF32 ms':>9}  op [shapes] [source] [under its bound]")
    for r in table[:top]:
        if r.time_s * 1e3 < min_ms:
            continue
        t = max(r.time_s, 1e-12)
        bw = 100 * (r.work.bytes / te.HBM_BYTES_PER_S) / t
        mxu = 100 * (r.work.flops / flop_peak(r.work, trace.metadata.get("matmul_precision"))) / t
        per_col = f" {r.time_s * 1e3 / frames:9.3f}" if frames else ""
        tc = f"{r.tc_bound_s * 1e3:9.3f}" if r.tc_bound_s is not None else f"{'-':>9}"
        print(f"{r.time_s * 1e3:9.2f} {r.bound_s * 1e3:9.2f} {(r.time_s - r.bound_s) * 1e3:8.2f} "
              f"{bw:5.1f} {mxu:5.1f}{per_col}  {r.calls:6d}  {tc}  {r.op} {list(map(list, r.dims))} [{r.source}]"
              + (f" {r.under}" if r.under else ""))
    if unmodelled:
        print("# no model (time not bounded):")
        for name, (t, n) in sorted(unmodelled.items(), key=lambda kv: -kv[1][0])[:top]:
            per_col = f" {t * 1e3 / frames:9.3f}" if frames else ""
            print(f"{t * 1e3:9.2f}{per_col}  {n:6d}  {name}")


if __name__ == "__main__":
    main()
