"""The port's trace tools on the CPU: `utils/profiling.trace`, the reader
`utils/trace_events` and the two CLIs `parse_trace` and `roofline`, held
against the JAX package's `tools/parse_trace.py` and `tools/roofline.py`.

- A CPU profile of one TINY unroll step through `profiling.trace`: both
  tools find the z-buffer and codeword ops with their shapes; the live
  session and its exported file read alike; each `aten::convolution`'s
  FLOPs equal 2 N Cout Ho Wo (Cin / groups) kh kw at its recorded shapes.
- Parity with the JAX tools: one synthetic set of device events, written
  as an XProf trace (a process labelled TPU, `model_flops` and
  `bytes_accessed` in each event's args: the work this file computes by
  hand for each op) and as a Kineto Chrome trace of ops with the matching
  shapes, launches and kernels. The JAX tools, their peaks patched to the
  H100's, and the port's print the same totals, counts, ms/frame, order,
  bounds and gaps.
- Two streams that overlap: busy is the union of the intervals, kernel
  time their sum. A kernel record dropped: counted as lost, with its
  place, and busy and idle are not given. A launch without an External id
  tied to its op by nesting, under a Python frame whose exit the tracer
  missed.
- In a subprocess where jax and the JAX package cannot be imported, the
  new modules import, trace and print.
"""
import ast
import gzip
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sgam_neurips22_tpu_torch import parse_trace, roofline
from sgam_neurips22_tpu_torch.core.state_dict import load_into, random_state_dict
from sgam_neurips22_tpu_torch.models.vqgan.model import VQModel
from sgam_neurips22_tpu_torch.pipeline.scene_generation import InfiniteSceneGeneration, SceneGenConfig
from sgam_neurips22_tpu_torch.utils import profiling
from sgam_neurips22_tpu_torch.utils import trace_events as te
from torch_port_common import TINY, TINY_K, H, W, make_seed, port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L2 = 50 * 2**20  # the card's L2: the roofline's floor counts each call's bytes beyond it


def _jax_tool(name: str, **consts):
    """tools/<name>.py as a module, with its constants patched."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for k, v in consts.items():
        setattr(mod, k, v)
    return mod


def _run(main, argv, capsys, monkeypatch) -> list:
    monkeypatch.setattr(sys, "argv", ["tool", *argv])
    capsys.readouterr()
    main()
    return capsys.readouterr().out.splitlines()


# ------------------------------------------------------------ a TINY unroll step on the CPU
@pytest.fixture(scope="module")
def unroll_trace(tmp_path_factory):
    torch.manual_seed(0)
    model = VQModel(port_config(TINY))
    load_into(model, random_state_dict(model, 0))
    rgb, depth = make_seed()
    cfg = SceneGenConfig(output_dim=(2, 1), num_src=1, topk=1, image_resolution=(H, W))
    gen = InfiniteSceneGeneration(model.eval(), cfg, seeds=[((0, 0), rgb, depth)], intrinsics=TINY_K, device="cpu")
    gen.scene_expansion()
    root = tmp_path_factory.mktemp("unroll")
    gen.reset()
    with profiling.trace(str(root)):
        gen.scene_expansion()
    return root, te.from_file(te.newest(str(root)))


def _conv_flops(dims, concrete) -> float:
    (n, _, h, w), (cout, cin_g, kh, kw) = dims[0], dims[1]
    stride, padding, dilation = (ast.literal_eval(concrete[i]) for i in (3, 4, 5))
    ho = (h + 2 * padding[0] - dilation[0] * (kh - 1) - 1) // stride[0] + 1
    wo = (w + 2 * padding[1] - dilation[1] * (kw - 1) - 1) // stride[1] + 1
    return 2.0 * n * cout * ho * wo * cin_g * kh * kw


def test_unroll_step_through_profiling_trace(unroll_trace, capsys, monkeypatch):
    root, trace = unroll_trace
    assert trace.metadata["card"] == "cpu" and trace.metadata["matmul_precision"] == "float32"
    assert trace.launches == 0 and trace.lost == 0 and te.pick_device(trace) == "cpu"
    rows, _ = roofline.rows(trace, "cpu")
    by_op = {}
    for r in rows:
        by_op.setdefault(r.op, []).append(r)
    (zb,) = by_op["sgam::zbuffer_min"]
    (vq,) = by_op["sgam::nearest_codeword"]
    assert zb.dims == ((1, H * W), (1, H * W), (), ()) and zb.calls == 1
    latents = (H // 2) * (W // 2)  # TINY downsamples once
    assert vq.dims == ((latents, TINY.embed_dim), (TINY.n_embed, TINY.embed_dim)) and vq.calls == 1
    assert vq.work.flops == 2.0 * latents * TINY.n_embed * TINY.embed_dim
    assert zb.source.startswith("sgam_neurips22_tpu_torch/ops/zbuffer.py(")
    convs = by_op["aten::convolution"]
    assert len(convs) >= 5
    for r in convs:
        assert r.work.flops == r.calls * _conv_flops(r.dims, _concrete(trace, r))
    out = "\n".join(_run(parse_trace.main, [str(root), "--top", "400"], capsys, monkeypatch))
    assert f"sgam::zbuffer_min [[1, {H * W}], [1, {H * W}], [], []]" in out
    assert f"sgam::nearest_codeword [[{latents}, {TINY.embed_dim}], [{TINY.n_embed}, {TINY.embed_dim}]]" in out
    assert "# device cpu: kernel time" in out
    out = "\n".join(_run(roofline.main, [str(root), "--top", "400"], capsys, monkeypatch))
    assert f"sgam::nearest_codeword [[{latents}, {TINY.embed_dim}], [{TINY.n_embed}, {TINY.embed_dim}]]" in out
    assert "aten::convolution [[" in out and "matmul precision float32" in out


def _concrete(trace, row) -> tuple:
    """The scalar inputs of the row's first op call."""
    for r in trace.records:
        for op in r.ops:
            if op.name == row.op and op.dims == row.dims:
                return op.concrete
    raise AssertionError(row)


def test_live_session_reads_as_its_file(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    x, w = torch.randn(2, 4, 9, 9), torch.randn(6, 4, 3, 3)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True, with_stack=True) as prof:
        torch.nn.functional.conv2d(x, w, padding=1, stride=2)
        torch.ops.sgam.nearest_codeword(torch.randn(5, 3), torch.randn(7, 3))
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    live, file = te.from_profile(prof), te.from_file(str(tmp_path / "t.json"))

    def ops(trace):
        return sorted((r.name, tuple((o.name, o.dims) for o in r.ops)) for r in trace.records)

    assert ops(live) == ops(file) and len(live.records) > 5
    (conv,) = [r for r in roofline.rows(file, "cpu")[0] if r.op == "aten::convolution"]
    assert conv.work.flops == 2.0 * 2 * 6 * 5 * 5 * 4 * 3 * 3


# ------------------------------------------------------------ parity with the JAX tools
def _bytes(dims, itemsize):
    return int(np.prod(dims)) * itemsize


def _moved(read, written):
    return read + written


BF16, F32 = "c10::BFloat16", "float"
CONV = ["", "", "", "[1, 1]", "[1, 1]", "[1, 1]", "False", "[0, 0]", "1"]
# (op, input dims, input types, scalars, kernel, FLOPs a call, bytes a call, durations in us)
PARITY = {
    "bf16": (989e12, [
        ("aten::mm", [[8192, 4096], [4096, 8192]], [BF16, BF16], ["", ""], "sm90_gemm_bf16",
         2.0 * 8192 * 8192 * 4096, _moved(_bytes((8192, 4096), 2) * 2, _bytes((8192, 8192), 2)),
         [310.0, 305.5, 312.25]),
        ("aten::convolution", [[32, 256, 64, 64], [256, 256, 3, 3], [256], [], [], [], [], [], []],
         [BF16, BF16, BF16, "ScalarList", "ScalarList", "ScalarList", "Scalar", "ScalarList", "Scalar"], CONV,
         "sm90_fprop_bf16", 2.0 * 32 * 256 * 64 * 64 * 256 * 9,
         _moved(_bytes((32, 256, 64, 64), 2) + _bytes((256, 256, 3, 3), 2), _bytes((32, 256, 64, 64), 2)),
         [820.0, 805.0]),
        ("aten::add", [[8192, 8192], [8192, 8192], []], [BF16, BF16, "Scalar"], ["", "", "1"], "add_kernel_bf16",
         0.0, _moved(2 * _bytes((8192, 8192), 2), _bytes((8192, 8192), 2)), [140.0, 141.5, 139.0, 150.0]),
        ("aten::copy_", [[8192, 8192], [8192, 8192], []], [BF16, F32, "Scalar"], ["", "", "False"], "copy_kernel",
         0.0, _moved(_bytes((8192, 8192), 4), _bytes((8192, 8192), 2)), [60.0]),
    ]),
    "hand": (67e12, [
        ("sgam::nearest_codeword", [[4096, 256], [16384, 256]], [F32, F32], ["", ""], "search_kernel",
         2.0 * 4096 * 16384 * 256, _moved(4 * (4096 * 256 + 16384 * 256), 8 * 4096), [580.0, 575.0]),
        ("sgam::flash_attention_fwd", [[16, 4096, 256]] * 3, [F32] * 3, [""] * 3, "flash_fwd_kernel",
         4.0 * 16 * 4096**2 * 256, _moved(12 * 16 * 4096 * 256, 4 * (16 * 4096 * 256 + 16 * 4096)), [5050.0]),
        ("sgam::flash_attention_dkv", [[16, 4096, 256]] * 4 + [[16, 4096]] * 2, [F32] * 6, [""] * 6,
         "flash_dkv_kernel", 8.0 * 16 * 4096**2 * 256,
         _moved(4 * (4 * 16 * 4096 * 256 + 2 * 16 * 4096), 8 * 16 * 4096 * 256), [10500.0, 10480.0]),
        ("sgam::zbuffer_min", [[16, 131072], [16, 131072], [], []], ["int", "int", "Scalar", "Scalar"],
         ["", "", "256", "256"], "zbuffer_tile_kernel", 0.0, _moved(8 * 16 * 131072, 4 * 16 * 256 * 256),
         [12.5, 12.7, 13.0]),
        ("sgam::grid_accumulate", [[265757184], [8388608], [8388608]], [F32, "int", F32], ["", "", ""], "ga_walk",
         8388608.0, _moved(8 * 8388608, 0), [585.0]),
    ]),
}


def _parity_traces(root, case, ops=None):
    """The case's events (or `ops`, as PARITY's) as an XProf trace under
    root/xprof and a Kineto Chrome trace under root/kineto."""
    ops = PARITY[case][1] if ops is None else ops
    xprof = [{"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "/device:TPU:0"}},
             {"ph": "M", "name": "process_name", "pid": 2, "args": {"name": "/host:CPU"}}]
    kineto, t, ext = [], 1000.0, 0
    for name, dims, types, concrete, kernel, flops, moved, durs in ops:
        for dur in durs:
            ext += 1
            xprof.append({"ph": "X", "pid": 1, "tid": 1, "name": kernel, "ts": t + 5, "dur": dur,
                          "args": {"model_flops": int(flops), "bytes_accessed": int(moved), "source": "model.py:1"}})
            kineto += [
                {"ph": "X", "cat": "cpu_op", "name": name, "pid": 9, "tid": 9, "ts": t, "dur": 4.0,
                 "args": {"External id": ext, "Input Dims": dims, "Input type": types, "Concrete Inputs": concrete}},
                {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 9, "tid": 9, "ts": t + 1,
                 "dur": 2.0, "args": {"External id": ext, "correlation": 100 + ext}},
                {"ph": "X", "cat": "kernel", "name": kernel, "pid": 0, "tid": 7, "ts": t + 5, "dur": dur,
                 "args": {"External id": ext, "device": 0, "stream": 7, "correlation": 100 + ext}}]
            t += dur + 10.0
    os.makedirs(root / "xprof" / "plugins" / "profile" / "run")
    with gzip.open(root / "xprof" / "plugins" / "profile" / "run" / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": xprof}, f)
    os.makedirs(root / "kineto")
    with open(root / "kineto" / "trace.json", "w") as f:
        json.dump({"matmul_precision": "float32", "card": "synthetic", "traceEvents": kineto}, f)


@pytest.mark.parametrize("case", sorted(PARITY))
def test_tools_match_the_jax_tools(tmp_path, case, capsys, monkeypatch):
    peak, ops = PARITY[case]
    _parity_traces(tmp_path, case)
    frames = ["--frames", "4"]
    jax_parse = _jax_tool("parse_trace")
    theirs = _run(jax_parse.main, [str(tmp_path / "xprof"), *frames], capsys, monkeypatch)
    ours = _run(parse_trace.main, [str(tmp_path / "kineto"), *frames], capsys, monkeypatch)
    t_rows = [ln for ln in theirs if not ln.startswith("#")][1:]
    o_rows = [ln for ln in ours if not ln.startswith("#")][1:]
    assert len(t_rows) == len(o_rows) == len(ops)
    for a, b in zip(t_rows, o_rows):  # total ms, %, count, avg us, ms/frame, name
        assert a.split()[:6] == b.split()[:6]
    total = sum(sum(durs) for *_, durs in ops) / 1e3
    assert f"# device total: {total:.2f} ms over {sum(len(d) for *_, d in ops)} events" in theirs
    assert f"kernel time {total:.2f} ms over {sum(len(d) for *_, d in ops)} records" in ours[1]

    jax_roof = _jax_tool("roofline", PEAK_FLOPS=peak, PEAK_BW=te.HBM_BYTES_PER_S)
    theirs = _run(jax_roof.main, [str(tmp_path / "xprof"), *frames], capsys, monkeypatch)
    ours = _run(roofline.main, [str(tmp_path / "kineto"), *frames], capsys, monkeypatch)
    assert ours[1].startswith(theirs[1])  # kernel time, bound, headroom
    t_rows, o_rows = theirs[3:], ours[3:]
    kernel_of = {name: kernel for name, _, _, _, kernel, *_ in ops}
    assert len(t_rows) == len(o_rows) == len(ops)
    for a, b in zip(t_rows, o_rows):  # total, bound, gap, bw%, mxu%, ms/frame, count; the port adds 3xTF32
        assert a.split()[:7] == b.split()[:7]
        assert a.split()[7] == kernel_of[b.split()[8]]


def test_rows_under_their_bound_are_marked(tmp_path, capsys, monkeypatch):
    """A row faster than its bytes over the HBM rate is marked L2 where the
    bytes beyond the L2's size still bound it (its operands in the L2), and
    UNDER FLOOR where they do not (a wrong model or trace); the header
    counts both."""
    small, big = _bytes((1024, 1024), 2), _bytes((8192, 8192), 2)
    assert 3 * small < L2 < 3 * big
    bound_us, floor_us = 3 * big / te.HBM_BYTES_PER_S * 1e6, (3 * big - L2) / te.HBM_BYTES_PER_S * 1e6
    ops = [(f"aten::{name}", [list(dims)] * 2 + [[]], [BF16, BF16, "Scalar"], ["", "", "1"], f"{name}_kernel", 0.0,
            3 * _bytes(dims, 2), [us]) for name, dims, us in (
        ("add", (1024, 1024), 1.0),  # under the bound of 1.88 us; no floor: it fits the L2
        ("sub", (8192, 8192), (bound_us + floor_us) / 2),
        ("mul", (8192, 8192), floor_us / 2),
        ("div", (8192, 8192), bound_us * 2))]
    _parity_traces(tmp_path, None, ops)
    out = _run(roofline.main, [str(tmp_path / "kineto")], capsys, monkeypatch)
    assert "rows under their bound: 2 L2, 1 UNDER FLOOR;" in out[1]
    marks = {ln.split()[7]: ln.split("]")[-1].strip() for ln in out[3:]}
    assert marks == {"aten::add": "L2", "aten::sub": "L2", "aten::mul": "UNDER FLOOR", "aten::div": ""}
    rows = {r.op: r for r in roofline.rows(te.from_file(te.newest(str(tmp_path / "kineto"))), 0)[0]}
    assert rows["aten::add"].l2_floor_s == 0.0 and rows["aten::sub"].bound_s == pytest.approx(bound_us / 1e6)


# ------------------------------------------------------------ busy, lost records, nesting
def _stream_trace(path, drop=None, python_frame=False):
    """Three kernels, two of them on streams 7 and 13 overlapping by 50 us,
    each launched from its own op; `drop` leaves out one kernel record."""
    events = []
    kernels = [(7, 100.0, 100.0), (13, 150.0, 100.0), (7, 300.0, 50.0)]
    for i, (stream, ts, dur) in enumerate(kernels):
        ext = i + 1
        events += [
            {"ph": "X", "cat": "cpu_op", "name": f"aten::op{i}", "pid": 9, "tid": 9, "ts": 10.0 * i, "dur": 5.0,
             "args": {"External id": ext, "Input Dims": [[4]], "Input type": ["float"]}},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 9, "tid": 9, "ts": 10.0 * i + 1,
             "dur": 2.0, "args": {"External id": 0 if (python_frame and i == 2) else ext, "correlation": 50 + i}}]
        if i != drop:
            events.append({"ph": "X", "cat": "kernel", "name": f"k{i}", "pid": 0, "tid": stream, "ts": ts,
                           "dur": dur, "args": {"device": 0, "stream": stream, "correlation": 50 + i}})
    if python_frame:  # a frame of the port around op 2 whose exit the tracer missed: it runs to the end
        events.append({"ph": "X", "cat": "python_function", "pid": 9, "tid": 9, "ts": 19.0, "dur": 1000.0,
                       "name": "sgam_neurips22_tpu_torch/ops/vq.py(47): nearest_codeword"})
        events.append({"ph": "X", "cat": "python_function", "pid": 9, "tid": 9, "ts": 12.0, "dur": 1000.0,
                       "name": "<built-in method redispatch_boxed of PyCapsule object at 0x0>"})
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    return te.from_file(str(path))


def test_busy_is_the_union_of_overlapping_streams(tmp_path, capsys, monkeypatch):
    trace = _stream_trace(tmp_path / "t.json")
    assert (trace.launches, trace.lost, trace.orphans) == (3, 0, 0)
    assert te.kernel_us(trace, 0) == 250.0
    assert te.busy_us(trace, 0) == 200.0  # [100, 250] and [300, 350]
    assert trace.wall_us == 350.0
    assert te.idle_share(trace, device=0) == pytest.approx(1 - 200 / 350)
    assert te.idle_share(trace, wall_us=400.0, device=0) == 0.5
    assert [r.link for r in trace.records] == ["External id"] * 3
    out = _run(parse_trace.main, [str(tmp_path)], capsys, monkeypatch)
    assert "kernel time 0.25 ms over 3 records; busy (union) 0.20 ms; idle share 0.429 of 0.35 ms" in out[1]


def test_a_dropped_record_is_counted_and_busy_is_not_given(tmp_path, capsys, monkeypatch):
    trace = _stream_trace(tmp_path / "t.json", drop=1)
    assert (trace.launches, trace.lost, trace.lost_at) == (3, 1, (1,))
    assert te.kernel_us(trace, 0) == 150.0
    assert te.busy_us(trace, 0) is None and te.idle_share(trace, device=0) is None
    out = _run(parse_trace.main, [str(tmp_path)], capsys, monkeypatch)
    assert "busy (union) not given (lost launches); idle share not given" in out[1]
    assert "lost launches 1 of 3" in out[1]
    out = _run(roofline.main, [str(tmp_path)], capsys, monkeypatch)
    assert out[1].endswith("lost launches 1 of 3")


def test_a_launch_without_external_id_is_nested_in_its_op(tmp_path):
    trace = _stream_trace(tmp_path / "t.json", python_frame=True)
    links = [(r.name, r.link, r.op.name, r.op.source) for r in trace.records]
    assert links[:2] == [("k0", "External id", "aten::op0", ""), ("k1", "External id", "aten::op1", "")]
    assert links[2] == ("k2", "nesting", "aten::op2", "sgam_neurips22_tpu_torch/ops/vq.py(47): nearest_codeword")


def test_a_primed_trace_drops_its_primers(tmp_path):
    """A trace that utils/profiling.trace primed (metadata "primed"): its
    PRIMER_LEAD leading and one trailing spin kernels leave the records,
    and only the work's lost launches count, at their places among the
    work's launches."""
    events, t = [], 0.0
    launches = ([te.PRIMER_KERNEL] * te.PRIMER_LEAD + ["k0", "k1", "k2"] + [te.PRIMER_KERNEL])
    dropped = {1, te.PRIMER_LEAD + 1, len(launches) - 1}  # a leading primer, work kernel k1, the trailing primer
    for i, name in enumerate(launches):
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 9, "tid": 9, "ts": t,
                       "dur": 1.0, "args": {"correlation": 10 + i}})
        if i not in dropped:
            events.append({"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": 7, "ts": t + 2, "dur": 3.0,
                           "args": {"device": 0, "stream": 7, "correlation": 10 + i}})
        t += 10.0
    with open(tmp_path / "t.json", "w") as f:
        json.dump({"primed": "true", "traceEvents": events}, f)
    trace = te.from_file(str(tmp_path / "t.json"))
    assert [r.name for r in trace.records] == ["k0", "k2"]
    assert (trace.launches, trace.lost, trace.lost_at) == (3, 1, (1,))
    assert te.busy_us(trace) is None and te.kernel_us(trace) == 6.0


@pytest.mark.parametrize("tool", [parse_trace, roofline])
def test_no_trace_exits_as_the_jax_tools_do(tmp_path, tool):
    with pytest.raises(SystemExit, match="no \\*.json or \\*.json.gz trace under"):
        tool.main([str(tmp_path)])


# ------------------------------------------------------------ no JAX
BLOCKED_SIDE = """
import sys
for name in ("jax", "jaxlib", "sgam_neurips22_tpu", "chip_smoke"):
    sys.modules[name] = None
import torch
from sgam_neurips22_tpu_torch import parse_trace, roofline
from sgam_neurips22_tpu_torch.studies import cases, trace_loss
from sgam_neurips22_tpu_torch.utils import profiling, trace_events
with profiling.trace(sys.argv[1]):
    torch.nn.functional.conv2d(torch.ones(1, 2, 5, 5), torch.ones(3, 2, 3, 3))
parse_trace.main([sys.argv[1]])
roofline.main([sys.argv[1]])
print("IMPORTED", [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "sgam_neurips22_tpu", "chip_smoke")
                   and sys.modules[m] is not None])
"""


def test_modules_import_no_jax(tmp_path):
    r = subprocess.run([sys.executable, "-c", BLOCKED_SIDE, str(tmp_path)], cwd=REPO, capture_output=True,
                       text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "IMPORTED []" in r.stdout and "aten::convolution [[1, 2, 5, 5], [3, 2, 3, 3]" in r.stdout
