"""The harness on the CPU: discovery by name, the result line, the trace
arithmetic, the work counts, the frozen reference against the port at a
tiny size, the planted faults, and the import check."""
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import faults, run, trace as tr, work
from portbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_names_and_files():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]] + [c["name"] for c in b["configs"]] + [
        w["name"] for w in b["workloads"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in b["end_to_end"] + b["per_layer"])
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for c in b["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert sorted(cfg["reduced"]) == sorted(c["reduced"]) and cfg["source"] == c["source"]
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("workload", tiny.CELLS)
def test_discovery_by_name(workload):
    s = run.load_spec(workload)
    assert s["traffic"]["kind"] in ("unroll", "train") and s["limits"]
    assert s["per_layer"] and {m["name"] for m in s["end_to_end"]} >= {"setup_s"}
    for m in s["per_layer"]:
        assert callable(run.reader(m["name"]))
        assert m["moves"] in {e["name"] for e in s["end_to_end"]}


@pytest.mark.parametrize("workload", tiny.CELLS)
def test_result_line_and_reference_agree(workload):
    """A float32 program at a tiny size against the float32 reference: the
    result's keys, `checks` last, and readings at f32 rounding."""
    res = tiny.cpu_run(workload)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"] and list(res)[-1] == "checks"
    assert res["correct"] and res["attempted"] >= 1
    assert set(res["metrics"]) == {m["name"] for m in run.load_spec(workload)["end_to_end"]}
    assert all(c["value"] < 1e-4 for c in res["checks"].values()), res["checks"]


@pytest.mark.parametrize("workload,fault", [("clevr.unroll_splat.b8", "altered_frame"),
                                            ("google_earth.unroll_map.b8", "altered_frame"),
                                            ("clevr.train.b16", "half_batch"), ("clevr.train.b16", "half_batch_loss"),
                                            ("clevr.train.b16", "unchanged")])
def test_planted_fault_fails(workload, fault):
    res = tiny.cpu_run(workload, faults.FAULTS[fault])
    assert not res["correct"], res["checks"]


def _raw(kind, name, start, dur, corr=0, ext=0, tid=1, seq=-1, fwd_tid=None, dims=()):
    return tr._Raw(kind, name, tid, start, dur, corr, ext, 0 if kind == "kernel" else None, dims, seq, fwd_tid)


def test_trace_links_frames_backward_and_lost_launches():
    raw = [
        _raw("python", "pkg/sgam_neurips22_tpu_torch/models/vqgan/nn.py(30): forward", 0, 100),
        _raw("op", "aten::convolution", 10, 50, ext=1, seq=7),
        _raw("runtime", "cudaLaunchKernel", 20, 5, corr=100),
        _raw("op", "autograd::engine::evaluate_function: ConvolutionBackward0", 200, 50, ext=2, tid=2, seq=7,
             fwd_tid=1),
        _raw("runtime", "cudaLaunchKernel", 210, 5, corr=101, tid=2),
        _raw("runtime", "cudaLaunchKernel", 220, 5, corr=102, tid=2),
        _raw("kernel", "conv_fprop", 30, 40, corr=100),
        _raw("kernel", "conv_dgrad", 230, 20, corr=101),
    ]
    t = tr.build(raw)
    assert (t.launches, t.lost, t.lost_at, t.orphans) == (3, 1, (2,), 0)
    assert all("models/vqgan/nn.py" in tr.frames_of(r)[0] for r in t.records)
    # the event tree gives ops on autograd's thread the frames of the caller
    # waiting in `grad`: the backward op's own and those of the ops inside it
    caller = ("pkg/sgam_neurips22_tpu_torch/training/losses.py(96): adaptive_gradients",)
    raw.insert(4, _raw("op", "aten::convolution_backward", 205, 40, ext=3, tid=2))
    t = tr.build(raw, {2: caller, 3: caller})
    assert [tr.frames_of(r) for r in t.records] == [(raw[0].name,)] * 2


def test_union_gaps_and_primers():
    assert tr.union_us([(0, 10), (5, 15), (20, 30)]) == 25
    assert tr.gaps([(0, 10), (5, 15), (20, 30)]) == [(15, 5)]
    recs = [tr.Record(tr.PRIMER_KERNEL, 0, 0, 1, ()), tr.Record("k", 0, 2, 3, ())]
    t = tr.Trace(recs, tr.PRIMER_LEAD + 2, 2, (0, tr.PRIMER_LEAD), 0, {0: [(0, 1), (2, 5)]})
    out = tr.without_primers(t)
    assert (out.launches, out.lost, out.lost_at, len(out.records)) == (1, 1, (0,), 1)
    assert out.intervals == {0: [(2, 5)]}


def test_work_counts_by_hand():
    assert work.flash_fwd(8, 4096, 256) == (4.0 * 8 * 4096**2 * 256, 4 * (4 * 8 * 4096 * 256 + 8 * 4096))
    assert work.flash_bwd(2, 300, 64) == (8.0 * 2 * 300**2 * 64, 4 * (7 * 2 * 300 * 64 + 2 * 2 * 300))
    assert work.bound_s(989e12, 0) == 1.0 and work.bound_s(0, 3.35e12) == 1.0

    class Conv(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = torch.nn.Conv2d(4, 8, 3, padding=1)

        def forward(self, x, extrapolation_mask=None, flash=False):
            return self.conv(x.permute(0, 3, 1, 2))

    assert work.forward_flops(Conv, 16, 16) == 2 * 4 * 8 * 9 * 16 * 16


def test_import_check_names_whole_top_level_modules():
    code = ("import sys, portbench.run as r, portbench.unroll, portbench.train, portbench.control\n"
            "import sgam_neurips22_tpu_torch.pipeline.scene_generation\n"
            "assert r.forbidden_modules() == [], r.forbidden_modules()\n"
            "sys.modules['jax.numpy'] = sys\n"
            "assert r.forbidden_modules() == ['jax']\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=300)


def test_no_card_exits_without_result(tmp_path):
    """Without a card the run exits non-zero and prints no result."""
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", tiny.CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_inputs_and_weights_repeat_from_the_seed():
    from portbench import traffic, weights
    from portbench.unroll import _ref_model

    s = tiny.spec("clevr.unroll_splat.b8")
    cpu = torch.device("cpu")
    a, b, c = (traffic.request_seeds(s["config"], s["traffic"], seed, 3, cpu) for seed in (tiny.SEED, tiny.SEED, 5))
    assert all(torch.equal(x[0][1], y[0][1]) for x, y in zip(a, b)) and not torch.equal(a[0][0][1], c[0][0][1])
    with torch.device("meta"):
        shapes = _ref_model(s["config"])
    w1, w2 = (weights.vq_weights(shapes, tiny.SEED, cpu, 0.5) for _ in range(2))
    assert w1.keys() == dict(shapes.state_dict()).keys() and all(torch.equal(w1[k], w2[k]) for k in w1)
    t = tiny.spec("clevr.train.b16")
    assert torch.equal(traffic.train_batch(t["config"], t["traffic"], tiny.SEED, 1, cpu)["dst_img"],
                       traffic.train_batch(t["config"], t["traffic"], tiny.SEED, 1, cpu)["dst_img"])


def test_layer_readers_on_a_synthetic_context():
    """Every per-layer reader over hand-made sessions: 2 steps, 0.6 s busy
    in a 1 s window of 3 steps, 0.1 s of it under the VQGAN's frames."""
    vq = tr.Op(1, "aten::convolution", (), ("pkg/sgam_neurips22_tpu_torch/models/vqgan/nn.py(30): forward",))
    loss = tr.Op(2, "aten::abs", (), ("pkg/sgam_neurips22_tpu_torch/training/losses.py(96): generator_loss",))
    records = [tr.Record("conv", 0, 0, 1e5, (vq,)), tr.Record("abs", 0, 1e5, 5e4, (loss,))]
    busy = tr.Trace(records, 2, 0, (), 0, {0: [(0, 2e5), (3e5, 7e5)]})
    trace = tr.Trace(records, 2, 0, (), 0, {})

    class Cell:
        def flops_per_unit(self):
            return work.PEAK_FLOP_PER_S / 100

    ctx = run.Context(Cell(), busy, trace, 2, 1.5, {"units": 3, "seconds": 1.0}, 3 * 2**30)
    read = {m["name"]: run.reader(m["name"])(ctx) for m in run.load_spec("clevr.train.b16")["per_layer"]}
    assert read["device_idle.train"] == pytest.approx(100 * (1 - 0.3 * 3))
    assert read["mfu.train"] == pytest.approx(3.0) and read["peak_mem_gib.train"] == 3.0
    assert read["vqgan_ms_per_step.train"] == pytest.approx(50.0)
    assert read["loss_ms_per_step.train"] == pytest.approx(25.0)
    assert read["flash_bwd_roofline.train"] is None  # the session ran no hand attention backward
