"""The port's serving layers (`sgam_neurips22_tpu_torch/serving.py` and its
`serve` CLI) on the CPU, held against the JAX package's `serving.py` on the
same numpy inputs and the same JAX parameters (carried over by
`core/state_dict.from_jax_params`), on the TINY model of
tests/test_serving.py at 32^2.

Tolerances: `build_inference_step`'s RGB and depth at 1e-5 (absolute;
depth also 1e-5 of itself, since depth = 1 / disparity), for both
datasets; the served splat frames at the batch-1 unroll's tolerances of
test_torch_port_pipeline.py (rgb atol 1e-5, depth atol 1e-4); checksums,
files and HTTP answers exactly as tests/test_serving.py checks JAX's; the
map's grid accumulation (whose card kernel makes map requests repeatable)
emulated and bit-exact against index_add_ and JAX's scatter-add."""
import json
import os
import pickle
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from sgam_neurips22_tpu.models import init_vqmodel
from sgam_neurips22_tpu.pipeline.scene_generation import SceneGenConfig as JCfg
from sgam_neurips22_tpu.serving import SceneServer as JServer
from sgam_neurips22_tpu.serving import build_inference_step as j_build_inference_step
from sgam_neurips22_tpu.serving import flagship_config as j_flagship_config
from sgam_neurips22_tpu_torch import serve
from sgam_neurips22_tpu_torch.models.vqgan.model import VQModel
from sgam_neurips22_tpu_torch.pipeline.scene_generation import SceneGenConfig
from sgam_neurips22_tpu_torch.serving import SceneServer, build_inference_step, load_inference_params, run_http_server
from torch_port_common import TINY, port_config, port_model, tiny_jax_params, to_numpy_tree

H = W = 32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module: its CPU work is many small ops,
    and the tier-1 run's workers share the cores (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_template(root, seed: int):
    """tests/test_serving.py's template: one 8-bit RGB PNG and its ray depth
    U(8, 14) at grid (0, 0)."""
    os.makedirs(root)
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.uniform(0, 255, (H, W, 3)).astype(np.uint8)).save(root / "im_00000_0_0.png")
    np.save(root / "dm_00000_0_0.npy", rng.uniform(8, 14, (H, W)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_params():
    return tiny_jax_params()


@pytest.fixture(scope="module")
def served(tmp_path_factory, jax_params):
    """(port server, JAX server) on one template, a 3x3 grid, 3 sources."""
    root = tmp_path_factory.mktemp("serve")
    write_template(root / "templates", 5)
    kw = dict(dataset="clevr-infinite", output_dim=(3, 3), num_src=3, topk=1, image_resolution=(H, W))
    port = SceneServer(port_model(jax_params, TINY), SceneGenConfig(**kw), str(root / "templates"),
                       output_root=str(root / "out"), device="cpu")
    ref = JServer(jax_params, TINY, JCfg(**kw), str(root / "templates"), output_root=str(root / "jax_out"))
    return port, ref


@pytest.mark.parametrize("dataset", ["clevr-infinite", "google_earth"])
def test_build_inference_step_matches_jax(dataset):
    """The example batch equals JAX's; the step, on JAX's weights, gives
    JAX's RGB and depth."""
    full = j_flagship_config(dataset)
    jcfg = replace(TINY, dataset=full.dataset, depth_range=full.depth_range)
    jfn, (jparams, jbatch, jrng) = j_build_inference_step(jcfg, image_size=H)
    j_rgb, j_depth = jax.jit(jfn)(jparams, jbatch, jrng)
    fn, (model, batch, gen) = build_inference_step(port_config(jcfg), image_size=H, device="cpu")
    assert isinstance(model, VQModel) and not model.training
    assert set(batch) == set(jbatch)
    for k, v in batch.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jbatch[k]), err_msg=k)
    rgb, depth = fn(port_model(jparams, jcfg), batch, gen)
    assert rgb.shape == (1, H, W, 3) and depth.shape == (1, H, W)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(j_rgb), atol=1e-5)
    np.testing.assert_allclose(depth.numpy(), np.asarray(j_depth), atol=1e-5, rtol=1e-5)
    # the step's own seeded weights: the same on every build, and finite
    fn2, (model2, batch2, gen2) = build_inference_step(port_config(jcfg), image_size=H, device="cpu")
    a, b = fn(model, batch, gen), fn2(model2, batch2, gen2)
    assert all(torch.equal(x, y) and torch.isfinite(x).all() for x, y in zip(a, b))


def test_build_inference_step_topk_draws_from_the_generator():
    """At topk > 1 the generator draws the sample: one seed, one result;
    the step runs under inference mode."""
    fn, (model, batch, gen) = build_inference_step(port_config(TINY), topk=4, image_size=H, device="cpu")
    a = fn(model, batch, torch.Generator().manual_seed(7))
    b = fn(model, batch, torch.Generator().manual_seed(7))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[0].is_inference() and torch.isfinite(a[1]).all()


def test_served_frames_match_jax_and_are_deterministic(served):
    """Two requests give bit-equal checksums on the resident generator;
    the frames equal JAX's SceneServer's at topk=1."""
    port, ref = served
    r1 = port.generate({"export": False, "rng_seed": 3})
    gen1 = port._gen
    r2 = port.generate({"export": False, "rng_seed": 3})
    assert port._gen is gen1
    assert r1["frames"] == r2["frames"] == 8
    assert r1["depth_checksum"] == r2["depth_checksum"]
    assert set(r1) == {"request", "seed_index", "frames", "seconds", "frames_per_second", "output_dir",
                       "depth_checksum"}
    assert (r1["request"], r2["request"], r1["output_dir"]) == (0, 1, None)
    jr = ref.generate({"export": False, "rng_seed": 3})
    assert jr["frames"] == 8
    np.testing.assert_allclose(port._gen.rgb_buf.numpy(), np.asarray(ref._gen.rgb_buf), atol=1e-5)
    np.testing.assert_allclose(port._gen.depth_buf.numpy(), np.asarray(ref._gen.depth_buf), atol=1e-4)
    np.testing.assert_allclose(r1["depth_checksum"], jr["depth_checksum"], rtol=1e-5)
    m = port.metrics()
    assert m["requests"] >= 2 and m["frames"] >= 16 and 0 <= m["utilization"] <= 1
    assert set(m) == set(ref.metrics())


def test_export_and_path_confinement(served, tmp_path):
    """An output_dir under output_root receives the frames and the merged
    point cloud, the files JAX's server writes; a path outside it raises
    ValueError naming output_root."""
    port, ref = served
    out = os.path.join(port.output_root, "exported")
    r = port.generate({"output_dir": out, "rng_seed": 3})
    assert r["output_dir"] == os.path.realpath(out)
    files = sorted(os.listdir(out))
    assert any(f.startswith("im_") and f.endswith(".png") for f in files) and "merged_pcds.ply" in files
    jout = os.path.join(ref.output_root, "exported")
    ref.generate({"output_dir": jout, "rng_seed": 3})
    assert files == sorted(os.listdir(jout))
    default = port.generate({"seed_index": 0})
    assert os.path.basename(default["output_dir"]) == f"req{default['request']:04d}_clevr-infinite_seed0"
    with pytest.raises(ValueError, match="output_root"):
        port.generate({"output_dir": str(tmp_path / "escape")})
    with pytest.raises(ValueError, match="output_root"):
        port.generate({"output_dir": os.path.join(port.output_root, "..", "up")})


def test_health_caches_device_info(served, monkeypatch):
    port, ref = served
    h = port.health()
    assert h["status"] == "ok" and h["dataset"] == "clevr-infinite" and h["grid"] == [3, 3]
    assert (h["backend"], h["devices"], h["device_name"]) == ("cpu", 1, "cpu")
    assert set(ref.health()) <= set(h)

    def no_cuda(*a, **kw):
        raise AssertionError("health touched CUDA after its first call")

    monkeypatch.setattr(torch.cuda, "device_count", no_cuda)
    monkeypatch.setattr(torch.cuda, "get_device_name", no_cuda)
    assert port.health()["devices"] == 1


def test_server_map_requery_mode(tmp_path, jax_params):
    """use_rgbd_integration: reset rebuilds the map for each request, so two
    requests give equal checksums; warmup runs one request."""
    write_template(tmp_path / "tpl", 9)
    cfg = SceneGenConfig(dataset="clevr-infinite", output_dim=(2, 2), num_src=3, topk=1, image_resolution=(H, W),
                         use_rgbd_integration=True)
    srv = SceneServer(port_model(jax_params, TINY), cfg, str(tmp_path / "tpl"), output_root=str(tmp_path / "o"),
                      device="cpu")
    assert "warmup_seconds" in srv.warmup() and srv.health()["compiled"]
    vol = srv._gen.volume
    r1 = srv.generate({"export": False})
    assert srv._gen.volume is not vol
    r2 = srv.generate({"export": False})
    assert r1["frames"] == r2["frames"] == 3
    assert r1["depth_checksum"] == r2["depth_checksum"]


def test_server_topk_rng_seed(tmp_path, jax_params):
    """At topk > 1 rng_seed seeds the draws: the same seed gives the same
    scene, another seed another."""
    write_template(tmp_path / "tpl", 5)
    cfg = SceneGenConfig(dataset="clevr-infinite", output_dim=(2, 2), num_src=3, topk=4, image_resolution=(H, W))
    srv = SceneServer(port_model(jax_params, TINY), cfg, str(tmp_path / "tpl"), output_root=str(tmp_path / "o"),
                      device="cpu")
    a, b, c = (srv.generate({"export": False, "rng_seed": s})["depth_checksum"] for s in (3, 3, 4))
    assert a == b != c


def test_default_device_is_cuda(tmp_path, jax_params):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    cfg = SceneGenConfig(dataset="clevr-infinite", output_dim=(2, 2), image_resolution=(H, W))
    with pytest.raises(RuntimeError, match="cuda"):
        SceneServer(port_model(jax_params, TINY), cfg, str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        build_inference_step(port_config(TINY), image_size=H)


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(port, path, body, timeout=300):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_api(served, tmp_path):
    """tests/test_serving.py's HTTP checks, and the 400 and unknown GET."""
    port_server, _ = served
    httpd = run_http_server(port_server, port=0, warmup=False)
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        code, health = _get(port, "/healthz")
        assert code == 200 and health["status"] == "ok"
        assert health["dataset"] == "clevr-infinite" and health["grid"] == [3, 3]

        code, res = _post(port, "/warmup", {})
        assert code == 200 and "warmup_seconds" in res

        out = os.path.join(port_server.output_root, "http_out")
        code, res = _post(port, "/generate", {"output_dir": out, "rng_seed": 3})
        assert code == 200, res
        assert res["frames"] == 8 and os.path.isdir(out)

        code, err = _post(port, "/generate", {"output_dir": str(tmp_path / "esc")})
        assert code == 500 and "output_root" in err["error"] and err["error"].startswith("ValueError: ")

        code, err = _post(port, "/generate", b"{not json")
        assert code == 400 and "bad request body" in err["error"]

        code, m = _get(port, "/metrics")
        assert code == 200 and m["requests"] >= 1 and m["frames"] >= 8

        code, err = _post(port, "/nope", {})
        assert code == 404 and "error" in err
        code, err = _get(port, "/nope")
        assert code == 404 and "error" in err
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=5)


def test_load_inference_params_reads_numpy_pickle(tmp_path):
    """A .pkl of a JAX init_vqmodel tree with numpy leaves loads through the
    weight bridge (every tensor replaced); a tree that does not fit raises;
    a pickle of jax.Array leaves is read as numpy without importing JAX
    (here a tree that does not fit, so the bridge's KeyError shows that it
    was read), and a pickle of another JAX object raises without importing
    JAX, naming the port's converter."""
    params = to_numpy_tree(init_vqmodel(jax.random.PRNGKey(4), TINY))
    with open(tmp_path / "params.pkl", "wb") as f:
        pickle.dump(params, f)
    model = VQModel(port_config(TINY))
    load_inference_params(str(tmp_path / "params.pkl"), model)
    ref = port_model(params, TINY).state_dict()
    assert all(torch.equal(v, ref[k]) for k, v in model.state_dict().items())
    del params["decoder"]
    with open(tmp_path / "partial.pkl", "wb") as f:
        pickle.dump(params, f)
    with pytest.raises(KeyError, match="missing"):
        load_inference_params(str(tmp_path / "partial.pkl"), model)
    with open(tmp_path / "jax.pkl", "wb") as f:
        pickle.dump({"conv_in": {"w": jax.numpy.zeros(2)}}, f)
    with open(tmp_path / "jax_object.pkl", "wb") as f:
        pickle.dump({"conv_in": {"w": jax.tree_util.tree_map}}, f)
    code = ("import sys, torch; from sgam_neurips22_tpu_torch.serving import load_inference_params\n"
            "for path in sys.argv[1:]:\n"
            " try:\n  load_inference_params(path, torch.nn.Linear(1, 1))\n"
            " except (KeyError, ValueError) as e:\n  print('jax' in sys.modules, type(e).__name__, e)\n")
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path / "jax.pkl"), str(tmp_path / "jax_object.pkl")],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    read, refused = r.stdout.splitlines()
    assert read.startswith("False KeyError") and "conv_in.w" in read
    assert refused.startswith("False ValueError") and "jax.tree_util.tree_map" in refused
    assert "sgam_neurips22_tpu_torch.convert_lpips" in refused


def test_serve_cli_builds_the_server(monkeypatch, tmp_path, capsys, jax_params):
    """The serve CLI's flags build a SceneServer (TINY patched in for the
    flagship model): bf16 by default, the grid and device as given, seeded
    random weights with a warning, or a .pkl's weights."""
    write_template(tmp_path / "tpl", 5)
    monkeypatch.setattr(serve, "flagship_config",
                        lambda dataset, compute_dtype: replace(port_config(TINY), ddconfig=replace(
                            port_config(TINY).ddconfig, compute_dtype=compute_dtype)))
    argv = ["--template_dir", str(tmp_path / "tpl"), "--rows", "2", "--cols", "3", "--resolution", str(H),
            "--output_root", str(tmp_path / "out"), "--device", "cpu"]
    srv = serve.build_server(serve.parse_args(argv))
    assert "WARNING: randomly initialized weights" in capsys.readouterr().out
    assert srv.model.cfg.ddconfig.compute_dtype == "bfloat16" and srv.device.type == "cpu"
    assert srv.scene_cfg.output_dim == (2, 3) and srv.scene_cfg.image_resolution == (H, W)
    r = srv.generate({"export": False})
    assert r["frames"] == 5 and np.isfinite(r["depth_checksum"])
    with open(tmp_path / "params.pkl", "wb") as f:
        pickle.dump(to_numpy_tree(jax_params), f)
    srv = serve.build_server(serve.parse_args(argv + ["--ckpt", str(tmp_path / "params.pkl"),
                                                      "--compute_dtype", "float32"]))
    assert "loaded weights" in capsys.readouterr().out
    ref = port_model(jax_params, TINY).state_dict()
    assert all(torch.equal(v, ref[k]) for k, v in srv.model.state_dict().items())
    assert serve.parse_args([]).device == "cuda" and serve.parse_args([]).compute_dtype == "bfloat16"


def test_grid_accumulate_emulation_matches_cpu_and_jax():
    """The map's grid accumulation (`ops/grid_accumulate`, the repair that
    makes two map-requery requests equal on the card): the card kernel's
    walk, emulated here (a stable sort of the keys, then each key's run
    added one by one onto the grid's value), equals the CPU's index_add_
    and JAX's scatter-add bit for bit, on keys with long runs and values
    that cancel."""
    from sgam_neurips22_tpu_torch.ops.grid_accumulate import grid_accumulate

    rng = np.random.default_rng(12)
    n_vox, n = 64, 20000
    idx = rng.integers(0, n_vox, n).astype(np.int32)
    vals = rng.choice(np.float32([0.05, -0.05, 0.15, -0.15, 0.35, -0.95, 1.0]), n).astype(np.float32)
    grid0 = rng.normal(0, 1, n_vox).astype(np.float32)
    emulated = grid0.copy()
    order = np.argsort(idx, kind="stable")
    keys, ordered = idx[order], vals[order]
    starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
    for s, e in zip(starts, np.r_[starts[1:], n]):
        acc = emulated[keys[s]]
        for v in ordered[s:e]:
            acc = np.float32(acc + v)
        emulated[keys[s]] = acc
    got = grid_accumulate(torch.as_tensor(grid0.copy()), torch.as_tensor(idx), torch.as_tensor(vals)).numpy()
    want = np.asarray(jax.numpy.asarray(grid0).at[idx].add(vals))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(emulated, want)
