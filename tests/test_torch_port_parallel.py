"""The port's data parallelism (`sgam_neurips22_tpu_torch/parallel/`) on the
CPU, in spawned gloo ranks that never import JAX (their functions live in
tests/torch_port_parallel_worker.py; inputs and JAX's converted weights
reach them through files), held against the JAX package:

- four ranks x batch 2 through the port's train_step, both phases, two
  steps (the conditional phase without LPIPS: LPIPS has no collective, and
  at batch 8 its backward's rounding puts the conv_in.bias moment of the
  port's own one-process step 4.0e-3 of its largest from JAX's at step 2,
  past MOMENT_TOL's 3e-3, which the batch-2 test calibrated; the codebook
  phase keeps it), against JAX's train_step on the 8-device CPU mesh at global batch
  8 (tests/test_training.py's data-parallel test) and against the port's
  own one-process step at batch 8, at tests/test_torch_port_training.py's
  gates (logs rtol 1e-4 / atol 1e-5, Adam moments within MOMENT_TOL of each
  tensor's largest, weights as `_compare_params` states, running
  statistics atol 1e-5; JAX's weights carried into the ranks after step
  1, as there); with the k-means bookkeeping on (element 0 of the global
  batch), with accumulation 2 (held to the port's one-process
  accumulation, which tests/test_torch_port_trainer.py holds to JAX's
  optax.MultiSteps), and with two planted faults (BatchNorm on
  local statistics, the adaptive weight from local gradients) that must
  fail those gates. Every rank's parameters, moments, running statistics
  and k-means state are bit-equal, and a k-means refresh from a different
  generator on each rank ends bit-equal (rank 0's rows);
- the Loader's process slices, bit-exact with JAX's Loader(process_count=2)
  on threads, worker processes and a packed shard;
- the primitives in two ranks: replicate_global, shard_local_batch, the
  bucketed mean, the gather, the differentiable sum, the mesh's rule;
- Trainer(n_devices=2) and the multi-host flags without a group raise.

The sharded unroll and the multi-rank train CLI are in
tests/test_torch_port_parallel_scenes.py.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import torch_port_parallel_worker as worker
from sgam_neurips22_tpu.parallel.mesh import make_mesh as j_make_mesh
from sgam_neurips22_tpu.parallel.mesh import replicate as j_replicate
from sgam_neurips22_tpu.parallel.mesh import shard_batch as j_shard_batch
from sgam_neurips22_tpu.training.data.datamodule import Loader as JLoader
from sgam_neurips22_tpu.training.lpips import init_lpips
from sgam_neurips22_tpu.training.train_step import OnlineKMeansConfig, TrainConfig
from sgam_neurips22_tpu.training.train_step import create_train_state as j_create
from sgam_neurips22_tpu.training.train_step import train_step as j_train_step
from sgam_neurips22_tpu_torch import train as t_train_cli
from sgam_neurips22_tpu_torch.core.config import save_yaml
from sgam_neurips22_tpu_torch.core.config import wrap as t_wrap
from sgam_neurips22_tpu_torch.core.state_dict import from_jax_params, load_jax_training
from sgam_neurips22_tpu_torch.parallel import distributed
from sgam_neurips22_tpu_torch.training import train_step as t_ts
from sgam_neurips22_tpu_torch.training.data.datamodule import Loader
from sgam_neurips22_tpu_torch.training.kmeans import refresh_codebook
from sgam_neurips22_tpu_torch.training.lpips import LPIPS
from sgam_neurips22_tpu_torch.training import trainer as t_trainer
from sgam_neurips22_tpu_torch.training.losses import LossConfig
from test_torch_port_training import MOMENT_TOL, _compare_logs, _compare_params
from test_training import TINY_LOSS, TINY_MODEL, make_cond_batch, make_image_batch
from torch_port_common import batch_to_torch, port_config, to_numpy_tree

RANKS = 4
GLOBAL_BATCH = 8  # the JAX mesh's 8 devices, one row each; here 4 ranks x 2
LR = 1e-3
KMEANS = OnlineKMeansConfig(do_online_kmeans_clustering=True, online_kmeans_word_timeout=5,
                            train_feature_buffer_size=4)
REFRESHED = 8  # codewords the refresh re-clusters


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread here and in each rank (the tier-1 run's workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lpips_params():
    return init_lpips(jax.random.PRNGKey(42))


def _launch(fn, n, *args):
    distributed.launch(fn, n, args=args, device="cpu", torch_threads=1)


# tests/test_torch_port_trainer.py's helpers (not imported: that module's
# imports cost the tier-1 worker seconds)
def _port_cfg(j_cfg):
    return t_ts.TrainConfig(
        model=port_config(j_cfg.model), loss=LossConfig(**dataclasses.asdict(j_cfg.loss)),
        learning_rate=j_cfg.learning_rate, use_vq=j_cfg.use_vq,
        online_kmeans=t_ts.OnlineKMeansConfig(**dataclasses.asdict(j_cfg.online_kmeans)),
        accumulate_grad_batches=j_cfg.accumulate_grad_batches)


def _carry(state, j_state, lp=None, lpips_params=None):
    load_jax_training(state.model, state.disc, *(to_numpy_tree(j_state[k]) for k in
                                                 ("params", "disc_params", "disc_state")),
                      lp, None if lpips_params is None else to_numpy_tree(lpips_params))


def _check_state(state, j_state, cfg, moment_tol):
    """Trainable and discriminator weights and Adam moments against JAX's
    after one update (`_compare_params`)."""
    trainable = t_ts.split_params(state.model, cfg.phase)[0]
    disc = list(state.disc.named_parameters())
    for params, opt, j_params, j_opt in ((trainable, state.opt_ae, j_state["params"], j_state["opt_ae"]),
                                         (disc, state.opt_disc, j_state["disc_params"], j_state["opt_disc"])):
        ref = from_jax_params(to_numpy_tree(j_params))
        mu, nu = from_jax_params(to_numpy_tree(j_opt[0].mu)), from_jax_params(to_numpy_tree(j_opt[0].nu))
        moments = {n: (opt.state[p]["exp_avg"].numpy(), opt.state[p]["exp_avg_sq"].numpy(), mu[n], nu[n])
                   for n, p in params}
        _compare_params(params, ref, moments, int(j_opt[0].count), moment_tol)


# ------------------------------------------------------------- train step
SCENARIOS = {  # name -> (JAX config, batch, steps, planted fault, the JAX run it is held to; None: none)
    "codebook": (TrainConfig(model=TINY_MODEL, loss=TINY_LOSS, learning_rate=LR, online_kmeans=KMEANS),
                 make_image_batch(b=GLOBAL_BATCH), 2, None, "codebook"),
    "conditional": (TrainConfig(model=dataclasses.replace(TINY_MODEL, phase="conditional_generation"),
                                loss=dataclasses.replace(TINY_LOSS, perceptual_weight=0.0), learning_rate=LR),
                    make_cond_batch(b=GLOBAL_BATCH), 2, None, "conditional"),
    "accumulate": (TrainConfig(model=TINY_MODEL, loss=TINY_LOSS, learning_rate=LR, accumulate_grad_batches=2),
                   make_image_batch(b=GLOBAL_BATCH), 2, None, None),
    "local_batchnorm": (None, None, 1, "local_batchnorm", "codebook"),
    "local_d_weight": (None, None, 1, "local_d_weight", "codebook"),
}


def _jax_steps(j_cfg, batch, steps, lpips_params):
    """JAX's train_step on the 8-device mesh: (initial state, [(state,
    logs) after each step]) as numpy trees."""
    mesh = j_make_mesh(8)
    j_state0 = j_create(jax.random.PRNGKey(0), j_cfg)
    out, j_state = [], j_replicate(jax.tree_util.tree_map(lambda x: x.copy(), j_state0), mesh)
    lp, sb = j_replicate(lpips_params, mesh), j_shard_batch(batch, mesh)
    for _ in range(steps):
        j_state, j_logs = j_train_step(j_state, sb, lp, j_cfg)
        out.append((to_numpy_tree(j_state), {k: float(v) for k, v in j_logs.items()}))
    return to_numpy_tree(j_state0), out


def _port_dicts(cfg, j_state, lpips_params=None):
    """The port's model, discriminator (and LPIPS) state dicts carrying a
    JAX state's weights."""
    state = t_ts.create_train_state(cfg, seed=0, device="cpu")
    lp = None if lpips_params is None else LPIPS()
    _carry(state, j_state, lp, lpips_params)
    out = {"model": state.model.state_dict(), "disc": state.disc.state_dict()}
    if lp is not None:
        out["lpips"] = lp.state_dict()
    return out


def _rank_state(cfg, rec):
    """A port TrainState holding a rank's record."""
    state = t_ts.create_train_state(cfg, seed=0, device="cpu")
    state.model.load_state_dict(rec["model"])
    state.disc.load_state_dict(rec["disc"])
    state.opt_ae.load_state_dict(rec["opt_ae"])
    state.opt_disc.load_state_dict(rec["opt_disc"])
    return state


def _assert_bit_equal(a, b, where=""):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_bit_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_bit_equal(x, y, f"{where}[{i}]")
    elif torch.is_tensor(a):
        assert torch.equal(a, b), where
    else:
        assert a == b, where


def _hold_to_jax(cfg, rec, j_state, j_logs, step):
    """One rank's record after `step` steps against JAX's state and logs."""
    _compare_logs(rec["logs"], j_logs)
    state = _rank_state(cfg, rec)
    _check_state(state, j_state, cfg, MOMENT_TOL[cfg.phase])
    stats = from_jax_params(to_numpy_tree(j_state["disc_state"]))
    for name, b in state.disc.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[name], atol=1e-5, rtol=0, err_msg=name)
    if rec["kmeans"] is not None:
        jks = j_state["kmeans"]
        np.testing.assert_array_equal(rec["kmeans"]["timeout"].numpy(), np.asarray(jks.timeout))
        np.testing.assert_allclose(rec["kmeans"]["buffer"].numpy(), np.asarray(jks.buffer), atol=1e-5, rtol=0)
        assert rec["kmeans"]["ptr"] == int(jks.ptr) == step


def _hold_to_one_process(cfg, rec, one, one_logs, step):
    """A rank's record against the port's one-process state at batch 8."""
    _compare_logs(rec["logs"], one_logs)
    state = _rank_state(cfg, rec)
    if step // cfg.accumulate_grad_batches == 0:
        return
    for params, opt, ref_params, ref_opt in (
            (t_ts.split_params(state.model, cfg.phase)[0], state.opt_ae,
             dict(t_ts.split_params(one.model, cfg.phase)[0]), one.opt_ae),
            (list(state.disc.named_parameters()), state.opt_disc, dict(one.disc.named_parameters()), one.opt_disc)):
        moments = {n: (opt.state[p]["exp_avg"].numpy(), opt.state[p]["exp_avg_sq"].numpy(),
                       ref_opt.state[ref_params[n]]["exp_avg"].numpy(),
                       ref_opt.state[ref_params[n]]["exp_avg_sq"].numpy()) for n, p in params}
        _compare_params(params, {n: p.detach().numpy() for n, p in ref_params.items()}, moments,
                        step // cfg.accumulate_grad_batches, MOMENT_TOL[cfg.phase])
    for (name, b), ref in zip(state.disc.named_buffers(), one.disc.buffers()):
        np.testing.assert_allclose(b.numpy(), ref.numpy(), atol=1e-5, rtol=0, err_msg=name)


@pytest.fixture(scope="module")
def data_parallel_run(tmp_path_factory, lpips_params):
    """Every scenario: JAX's mesh steps, the port's one-process steps at
    batch 8 (logs and state after each step), and the four ranks' records."""
    root = tmp_path_factory.mktemp("dp")
    jax_runs, spec, one_process = {}, {}, {}
    for name, (j_cfg, batch, steps, fault, ref) in SCENARIOS.items():
        if j_cfg is None:
            j_cfg, batch = SCENARIOS[ref][:2]
        cfg = _port_cfg(j_cfg)
        if ref is None:  # accumulation: JAX's initial state, no JAX step, no carry
            j_state0, carry = j_create(jax.random.PRNGKey(0), j_cfg), [None] * steps
        else:
            if ref not in jax_runs:
                jax_runs[ref] = _jax_steps(j_cfg, batch, SCENARIOS[ref][2], lpips_params)
            j_state0, j_steps = jax_runs[ref]
            carry = [_port_dicts(cfg, j_steps[s][0]) for s in range(steps - 1)] + [None]
        spec[name] = {"cfg": cfg, **_port_dicts(cfg, j_state0, lpips_params),
                      "batch": {k: np.asarray(v) for k, v in batch.items()}, "carry": carry, "fault": fault,
                      "refresh": REFRESHED if name == "codebook" else 0}
        if fault is None:
            state = t_ts.create_train_state(cfg, seed=0, device="cpu")
            lp = LPIPS()
            _carry(state, j_state0, lp, lpips_params)
            if ref is None:
                one_process[f"{name}_init"] = {"model": {k: v.clone() for k, v in state.model.state_dict().items()}}
            one_process[name] = []
            for s in range(steps):
                state, logs = t_ts.train_step(state, batch_to_torch(batch), lp, cfg)
                copy = _rank_state(cfg, worker._state_record(state, logs))
                one_process[name].append((copy, {k: float(v) for k, v in logs.items()}))
                if carry[s] is not None:
                    state.model.load_state_dict(carry[s]["model"])
                    state.disc.load_state_dict(carry[s]["disc"])
    torch.save(spec, root / "spec.pt")
    _launch(worker.train_steps, RANKS, str(root / "spec.pt"), str(root))
    ranks = [torch.load(root / f"train_rank{r}.pt", weights_only=False) for r in range(RANKS)]
    return jax_runs, one_process, ranks


@pytest.mark.parametrize("scenario", ["codebook", "conditional", "accumulate"])
def test_four_ranks_match_jax_mesh(data_parallel_run, scenario):
    """Four gloo ranks x batch 2 against JAX's 8-device mesh at global
    batch 8 and the port's one-process step at batch 8, after each of two
    steps; every rank bit-equal to rank 0. With accumulation 2 (as
    tests/test_training.py's mesh test: the microbatch leaves the weights,
    the second step applies the mean) against the port's one-process
    accumulation, which tests/test_torch_port_trainer.py holds to
    optax.MultiSteps."""
    jax_runs, one_process, ranks = data_parallel_run
    j_cfg, _, steps, _, ref = SCENARIOS[scenario]
    cfg = _port_cfg(j_cfg)
    for s in range(steps):
        rec = ranks[0][scenario][s]
        for r in range(1, RANKS):
            _assert_bit_equal(ranks[r][scenario][s], rec, f"rank {r} step {s + 1}")
        if ref is not None:
            _hold_to_jax(cfg, rec, *jax_runs[ref][1][s], s + 1)
        _hold_to_one_process(cfg, rec, *one_process[scenario][s], s + 1)
    assert rec["step"] == steps
    if scenario == "accumulate":
        first, second = ranks[0][scenario]
        init = one_process["accumulate_init"]
        assert all(torch.equal(first["model"][k], v) for k, v in init["model"].items())
        assert not all(torch.equal(second["model"][k], v) for k, v in init["model"].items())
        assert not first["opt_ae"]["state"] and second["opt_ae"]["state"]


def test_kmeans_refresh_bit_equal_on_every_rank(data_parallel_run):
    """The refresh after the codebook scenario's two steps: each rank draws
    its init rows from a generator of its own seed, and every rank ends
    with rank 0's codebook and timeouts, which equal a one-process refresh
    from rank 0's generator."""
    _, _, ranks = data_parallel_run
    refreshed = [r["codebook"][-1] for r in ranks]
    assert refreshed[0]["refreshed"] == REFRESHED
    for r in range(1, RANKS):
        _assert_bit_equal(refreshed[r], refreshed[0], f"rank {r}")
    cfg = _port_cfg(SCENARIOS["codebook"][0])
    before = _rank_state(cfg, ranks[0]["codebook"][-2]).model.codebook.detach()
    by_seed = {}
    for seed in (worker.REFRESH_SEED, worker.REFRESH_SEED + 1):
        state = _rank_state(cfg, ranks[0]["codebook"][-2])
        km = ranks[0]["codebook"][-2]["kmeans"]
        state.kmeans.timeout.copy_(km["timeout"])
        state.kmeans.buffer.copy_(km["buffer"])
        state.kmeans.timeout[:REFRESHED] = 0
        refresh_codebook(state.model.codebook, state.kmeans, cfg.online_kmeans.online_kmeans_word_timeout,
                         torch.Generator().manual_seed(seed))
        by_seed[seed] = state.model.codebook.detach()
    assert torch.equal(by_seed[worker.REFRESH_SEED], refreshed[0]["codebook"])
    assert torch.equal(refreshed[0]["timeout"][:REFRESHED], torch.full((REFRESHED,), KMEANS.online_kmeans_word_timeout,
                                                                      dtype=torch.int32))
    # rank 1's own seed gives other rows: the ranks agree because rank 0's are broadcast
    assert not torch.equal(by_seed[worker.REFRESH_SEED + 1], by_seed[worker.REFRESH_SEED])
    assert not torch.equal(refreshed[0]["codebook"][:REFRESHED], before[:REFRESHED])


@pytest.mark.parametrize("fault", ["local_batchnorm", "local_d_weight"])
def test_planted_faults_fail_the_gate(data_parallel_run, fault):
    """BatchNorm on each rank's own statistics, or the adaptive weight from
    each rank's own gradients: step 1 fails the JAX gates."""
    jax_runs, _, ranks = data_parallel_run
    cfg = _port_cfg(SCENARIOS["codebook"][0])
    rec = ranks[0][fault][0]
    with pytest.raises(AssertionError):
        _hold_to_jax(cfg, rec, *jax_runs["codebook"][1][0], 1)
    if fault == "local_batchnorm":  # each rank's running statistics are its own
        assert not all(torch.equal(ranks[r][fault][0]["disc"]["main.3.running_mean"],
                                   rec["disc"]["main.3.running_mean"]) for r in range(1, RANKS))


# ------------------------------------------------------------------ loader
def test_loader_slices_match_jax(tmp_path):
    """Two ranks' Loader slices over two epochs, bit-exact with JAX's
    Loader(process_count=2) (tests/test_multihost.py's partition test): the
    same order and the same per-position streams, on the loader's thread,
    on 8 decode threads and on 2 worker processes (rank 1, one epoch); a packed shard's
    slices equal the whole batch's rows; a batch that does not divide
    raises."""
    ds = worker.IndexDataset(16)
    # (workers, processes, ranks, epochs): the worker processes' pool costs a spawn an epoch
    for workers, processes, ranks, epochs in ((1, False, (0, 1), 2), (8, False, (0, 1), 2), (2, True, (1,), 1)):
        for rank in ranks:
            mine = Loader(ds, 4, shuffle=True, seed=7, workers=workers, processes=processes, process_count=2,
                          process_index=rank)
            ref = JLoader(ds, 4, shuffle=True, seed=7, workers=1, process_count=2, process_index=rank)
            for _ in range(epochs):
                a, b = list(mine), list(ref)
                assert len(a) == len(b) == 4
                for x, y in zip(a, b):
                    for k in ("idx", "draw"):
                        np.testing.assert_array_equal(x[k], y[k])
    with pytest.raises(ValueError, match="not divisible"):
        Loader(ds, 3, process_count=2)

    class Packed(worker.IndexDataset):
        def assemble_batch(self, idxs):
            return {"idx": np.asarray(idxs, np.int64)}

    whole = list(Loader(Packed(16), 4, shuffle=True, seed=7))
    halves = [list(Loader(Packed(16), 4, shuffle=True, seed=7, process_count=2, process_index=r)) for r in range(2)]
    for w, a, b in zip(whole, *halves):
        np.testing.assert_array_equal(w["idx"], np.concatenate([a["idx"], b["idx"]]))


# -------------------------------------------------------------- primitives
def test_primitives_in_two_ranks(tmp_path):
    """The analogue of tests/test_multihost.py's two-process primitives."""
    _launch(worker.primitives, 2, str(tmp_path))
    outs = [torch.load(tmp_path / f"primitives_rank{r}.pt", weights_only=False) for r in range(2)]
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    for r, o in enumerate(outs):
        assert (o["size"], o["rank"], o["local_rank"]) == (2, r, r)
        assert torch.equal(o["replicated"]["w"], torch.ones(3, 2)) and torch.equal(o["replicated"]["b"][0],
                                                                                 torch.arange(4))
        for key in ("local_batch", "shard_batch", "batch_sharding"):
            np.testing.assert_array_equal(o[key].numpy(), x[4 * r: 4 * r + 4])
        assert torch.equal(o["mean"][0], torch.full((5,), 0.5)) and torch.equal(o["mean"][1], torch.full((7, 2), 5.0))
        assert torch.equal(o["mean"][2], torch.tensor([0.5, 1.0], dtype=torch.float64))
        assert torch.equal(o["gathered"], torch.tensor([[0.0] * 3] * 2 + [[1.0] * 3] * 2))
        assert torch.equal(o["sum"], torch.tensor([3.0, 6.0]))
        # d/dx_r of the ranks' losses sum_r' (r' + 1) * total: 1 + 2 on every rank
        assert torch.equal(o["sum_grad"], torch.full((2,), 3.0))
        assert o["name"] == "run-of-rank-0" and "span every rank" in o["wrong_n_devices"]


# --------------------------------------------------------------- trainer
def test_trainer_and_flags_without_a_group_raise(tmp_path):
    """A plain process drives one device: Trainer(n_devices=2) raises and
    names the launcher; several hosts need process 0's address."""
    from test_trainer import make_cfg

    cfg = t_wrap(make_cfg(str(tmp_path)).to_plain())
    with pytest.raises(ValueError, match="--n_devices"):
        t_trainer.Trainer(cfg, str(tmp_path / "dp"), n_devices=2, use_wandb=False, device="cpu",
                          install_signals=False)
    base = str(tmp_path / "base.yaml")
    save_yaml(cfg, base)
    with pytest.raises(ValueError, match="coordinator"):
        t_train_cli.main(["--base", base, "--device", "cpu", "--num_processes", "2"])


def test_pair_graph_cache_is_written_whole(tmp_path, monkeypatch):
    """Ranks build their pair datasets at once, and one may read the pose
    graph cache that another is writing: the cache is written to a file of
    its own and renamed into place, and a second dataset reads it back."""
    from sgam_neurips22_tpu_torch.training.data import pair_dataset
    from test_torch_port_data import _write_scene

    np.save(tmp_path / "K.npy", np.array([[20.0, 0, 15.5], [0, 20.0, 15.5], [0, 0, 1]]))
    _write_scene(tmp_path / "train" / "scene_0000", 6, np.random.default_rng(3), "clevr-infinite")
    renames, replace = [], os.replace
    monkeypatch.setattr(pair_dataset.os, "replace", lambda a, b: renames.append((str(a), str(b))) or replace(a, b))
    built = pair_dataset.ClevrInfinitePairs("train", str(tmp_path), 2, (32, 32))
    cache = tmp_path / "cache" / "scene_0000_graph_train.torch.pkl"
    assert [b for _, b in renames] == [str(cache)] and renames[0][0].endswith(".tmp")
    assert sorted(os.listdir(tmp_path / "cache")) == [cache.name]
    read = pair_dataset.ClevrInfinitePairs("train", str(tmp_path), 2, (32, 32))
    assert len(renames) == 1 and len(read) == len(built) > 0
