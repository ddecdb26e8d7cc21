"""The port's training entry point (`training/trainer.py`, `train.py`,
`core/checkpoint.py`, the options of `training/train_step.py`) against the
JAX package's on the CPU, at the JAX training tests' TINY size:

- gradient accumulation over 4 steps against `optax.MultiSteps`, the LR
  scheduler's first updates, the pre-VQ passthrough and the k-means
  bookkeeping inside the step, each against the JAX `train_step` (its
  flash attention in interpret mode, as there) under
  tests/test_torch_port_training.py's gates (logs at rtol 1e-4 / atol
  1e-5, Adam moments within MOMENT_TOL of each tensor's largest, weights
  as `_compare_params` states; JAX's weights copied into the port after
  each step, as there);
- `Trainer.fit`'s per-step logs and validation against a JAX `train_step`
  loop over the JAX DataModule's batches from the same state (carried by
  `core/state_dict.load_jax_training`; base LR 1e-6, so that three steps
  of Adam on f32 noise stay far inside the log gates);
- checkpoints bit-exact through a round trip, a resumed run bit-exact with
  an uninterrupted one, SIGUSR1 / SIGTERM, top-k by `monitor_mode`, LR
  scaling, the warm start from a reference-layout `.ckpt` and from a run
  directory, and `generate --config` on a trained run against
  `generate.py` (frames under tests/test_torch_port_generate.py's gates).
"""
import copy
import dataclasses
import json
import os
import signal

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from sgam_neurips22_tpu.training import trainer as j_trainer
from sgam_neurips22_tpu.training.data.datamodule import DataModule as JDataModule
from sgam_neurips22_tpu.training.lpips import init_lpips
from sgam_neurips22_tpu.training.train_step import OnlineKMeansConfig, SchedulerConfig, TrainConfig
from sgam_neurips22_tpu.training.train_step import create_train_state as j_create
from sgam_neurips22_tpu.training.train_step import eval_step as j_eval_step
from sgam_neurips22_tpu.training.train_step import train_step as j_train_step
from sgam_neurips22_tpu_torch import train as t_train_cli
from sgam_neurips22_tpu_torch.core import checkpoint as t_checkpoint
from sgam_neurips22_tpu_torch.core.config import save_yaml
from sgam_neurips22_tpu_torch.core.config import wrap as t_wrap
from sgam_neurips22_tpu_torch.core.state_dict import from_jax_params, load_jax_training
from sgam_neurips22_tpu_torch.training import train_step as t_ts
from sgam_neurips22_tpu_torch.training import trainer as t_trainer
from test_torch_port_generate import _compare_outputs, _run_jax, _run_port, jax_generate  # noqa: F401
from test_torch_port_training import MOMENT_TOL, NOISE, _compare_logs, _compare_params
from test_trainer import make_cfg
from test_torch_port_training import FLASH_MODEL
from test_training import TINY_LOSS, make_image_batch
from torch_port_common import batch_to_torch, port_config, to_numpy_tree

LR = 1e-3
RES = 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread (the tier-1 run's workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lpips_params():
    return init_lpips(jax.random.PRNGKey(42))


@pytest.fixture()
def signals_restored():
    saved = {s: signal.getsignal(s) for s in (signal.SIGUSR1, signal.SIGTERM, signal.SIGUSR2)}
    yield
    for s, h in saved.items():
        signal.signal(s, h)


def _port_cfg(j_cfg):
    from sgam_neurips22_tpu_torch.training.losses import LossConfig

    sched = None if j_cfg.lr_scheduler is None else t_ts.SchedulerConfig(**dataclasses.asdict(j_cfg.lr_scheduler))
    return t_ts.TrainConfig(
        model=port_config(j_cfg.model), loss=LossConfig(**dataclasses.asdict(j_cfg.loss)),
        learning_rate=j_cfg.learning_rate, use_vq=j_cfg.use_vq,
        online_kmeans=t_ts.OnlineKMeansConfig(**dataclasses.asdict(j_cfg.online_kmeans)),
        accumulate_grad_batches=j_cfg.accumulate_grad_batches, lr_scheduler=sched)


def _carry(state, j_state, lp=None, lpips_params=None):
    load_jax_training(state.model, state.disc, *(to_numpy_tree(j_state[k]) for k in
                                                 ("params", "disc_params", "disc_state")),
                      lp, None if lpips_params is None else to_numpy_tree(lpips_params))


def _inner_adam(opt_state):
    """The ScaleByAdamState inside a plain or a MultiSteps optimizer state."""
    return (opt_state.inner_opt_state if hasattr(opt_state, "inner_opt_state") else opt_state)[0]


def _check_state(state, j_state, cfg, n_updates, moment_tol):
    trainable = t_ts.split_params(state.model, cfg.phase)[0]
    disc = list(state.disc.named_parameters())
    for params, opt, j_params, j_opt in ((trainable, state.opt_ae, j_state["params"], j_state["opt_ae"]),
                                         (disc, state.opt_disc, j_state["disc_params"], j_state["opt_disc"])):
        ref = from_jax_params(to_numpy_tree(j_params))
        if n_updates == 0:
            assert not opt.state
            for name, p in params:
                np.testing.assert_array_equal(p.detach().numpy(), ref[name], err_msg=name)
            continue
        adam = _inner_adam(j_opt)
        mu, nu = from_jax_params(to_numpy_tree(adam.mu)), from_jax_params(to_numpy_tree(adam.nu))
        moments = {n: (opt.state[p]["exp_avg"].numpy(), opt.state[p]["exp_avg_sq"].numpy(), mu[n], nu[n])
                   for n, p in params}
        _compare_params(params, ref, moments, n_updates, moment_tol)
        assert all(int(opt.state[p]["step"]) == n_updates for _, p in params)


def _run_both(j_cfg, steps, lpips_params, moment_tol=None):
    """The JAX and the port train_step side by side from one state; per
    step: logs, and the weights and moments after it."""
    cfg = _port_cfg(j_cfg)
    j_state = j_create(jax.random.PRNGKey(0), j_cfg)
    state = t_ts.create_train_state(cfg, seed=0, device="cpu")
    from sgam_neurips22_tpu_torch.training.lpips import LPIPS

    lp = LPIPS()
    _carry(state, j_state, lp, lpips_params)
    j_state = jax.tree_util.tree_map(lambda x: x.copy(), j_state)  # train_step donates its state
    batch = make_image_batch()
    k = j_cfg.accumulate_grad_batches
    moment_tol = moment_tol or MOMENT_TOL[cfg.phase]
    for step in range(1, steps + 1):
        j_state, j_logs = j_train_step(j_state, batch, lpips_params, j_cfg)
        state, logs = t_ts.train_step(state, batch_to_torch(batch), lp, cfg)
        _compare_logs(logs, j_logs)
        assert state.step == int(j_state["step"]) == step
        _check_state(state, j_state, cfg, step // k, moment_tol)
        if k > 1:
            acc = from_jax_params(to_numpy_tree(j_state["opt_ae"].acc_grads))
            for (name, _), a in zip(t_ts.split_params(state.model, cfg.phase)[0], state.accumulators[0].acc):
                big = np.abs(acc[name]).max()
                if big < NOISE:  # a gradient that is zero up to f32 noise, as _compare_params holds it
                    assert np.abs(a.numpy()).max() < NOISE, name
                    continue
                np.testing.assert_allclose(a.numpy(), acc[name], atol=moment_tol * big, rtol=0, err_msg=name)
            assert state.accumulators[0].mini_step == int(j_state["opt_ae"].mini_step) == step % k
        _carry(state, j_state)
    return state, j_state


@pytest.mark.parametrize("sched", [False, True], ids=["accumulate2", "accumulate2_scheduler"])
def test_update_paths_match_jax(sched, lpips_params):
    """Accumulation 2: the mean of two mini-steps applied on every second,
    the running mean in between. With the scheduler (warm-up 2 from
    lr_start 0) the first update, at step 2, has LR 0 and leaves every
    weight as it was; the second has half the LR."""
    accum = 2
    sc = SchedulerConfig(warm_up_steps=2, lr_min=0.0, lr_max=1.0, lr_start=0.0, max_decay_steps=6) if sched else None
    j_cfg = TrainConfig(model=FLASH_MODEL, loss=TINY_LOSS, learning_rate=LR, accumulate_grad_batches=accum,
                        lr_scheduler=sc)
    _run_both(j_cfg, 4, lpips_params)
    cfg = _port_cfg(j_cfg)
    for step in range(6):
        np.testing.assert_allclose(cfg.lr_at(step), float(j_cfg.lr_at(step)), rtol=1e-6)


# Adam moments without quantisation: the whole decoder's backward reaches
# the encoder unquantised, and LPIPS amplifies its rounding, as in the
# conditional phase. Measured worst 3.6e-4 (conv_in.bias); 3.2e-5 with
# perceptual_weight 0.
PASSTHROUGH_MOMENT_TOL = 1e-3


def test_pre_vq_passthrough_and_kmeans_bookkeeping(lpips_params):
    """use_vq off (zero codebook loss, indices 0) with the k-means
    bookkeeping on, two steps: timeouts exact, the buffer's features at
    1e-5, the active share logged (the bookkeeping on real indices runs in
    test_fit_matches_jax_loop)."""
    km = OnlineKMeansConfig(do_online_kmeans_clustering=True, online_kmeans_word_timeout=2,
                            train_feature_buffer_size=3)
    j_cfg = TrainConfig(model=FLASH_MODEL, loss=TINY_LOSS, learning_rate=LR, use_vq=False, online_kmeans=km)
    state, j_state = _run_both(j_cfg, 2, lpips_params, PASSTHROUGH_MOMENT_TOL)
    ks, jks = state.kmeans, j_state["kmeans"]
    np.testing.assert_array_equal(ks.timeout.numpy(), np.asarray(jks.timeout))
    np.testing.assert_allclose(ks.buffer.numpy(), np.asarray(jks.buffer), atol=1e-5, rtol=0)
    assert ks.ptr == int(jks.ptr) == 2


# ---------------------------------------------------------------- the Trainer
def _dataset(root, n_train=8, n_val=4):
    rng = np.random.default_rng(0)
    scene = root / "train" / "scene"
    os.makedirs(scene)
    np.save(root / "K.npy", np.array([[20.0, 0, 15.5], [0, 20.0, 15.5], [0, 0, 1]]))
    paths = []
    for i in range(max(n_train, n_val)):
        Image.fromarray(rng.uniform(0, 255, (RES, RES, 3)).astype(np.uint8)).save(scene / f"im_{i:05d}.png")
        np.save(scene / f"dm_{i:05d}.npy", rng.uniform(8, 14, (RES, RES)).astype(np.float32))
        paths.append(str(scene / f"im_{i:05d}.png"))
    (root / "train.txt").write_text("\n".join(paths[:n_train]))
    (root / "val.txt").write_text("\n".join(paths[:n_val]))
    return str(root)


def _cfg(ddir, **params):
    cfg = t_wrap(make_cfg(ddir).to_plain())
    cfg.model.params.update(params)
    return cfg


def _trainer(cfg, logdir, **kw):
    kw.setdefault("install_signals", False)
    return t_trainer.Trainer(cfg, str(logdir), use_wandb=False, device="cpu", **kw)


def test_fit_matches_jax_loop(tmp_path, lpips_params, monkeypatch):
    """Three steps of Trainer.fit (max_steps 2) with the k-means bookkeeping
    on, each step's logs against JAX's, and the validation's aggregate."""
    cfg = _cfg(_dataset(tmp_path))
    cfg.model.base_learning_rate = 1e-6
    cfg.model.params.online_kmeans_config.frequency = 1000
    tr = _trainer(cfg, tmp_path / "run", max_steps=2)
    j_cfg = dataclasses.replace(j_trainer.train_config_from_yaml(cfg), learning_rate=tr.train_cfg.learning_rate)
    j_state = j_create(jax.random.PRNGKey(0), j_cfg)
    _carry(tr.state, j_state, tr.lpips, lpips_params)
    j_state = jax.tree_util.tree_map(lambda x: x.copy(), j_state)
    seen = []

    def recording_step(*args):
        state, logs = t_ts.train_step(*args)
        seen.append({k: float(v) for k, v in logs.items()})
        return state, logs

    monkeypatch.setattr(t_trainer, "train_step", recording_step)
    tr.fit(epochs=1)
    tr.close()
    dm = JDataModule(**cfg.data.params)
    for step, batch in zip(range(3), dm.train_loader()):
        j_state, j_logs = j_train_step(j_state, batch, lpips_params, j_cfg)
        assert set(seen[step]) == set(j_logs)
        for k in j_logs:
            np.testing.assert_allclose(seen[step][k], float(j_logs[k]), rtol=1e-4, atol=1e-5, err_msg=k)
    assert len(seen) == 3 and tr.state.step == 3
    agg = {}
    for batch in dm.val_loader():
        logs = j_eval_step(j_state, batch, lpips_params, j_cfg)
        logs.pop("val/indices")
        for k, v in logs.items():
            agg.setdefault(k, []).append(float(v))
    lines = [json.loads(x) for x in open(tmp_path / "run" / "metrics.jsonl")]
    val = lines[-1]
    assert lines[0]["step"] == 0 and "lr" in lines[0] and val["step"] == 3
    for k, v in agg.items():
        np.testing.assert_allclose(val[k], np.mean(v), rtol=1e-4, atol=1e-5, err_msg=k)
    assert 0 < val["val/codebook_active_percentage"] <= 1
    assert os.listdir(tmp_path / "run" / "images" / "train")


def _state_equal(a, b):
    """Two checkpoint dicts equal, tensor for tensor."""
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _state_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _state_equal(x, y)
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


def _resume_cfg(ddir):
    cfg = _cfg(ddir)
    cfg.model.params.online_kmeans_config.update(train_feature_buffer_size=2, frequency=2, inactive_threshold=0.0,
                                                 online_kmeans_word_timeout=1)
    return cfg


def test_checkpoint_round_trip_and_resume_bit_exact(tmp_path):
    """Four train examples at batch 2 (an epoch of 2 steps), accumulation 2,
    a k-means refresh at steps 2 and 4. A run stopped at step 2 (its final
    save) and resumed to step 5 ends bit for bit where an uninterrupted run
    to step 5 ends; the checkpoint restores the state it saved."""
    ddir = _dataset(tmp_path, n_train=4, n_val=2)
    whole = _trainer(_resume_cfg(ddir), tmp_path / "whole", max_steps=4, accumulate_grad_batches=2)
    whole.fit(epochs=10)
    assert [r["step"] for r in whole.refreshes] == [2, 4]
    first = _trainer(_resume_cfg(ddir), tmp_path / "split", max_steps=1, accumulate_grad_batches=2)
    first.fit(epochs=10)
    saved = copy.deepcopy(first.checkpoint_dict())
    assert first.ckpt.latest_step() == 2 and saved["global_step"] == 2
    second = _trainer(_resume_cfg(ddir), tmp_path / "split", max_steps=4, accumulate_grad_batches=2)
    second.resume()
    _state_equal(second.checkpoint_dict(), saved)
    second.fit(epochs=10)
    assert second.state.step == whole.state.step == 5
    _state_equal(second.checkpoint_dict(), whole.checkpoint_dict())
    for t in (whole, first, second):
        t.close()


def test_signals_checkpoint(tmp_path, monkeypatch, signals_restored):
    """SIGUSR1 during a step: the checkpoint is written once the step has
    ended, and training goes on; SIGTERM: checkpoint, then exit 143."""
    ddir = _dataset(tmp_path)
    step_fn = t_ts.train_step

    def signalling_step(sig, at):
        def fn(state, *args):
            if state.step == at:
                os.kill(os.getpid(), sig)
            return step_fn(state, *args)
        return fn

    monkeypatch.setattr(t_trainer, "train_step", signalling_step(signal.SIGUSR1, 2))
    tr = _trainer(_cfg(ddir), tmp_path / "usr1", max_steps=4, install_signals=True)
    saved_steps = []
    save = tr.ckpt.save
    monkeypatch.setattr(tr.ckpt, "save", lambda step, *a, **k: saved_steps.append(step) or save(step, *a, **k))
    tr.fit(epochs=10)
    assert saved_steps == [1, 3, 5] and tr.state.step == 5  # 1: the interval rule's first save; 3: SIGUSR1
    tr.close()
    monkeypatch.setattr(t_trainer, "train_step", signalling_step(signal.SIGTERM, 0))
    tr = _trainer(_cfg(ddir), tmp_path / "term", max_steps=4, install_signals=True)
    with pytest.raises(SystemExit) as exc:
        tr.fit(epochs=10)
    assert exc.value.code == 143 and tr.ckpt.all_steps() == [1]
    tr.close()


def test_crash_mid_step_writes_no_torn_checkpoint(tmp_path, signals_restored):
    """An exception inside the discriminator's update, after the
    autoencoder's Adam has moved, with a SIGUSR1 deferred inside the same
    step: neither the signal nor fit's crash path writes the torn state, and
    the latest checkpoint stays the last whole one."""
    tr = _trainer(_cfg(_dataset(tmp_path)), tmp_path / "crash", max_steps=4, install_signals=True)
    disc_update = tr.state.opt_disc.step

    def failing_update(*args, **kw):
        if tr.state.step == 2:
            os.kill(os.getpid(), signal.SIGUSR1)
            raise RuntimeError("CUDA out of memory (planted)")
        return disc_update(*args, **kw)

    tr.state.opt_disc.step = failing_update
    with pytest.raises(RuntimeError, match="planted"):
        tr.fit(epochs=10)
    assert tr.ckpt.all_steps() == [1] and tr.ckpt.restore()["global_step"] == 1
    tr.close()


def test_signal_during_refresh_waits_for_the_step(tmp_path, monkeypatch, signals_restored):
    """SIGUSR1 between the refresh's codebook and timeout writes: the
    checkpoint is written after the step that the refresh opens (step 3),
    not from its middle (step 2), and holds the state as it then is."""
    refresh = t_trainer.refresh_codebook

    def signalling_refresh(*args):
        os.kill(os.getpid(), signal.SIGUSR1)
        return refresh(*args)

    monkeypatch.setattr(t_trainer, "refresh_codebook", signalling_refresh)
    tr = _trainer(_resume_cfg(_dataset(tmp_path)), tmp_path / "refresh", max_steps=3, install_signals=True)
    saved = {}
    save = tr.ckpt.save

    def recording_save(step, st, *a, **k):
        saved[step] = copy.deepcopy(st)
        return save(step, st, *a, **k)

    monkeypatch.setattr(tr.ckpt, "save", recording_save)
    tr.fit(epochs=10)
    assert [r["step"] for r in tr.refreshes] == [2] and sorted(saved) == [1, 3, 4]
    assert saved[3]["global_step"] == 3
    _state_equal(tr.ckpt.restore(4), tr.checkpoint_dict())
    tr.close()


def test_signal_during_save_is_deferred(tmp_path):
    ran = []
    mgr = t_checkpoint.CheckpointManager(str(tmp_path / "ck"), save_interval_steps=1)
    t_checkpoint._DEFERRED.append(lambda: ran.append(mgr.latest_step()))
    mgr.save(0, {"a": torch.zeros(2)}, force=True)
    assert ran == [0] and not t_checkpoint._DEFERRED


@pytest.mark.parametrize("mode", ["min", "max"])
def test_top_k_by_monitor_mode(tmp_path, mode):
    """The kept checkpoints are the top k by the metric in its direction;
    the host gate agrees with JAX's."""
    mgr = t_checkpoint.CheckpointManager(str(tmp_path / "best"), save_interval_steps=1, max_to_keep=2,
                                         monitor="m", best_mode=mode)
    for step, m in enumerate([3.0, 1.0, 4.0, 2.0]):
        mgr.save(step, {"s": step}, metrics={"m": m}, force=True)
    assert mgr.all_steps() == ([1, 3] if mode == "min" else [0, 2])
    assert mgr.restore(mgr.latest_step()) == {"s": mgr.latest_step()}
    for val, kept in ((1.5, [1.0, 2.0, 3.0]), (3.5, [1.0, 2.0, 3.0]), (0.5, []), (2.5, [1.0, 2.0])):
        assert t_trainer.monitor_improves(val, kept, mode) == j_trainer.monitor_improves(val, kept, mode)
    interval = t_checkpoint.CheckpointManager(str(tmp_path / "iv"), save_interval_steps=10, max_to_keep=2)
    assert interval.should_save(3)
    for step in (3, 10, 20, 30):
        interval.save(step, {"s": step})
    assert interval.all_steps() == [20, 30] and not interval.should_save(35) and interval.should_save(40)


def test_trainer_best_checkpoints_and_options(tmp_path):
    """monitor_mode threads to the best checkpoints and best_vals.json; LR
    = accumulate x batch x base; an unknown mode raises, and so does
    n_devices > 1 in a plain process (each device is a rank of its own,
    started by `parallel.distributed.launch` or the CLI's --n_devices:
    tests/test_torch_port_parallel*.py)."""
    ddir = _dataset(tmp_path)
    cfg = _cfg(ddir, monitor="val/rgb_l1", monitor_mode="max")
    tr = _trainer(cfg, tmp_path / "run", accumulate_grad_batches=2)
    assert tr.train_cfg.learning_rate == pytest.approx(2 * 2 * 1e-4)
    assert tr.train_cfg.accumulate_grad_batches == 2
    tr.validate()
    tr.state.step += 1
    tr.validate()
    assert tr.best_ckpt.all_steps() == [0, 1]
    assert json.load(open(tmp_path / "run" / "best_vals.json")) == sorted(tr._best_vals, reverse=True)
    tr.close()
    with pytest.raises(ValueError, match="--n_devices"):
        _trainer(cfg, tmp_path / "dp", n_devices=2)
    with pytest.raises(ValueError, match="monitor_mode"):
        _trainer(_cfg(ddir, monitor_mode="up"), tmp_path / "mm")


def test_warm_start_from_reference_ckpt_and_run_dir(tmp_path):
    """A reference-layout .ckpt: every model tensor of the same shape is
    taken, conv_in of another shape keeps its init, the discriminator is
    not loaded; a port run directory works the same; a missing path is
    skipped."""
    ddir = _dataset(tmp_path)
    src = _trainer(_cfg(ddir), tmp_path / "src", seed=5)
    sd = {k: v.clone() for k, v in src.state.model.state_dict().items()}
    sd["conv_in.weight"] = torch.ones(4, 4, 1, 1)
    sd.update({f"loss.discriminator.{k}": v + 1 for k, v in src.state.disc.state_dict().items()})
    sd["loss.perceptual_loss.lin0.model.1.weight"] = torch.zeros(1)
    torch.save({"state_dict": sd, "global_step": 9}, tmp_path / "ref.ckpt")
    src.ckpt.save(0, src.checkpoint_dict(), force=True)
    own = src.state.model.state_dict()
    for path, source in ((str(tmp_path / "ref.ckpt"), sd), (str(tmp_path / "src"), own)):
        tr = _trainer(_cfg(ddir, ckpt_path=path), tmp_path / "warm")
        fresh = _trainer(_cfg(ddir), tmp_path / "fresh")
        for k, v in tr.state.model.state_dict().items():
            want = fresh.state.model.state_dict()[k] if source[k].shape != v.shape else source[k]
            assert torch.equal(v, want), k
        assert torch.equal(tr.state.model.conv_in.weight, fresh.state.model.conv_in.weight) == (source is sd)
        assert all(torch.equal(a, b) for a, b in zip(tr.state.disc.state_dict().values(),
                                                      fresh.state.disc.state_dict().values()))
        tr.close()
        fresh.close()
    tr = _trainer(_cfg(ddir, ckpt_path=str(tmp_path / "missing.ckpt")), tmp_path / "skip")
    tr.close()
    src.close()


def test_codebook_and_lpips_initial_weights(tmp_path, lpips_params):
    """`kmean_init_codebook_path` sets the codebook from a .npy (a wrong
    shape raises); `lpips_weights` loads an init_lpips-layout pickle (the
    JAX trainer's format) into the port's LPIPS."""
    import pickle

    ddir = _dataset(tmp_path)
    rows = np.random.default_rng(3).normal(size=(32, 32)).astype(np.float32)
    np.save(tmp_path / "km.npy", rows)
    with open(tmp_path / "lpips.pkl", "wb") as f:
        pickle.dump(to_numpy_tree(lpips_params), f)
    cfg = _cfg(ddir)
    cfg.model.params.online_kmeans_config.kmean_init_codebook_path = str(tmp_path / "km.npy")
    tr = _trainer(cfg, tmp_path / "run", lpips_weights=str(tmp_path / "lpips.pkl"))
    np.testing.assert_array_equal(tr.state.model.codebook.detach().numpy(), rows)
    want = from_jax_params(to_numpy_tree(lpips_params))
    assert all(np.array_equal(v.numpy(), want[k]) for k, v in tr.lpips.state_dict().items())
    tr.close()
    np.save(tmp_path / "km.npy", rows[:8])
    with pytest.raises(ValueError, match="codebook init"):
        _trainer(cfg, tmp_path / "bad")


def test_train_cli_and_generate_config(tmp_path, jax_generate, signals_restored):  # noqa: F811
    """`python -m sgam_neurips22_tpu_torch.train` (main) trains a codebook
    run and resumes it with -r; `generate --config <run>/config.yaml --ckpt
    <run>` then writes the frames that generate.py writes from the same
    YAML and the run's checkpoint file."""
    ddir = _dataset(tmp_path)
    cfg = _cfg(ddir)
    cfg.data.params.update(dataset_dir=ddir)
    base = str(tmp_path / "base.yaml")
    save_yaml(cfg, base)
    tr = t_train_cli.main(["--base", base, "--device", "cpu", "--max_steps", "1", "--no_wandb",
                           "-l", str(tmp_path / "logs"), "-n", "cb", "model.base_learning_rate=1e-3"])
    assert tr.state.step == 2 and tr.logdir.endswith("_cb") and tr.train_cfg.learning_rate == 2e-3
    again = t_train_cli.main(["-r", tr.logdir, "--device", "cpu", "--max_steps", "1", "--no_wandb"])
    assert again.state.step == 3 and again.ckpt.latest_step() == 3
    with pytest.raises(ValueError, match="coordinator"):  # several hosts need process 0's address
        t_train_cli.main(["--base", base, "--num_processes", "2"])
    tdir = tmp_path / "templates"
    os.makedirs(tdir)
    rng = np.random.default_rng(12)
    Image.fromarray(rng.integers(0, 256, (RES, RES, 3), dtype=np.uint8)).save(tdir / "im_00000_00_00.png")
    np.save(tdir / "dm_00000_00_00.npy", rng.uniform(8, 14, (RES, RES)).astype(np.float32))
    ckpt_file = t_checkpoint.checkpoint_file(tr.logdir)
    common = ["--config", os.path.join(tr.logdir, "config.yaml"), "--template_dir", str(tdir), "--rows", "2",
              "--cols", "1", "--resolution", str(RES), "--num_src", "2"]
    _run_jax(jax_generate, [*common, "--ckpt", ckpt_file, "--output_dir", str(tmp_path / "jax")])
    _run_port([*common, "--ckpt", tr.logdir, "--output_dir", str(tmp_path / "port")])
    names = _compare_outputs(tmp_path / "jax", tmp_path / "port")
    assert sum(n.startswith("im_") for n in names) == 2
