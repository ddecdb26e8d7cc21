"""Training orchestrator — port of `sgam_neurips22_tpu/training/trainer.py`
(the reference's train harness and its callbacks): config-driven model and
data, LR scaling accumulate x batch x base, interval and top-k checkpoints,
an emergency checkpoint on SIGUSR1 / SIGTERM / a crash between steps, image grids and
metric logs, validation each epoch, and the online k-means refresh.

One device, or one rank of a data-parallel process group
(`parallel.distributed`; the train CLI's --n_devices launches the ranks):
the trainer's mesh then spans every rank, `batch_size` is the global batch
(each rank decodes its slice), the state starts as rank 0's, and the step
is global (`training.train_step`). Rank 0 alone writes the config
snapshot, metrics, images, checkpoints and best_vals.json; the others
record each save and wait at a barrier where the JAX package's
cooperative save would. Validation sums the codebook histogram and
averages the logged means over the ranks, so every rank takes the same
best-checkpoint decision. The emergency save of a multi-rank run is rank
0's alone, with no collective (its peers may be gone): `emergency_state.ckpt`
in the run directory, which `resume` prefers when it is newer.

The train loop reads nothing from the device on a step that logs nothing
(metrics every 50 steps, images at `ImageLogger`'s steps); the k-means
trigger reads its inactive count only on steps that pass its frequency
check.
"""
from __future__ import annotations

import json
import os
import pickle
import time
from dataclasses import replace
from typing import Any, Dict, Optional

import numpy as np
import torch

from sgam_neurips22_tpu_torch.core.checkpoint import CheckpointManager, critical_section, install_signal_checkpoint
from sgam_neurips22_tpu_torch.core.config import ConfigDict, save_yaml
from sgam_neurips22_tpu_torch.core.state_dict import from_jax_params, load_into
from sgam_neurips22_tpu_torch.models.vqgan.model import VQModelConfig
from sgam_neurips22_tpu_torch.parallel import distributed
from sgam_neurips22_tpu_torch.parallel.distributed import barrier, is_primary, replicate_global, shard_local_batch
from sgam_neurips22_tpu_torch.parallel.mesh import make_mesh
from sgam_neurips22_tpu_torch.serving import load_inference_params
from sgam_neurips22_tpu_torch.training.data.datamodule import DataModule
from sgam_neurips22_tpu_torch.training.kmeans import refresh_codebook, should_refresh
from sgam_neurips22_tpu_torch.training.losses import LossConfig
from sgam_neurips22_tpu_torch.training.lpips import LPIPS, random_lpips
from sgam_neurips22_tpu_torch.training.train_step import (
    OnlineKMeansConfig,
    SchedulerConfig,
    TrainConfig,
    create_train_state,
    eval_step,
    model_inputs,
    train_step,
)
from sgam_neurips22_tpu_torch.utils.logging import ImageLogger, MetricLogger

TOP_K = 3  # best checkpoints kept by the monitored metric
LOG_EVERY = 50  # steps between metric logs
EMERGENCY_FILE = "emergency_state.ckpt"  # a multi-rank run's emergency checkpoint, rank 0's


def monitor_improves(val: float, kept: list, mode: str, top_k: int = TOP_K) -> bool:
    """Would `val` enter the kept top-k? 'min' keeps the smallest values,
    'max' the largest (the reference ModelCheckpoint's modes)."""
    if len(kept) < top_k:
        return True
    return val < max(kept) if mode == "min" else val > min(kept)


def train_config_from_yaml(cfg: ConfigDict) -> TrainConfig:
    """TrainConfig from a reference-schema YAML tree."""
    mp, dp = cfg.model.params, cfg.data.params
    return TrainConfig(
        model=VQModelConfig.from_config(mp, dp),
        loss=LossConfig.from_dict(dict(mp.lossconfig.params)),
        learning_rate=float(cfg.model.get("base_learning_rate", 4.5e-6)),
        online_kmeans=OnlineKMeansConfig.from_dict(dict(mp.get("online_kmeans_config") or {})),
        lr_scheduler=SchedulerConfig.from_dict(dict(mp.get("lr_scheduler_config") or {})),
    )


def load_codebook_init(path: str, n_embed: int, embed_dim: int) -> torch.Tensor:
    """Codebook rows from a k-means .npy file (the reference's
    `kmean_init_codebook_path`)."""
    kd = np.load(path)
    if kd.shape != (n_embed, embed_dim):
        raise ValueError(f"codebook init {path} has shape {kd.shape}, expected {(n_embed, embed_dim)}")
    return torch.from_numpy(kd.astype(np.float32))


class Trainer:
    def __init__(
        self,
        cfg: ConfigDict,
        logdir: str,
        seed: int = 23,
        n_devices: Optional[int] = None,
        accumulate_grad_batches: int = 1,
        use_wandb: bool = True,
        lpips_weights: Optional[str] = None,
        max_steps: Optional[int] = None,
        install_signals: bool = True,
        device: str | torch.device = "cuda",
    ):
        self.cfg = cfg
        self.logdir = logdir
        self.max_steps = max_steps
        self.mesh = make_mesh(n_devices, device)
        self.device = self.mesh.device
        self._primary = is_primary()
        bs = int(cfg.data.params.batch_size)
        if bs % self.mesh.size:
            # a process group cannot shrink (the launcher picks the rank count)
            raise ValueError(f"batch_size {bs} must be divisible by the {self.mesh.size}-rank data mesh")
        if self._primary:
            os.makedirs(logdir, exist_ok=True)
            save_yaml(cfg, os.path.join(logdir, "config.yaml"))

        base = train_config_from_yaml(cfg)
        # bs is the global batch, so the rank count is already inside it
        lr = accumulate_grad_batches * bs * base.learning_rate
        self.train_cfg = replace(base, learning_rate=lr, accumulate_grad_batches=accumulate_grad_batches)
        print(f"lr = {lr:.3e} = {accumulate_grad_batches} (accum) x {bs} (global batch = {self.mesh.size} ranks x "
              f"{bs // self.mesh.size}) x {base.learning_rate:.3e}")

        self.state = create_train_state(self.train_cfg, seed=seed, device=self.device)
        model = self.state.model
        km_path = (cfg.model.params.get("online_kmeans_config") or {}).get("kmean_init_codebook_path")
        if km_path and os.path.exists(km_path):
            with torch.no_grad():
                model.codebook.copy_(load_codebook_init(km_path, self.train_cfg.model.n_embed,
                                                        self.train_cfg.model.embed_dim))
            print(f"initialized codebook from {km_path}")
        # warm start (the reference's ckpt_path with ignore_keys
        # ['loss.discriminator']) from a reference .ckpt or a port run
        # directory: a tensor of another shape (the codebook phase's 4-channel
        # conv_in against the conditional 5) keeps its fresh init
        ckpt_path = cfg.model.params.get("ckpt_path")
        if ckpt_path and os.path.exists(ckpt_path):
            load_inference_params(ckpt_path, model)
            print(f"warm-started model weights from {ckpt_path}")

        if lpips_weights and os.path.exists(lpips_weights):
            # an init_lpips-layout tree of numpy arrays (tools/convert_lpips.py)
            with open(lpips_weights, "rb") as f:
                self.lpips = load_into(LPIPS(), from_jax_params(pickle.load(f)))
            print(f"loaded LPIPS weights from {lpips_weights}")
        else:
            self.lpips = random_lpips(1)
            if self.train_cfg.loss.perceptual_weight > 0:
                print("WARNING: using a randomly initialized LPIPS backbone")
        for module in (model, self.state.disc, self.lpips):
            replicate_global(module, self.mesh)  # rank 0's values on every rank

        self.data = DataModule(device_put=lambda b: shard_local_batch(b, self.mesh), process_count=self.mesh.size,
                               process_index=self.mesh.rank, **dict(cfg.data.params))
        self.metrics = MetricLogger(logdir, use_wandb=use_wandb) if self._primary else None
        self.images = ImageLogger(logdir, wandb_run=self.metrics.wandb if self.metrics else None)
        self.ckpt = CheckpointManager(os.path.join(logdir, "checkpoints"), save_interval_steps=10_000,
                                      writer=self._primary)
        self.monitor = cfg.model.params.get("monitor", "val/rec_loss")
        self.monitor_mode = str(cfg.model.params.get("monitor_mode", "min"))
        if self.monitor_mode not in ("min", "max"):
            raise ValueError(f"monitor_mode must be 'min' or 'max', got {self.monitor_mode!r}")
        self.best_ckpt = CheckpointManager(os.path.join(logdir, "checkpoints_best"), save_interval_steps=1,
                                           max_to_keep=TOP_K, monitor=self.monitor, best_mode=self.monitor_mode,
                                           writer=self._primary)
        # the top-k gate's values persist beside the checkpoints, so a
        # resumed run does not save again for validations that cannot enter
        self._best_vals_path = os.path.join(logdir, "best_vals.json")
        self._best_vals: list = []
        try:
            if self.best_ckpt.latest_step() is not None:
                with open(self._best_vals_path) as f:
                    self._best_vals = sorted(json.load(f), reverse=self.monitor_mode == "max")[:TOP_K]
        except (OSError, ValueError):
            pass
        if install_signals:
            install_signal_checkpoint(self._emergency_save)
        self._kmeans_gen = torch.Generator().manual_seed(seed + 7)
        self.refreshes: list = []  # one record per k-means refresh
        self._in_step = False  # set while a refresh and train step change the state
        barrier()  # every rank has read the run directory before rank 0 writes to it

    # ------------------------------------------------------------------
    def checkpoint_dict(self) -> Dict[str, Any]:
        """The train state in the reference's Lightning layout, with the
        port's own entries (k-means bookkeeping and its generator, gradient
        accumulators)."""
        st = self.state
        sd = dict(st.model.state_dict())
        sd.update({f"loss.discriminator.{k}": v for k, v in st.disc.state_dict().items()})
        km = st.kmeans
        return {
            "state_dict": sd,
            "optimizer_states": [st.opt_ae.state_dict(), st.opt_disc.state_dict()],
            "global_step": st.step,
            "kmeans": None if km is None else {"timeout": km.timeout, "buffer": km.buffer, "ptr": km.ptr},
            "grad_accumulators": None if st.accumulators is None else [a.state_dict() for a in st.accumulators],
            "kmeans_generator": self._kmeans_gen.get_state(),
        }

    def load_checkpoint_dict(self, ck: Dict[str, Any]) -> None:
        """Put a `checkpoint_dict` back into the train state, in place."""
        st = self.state
        sd = ck["state_dict"]
        prefix = "loss.discriminator."
        st.model.load_state_dict({k: v for k, v in sd.items() if not k.startswith("loss.")})
        st.disc.load_state_dict({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)})
        st.opt_ae.load_state_dict(ck["optimizer_states"][0])
        st.opt_disc.load_state_dict(ck["optimizer_states"][1])
        st.step = int(ck["global_step"])
        if (ck["kmeans"] is None) != (st.kmeans is None):
            raise ValueError("the checkpoint's online k-means state does not match the config's")
        if st.kmeans is not None:
            st.kmeans.timeout.copy_(ck["kmeans"]["timeout"])
            st.kmeans.buffer.copy_(ck["kmeans"]["buffer"])
            st.kmeans.ptr = int(ck["kmeans"]["ptr"])
        if (ck["grad_accumulators"] is None) != (st.accumulators is None):
            raise ValueError("the checkpoint's gradient accumulation does not match accumulate_grad_batches")
        for acc, acc_sd in zip(st.accumulators or (), ck["grad_accumulators"] or ()):
            acc.load_state_dict(acc_sd)
        self._kmeans_gen.set_state(ck["kmeans_generator"].cpu())  # a CPU generator, whatever map_location

    def _emergency_save(self) -> None:
        """Never raises: it runs from signal handlers and crash paths. A step
        cut short by an exception leaves the state torn (the step updates it
        in place: the autoencoder's Adam may have moved while the step count
        has not), so then nothing is written and the latest checkpoint stands.
        With several ranks, rank 0 alone writes EMERGENCY_FILE, with no
        collective: its peers may already be gone."""
        if self._in_step:
            print(f"no emergency checkpoint: step {self.state.step} did not end, the latest checkpoint "
                  f"is step {self.ckpt.latest_step()}", flush=True)
            return
        try:
            step = self.state.step
            if self.mesh.size > 1:
                if self._primary:
                    path = os.path.join(self.logdir, EMERGENCY_FILE)
                    tmp = f"{path}.{os.getpid()}.tmp"
                    torch.save(self.checkpoint_dict(), tmp)
                    os.replace(tmp, path)
                    print(f"emergency checkpoint at step {step}: {path}", flush=True)
                return
            if self.ckpt.latest_step() != step:
                self.ckpt.save(step, self.checkpoint_dict(), force=True)
                print(f"emergency checkpoint at step {step}", flush=True)
        except Exception as e:  # pragma: no cover - best effort
            print(f"emergency checkpoint failed: {e}", flush=True)

    def resume(self) -> None:
        """Continue from the latest checkpoint, or from a multi-rank run's
        emergency checkpoint where that is newer; on every rank."""
        latest = self.ckpt.latest_step()
        path = os.path.join(self.logdir, EMERGENCY_FILE)
        if os.path.isfile(path):
            ck = torch.load(path, map_location=self.device, weights_only=False)
            if latest is None or int(ck["global_step"]) > latest:
                self.load_checkpoint_dict(ck)
                print(f"resumed from the emergency checkpoint at step {self.state.step}")
                return
        if latest is not None:
            self.load_checkpoint_dict(self.ckpt.restore(latest, map_location=self.device))
            print(f"resumed from step {latest}")

    def _maybe_kmeans_refresh(self, step: int) -> None:
        km, ks = self.train_cfg.online_kmeans, self.state.kmeans
        if ks is None or not should_refresh(ks, step, km.inactive_threshold, km.frequency, km.start_global_step):
            return
        t0 = time.perf_counter()
        k = refresh_codebook(self.state.model.codebook, ks, km.online_kmeans_word_timeout, self._kmeans_gen)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        ms = (time.perf_counter() - t0) * 1e3
        self.refreshes.append({"step": step, "codewords": k, "ms": ms})
        print(f"online k-means refresh at step {step}: {k} codewords, {ms:.1f} ms")

    def _step_cfg(self, step: int) -> TrainConfig:
        """The pre-VQ passthrough below vq_step_threshold steps."""
        threshold = self.train_cfg.model.vq_step_threshold
        if threshold and step < threshold:
            return replace(self.train_cfg, use_vq=False)
        return self.train_cfg

    def fit(self, epochs: int = 1) -> None:
        try:
            host_step = self.state.step
            for _ in range(epochs):
                for batch in self.data.train_loader():
                    step = host_step
                    # a checkpoint signal waits for the end of the step; if the
                    # step raises, `_in_step` stays set and nothing is saved
                    with critical_section():
                        self._in_step = True
                        self._maybe_kmeans_refresh(step)
                        self.state, logs = train_step(self.state, batch, self.lpips, self._step_cfg(step))
                        self._in_step = False
                    host_step += 1
                    if step % LOG_EVERY == 0 and self.metrics:
                        logs["lr"] = self.train_cfg.lr_at(step)
                        self.metrics.log(logs, step)
                    if self._primary and self.images.should_log(step):
                        self._log_images(batch, "train", step)  # rank 0's rows
                    # labelled with the post-step counter, as the state's step
                    if self.ckpt.should_save(host_step):
                        self._save(self.ckpt, host_step)
                    if self.max_steps and step >= self.max_steps:
                        self.validate()
                        self.test()
                        self._final_save()
                        return
                self.validate()
            self.test()
            self._final_save()
        except BaseException:
            self._emergency_save()
            raise

    def _save(self, manager: CheckpointManager, step: int, force: bool = False, metrics=None) -> None:
        """A save on every rank: rank 0 writes, the others record it, and
        all meet at a barrier."""
        manager.save(step, self.checkpoint_dict() if self._primary else None, force=force, metrics=metrics)
        barrier()

    def _final_save(self) -> None:
        """The state at the end of fit, whatever the interval, so that a
        resume continues from where training stopped."""
        step = self.state.step
        if self.ckpt.latest_step() != step:
            self._save(self.ckpt, step, force=True)

    def test(self) -> None:
        """The test split (the validation data, as the reference's), with
        the val/* names."""
        self.validate(loader=self.data.test_loader)

    def validate(self, loader=None) -> None:
        """Mean val/* logs over the loader's batches and the codebook usage,
        both over every rank's rows; a best checkpoint when the monitored
        value enters the top k."""
        step = self.state.step
        n_embed = self.train_cfg.model.n_embed
        usage = torch.zeros(n_embed, dtype=torch.int64, device=self.device)
        agg: Dict[str, list] = {}
        n = 0
        for batch in (loader or self.data.val_loader)():
            logs = eval_step(self.state, batch, self.lpips, self.train_cfg)
            usage += torch.bincount(logs.pop("val/indices").reshape(-1).long(), minlength=n_embed)
            for k, v in logs.items():
                agg.setdefault(k, []).append(float(v))
            n += 1
        if not n:
            return
        out = {k: float(np.mean(v)) for k, v in agg.items()}
        group = self.mesh.group
        if group is not None:
            means = torch.tensor(list(out.values()), dtype=torch.float64, device=self.device)
            distributed.all_reduce_mean_([means], group)
            distributed.all_reduce_(usage, group=group)
            out = dict(zip(out, means.tolist()))
        out["val/codebook_active_percentage"] = float((usage > 0).double().mean())
        if self.metrics:
            self.metrics.log(out, step)
            print({k: round(v, 5) for k, v in out.items()})
        if self.monitor in out and self.best_ckpt.latest_step() != step:
            val = out[self.monitor]
            if monitor_improves(val, self._best_vals, self.monitor_mode):
                self._save(self.best_ckpt, step, force=True, metrics=out)
                self._best_vals = sorted([*self._best_vals, val], reverse=self.monitor_mode == "max")[:TOP_K]
                if self._primary:
                    try:
                        with open(self._best_vals_path, "w") as f:
                            json.dump(self._best_vals, f)
                    except OSError:
                        pass

    def _log_images(self, batch: Dict[str, torch.Tensor], split: str, step: int) -> None:
        model = self.state.model
        with torch.no_grad():
            x, x_dst, mask = model_inputs(batch, self.train_cfg)
            if self._step_cfg(step).use_vq:
                xrec = model(x, mask).xrec
            else:
                xrec = model.decode(model.encode_prequant(x, mask))
        host = {k: v.float().cpu().numpy() for k, v in (("x", x), ("xrec", xrec), ("x_dst", x_dst))}
        self.images.log(step, split, {
            "warped_input": host["x"][..., :3], "warped_disparity": host["x"][..., 3:],
            "reconstructions": host["xrec"][..., :3], "reconstruction_disparities": host["xrec"][..., 3:],
            "gt_rgb": host["x_dst"][..., :3], "gt_disparity": host["x_dst"][..., 3:],
        })

    def close(self) -> None:
        if self.metrics:
            self.metrics.close()
