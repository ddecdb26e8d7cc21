"""Training from the command line: config-driven codebook or
conditional-generation training (the port of the repository's
`train.py`, with the same flags).

Usage:
  python -m sgam_neurips22_tpu_torch.train --base configs/codebooks/clevr-infinite.yaml \\
      [data.params.dataset_dir=/path/to/data] [model.params.xyz=...] [--device cpu]

The YAMLs of --base merge left to right, then the `key=value` overrides
apply. `-r <run dir>` resumes a run from its config.yaml and latest
checkpoint. `--device` picks the card (`cuda`, the default) or the CPU.

Data parallelism, with the JAX train.py's flags and meaning (one rank a
device, `parallel.distributed`): `--n_devices N` launches N ranks on this
host (all of its cards by default on `cuda`, one on the CPU; N shrinks to
gcd(batch, N) when the batch does not divide, as the JAX mesh does), over
NCCL on cards and gloo on the CPU; `data.params.batch_size` is the global
batch. `--coordinator host:port --num_processes P --process_id i` (or
SGAM_COORDINATOR / SGAM_NUM_PROCESSES / SGAM_PROCESS_ID) run one such
launcher on each of P hosts, each driving all of its host's cards: global
rank = process_id x local ranks + local rank. Every rank takes rank 0's run
name, so a run has one directory, and `-r` resumes on every rank.
"""
from __future__ import annotations

import argparse
import datetime
import math
import os
import signal

from sgam_neurips22_tpu_torch.core.config import load_configs
from sgam_neurips22_tpu_torch.parallel import distributed

# the hand kernels of the training step, built once by the launcher before it spawns the ranks
TRAIN_KERNELS = ("zbuffer_min", "nearest_codeword", "flash_attention_fwd", "flash_attention_dq",
                 "flash_attention_dkv")


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-b", "--base", nargs="*", default=[], help="YAML config(s), merged left-to-right")
    p.add_argument("-t", "--train", action="store_true", default=True)
    p.add_argument("-r", "--resume", default="", help="resume from a run directory")
    p.add_argument("-n", "--name", default="", help="run name suffix")
    p.add_argument("-s", "--seed", type=int, default=23)
    p.add_argument("-l", "--logdir", default="logs")
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--n_devices", type=int, default=None,
                   help="ranks (one a device): this host's with one launcher, the whole world's with several")
    p.add_argument("--accumulate_grad_batches", type=int, default=1)
    p.add_argument("--lpips_weights", default="weights/lpips.pkl")
    p.add_argument("--remat", action="store_true",
                   help="rematerialise the encoder and decoder levels on the backward pass")
    p.add_argument("--no_wandb", action="store_true")
    p.add_argument("--debug", action="store_true", help="post-mortem pdb on a crash")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # several hosts: run the same command on every host with its --process_id
    p.add_argument("--coordinator", default=None, help="host:port of process 0 (enables several hosts)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    return p


def run_name(cfg, opt) -> str:
    """The run's name: a timestamp, the values of the log_keywords key
    paths, and the --name suffix."""
    parts = []
    for key in str(cfg.get("log_keywords", "")).split(","):
        key = key.strip()
        if key:
            val = cfg.get_path(key)
            if val is not None:
                parts.append(f"{key.split('.')[-1]}={val}")
    now = datetime.datetime.now().strftime("%Y-%m-%dT%H-%M-%S")
    return "_".join([now, *parts, opt.name]).rstrip("_")


def _config(opt, unknown):
    """The run's config: a resumed run's config.yaml (and --base), or --base;
    then the dotlist overrides."""
    if opt.resume:
        if not os.path.isdir(opt.resume):
            raise FileNotFoundError(f"-r {opt.resume}: not a run directory")
        return load_configs([os.path.join(opt.resume, "config.yaml"), *opt.base], unknown)
    return load_configs(opt.base, unknown)


def _ranks(opt, cfg):
    """(local ranks, launch keywords), or None for one plain process."""
    import torch

    multi = dict(zip(("coordinator", "num_processes", "process_id"),
                     distributed.cluster(opt.coordinator, opt.num_processes, opt.process_id)))
    on_card = torch.device(opt.device).type == "cuda"
    bs = int(cfg.data.params.batch_size)
    if multi["coordinator"] is None and multi["num_processes"] is None:
        n = opt.n_devices or (torch.cuda.device_count() if on_card and torch.cuda.is_available() else 1)
        if bs % n:
            # the global batch must split evenly over the ranks
            print(f"batch_size {bs} not divisible by {n} devices; using {math.gcd(bs, n)} ranks")
            n = math.gcd(bs, n)
        return None if n == 1 else (n, {})
    if multi["coordinator"] is None:
        raise ValueError("--num_processes needs --coordinator host:port (process 0's)")
    local = torch.cuda.device_count() if on_card else 1
    world = (multi["num_processes"] or 1) * local
    if opt.n_devices is not None and opt.n_devices != world:
        raise ValueError(f"--n_devices {opt.n_devices} on {world} devices of {multi['num_processes']} hosts: a "
                         "multi-host mesh must use all devices (omit --n_devices)")
    if bs % world:
        raise ValueError(f"batch_size {bs} must be divisible by the {world}-device global mesh")
    return local, multi


def _train(opt, cfg):
    """Train in this process (one device, or one rank); returns the Trainer.
    Every rank takes rank 0's run name."""
    from sgam_neurips22_tpu_torch.training.trainer import Trainer

    logdir = opt.resume or os.path.join(opt.logdir, distributed.broadcast_object(run_name(cfg, opt)))

    def _usr2(signum, frame):  # SIGUSR2: a debugger at the current frame
        import pdb

        print("SIGUSR2: entering pdb at the current frame (c to continue)")
        pdb.Pdb().set_trace(frame)

    signal.signal(signal.SIGUSR2, _usr2)
    # the launcher has settled the rank count: the mesh spans every rank
    trainer = Trainer(cfg, logdir, seed=opt.seed, accumulate_grad_batches=opt.accumulate_grad_batches,
                      use_wandb=not opt.no_wandb and not opt.debug, lpips_weights=opt.lpips_weights,
                      max_steps=opt.max_steps, device=opt.device)
    if opt.resume:
        trainer.resume()
    try:
        trainer.fit(epochs=opt.epochs)
    except Exception:
        if opt.debug:
            import pdb
            import traceback

            traceback.print_exc()
            pdb.post_mortem()
        raise
    finally:
        trainer.close()
    return trainer


def main(argv=None):
    """Train. Returns the Trainer of a one-process run; None once the ranks
    it launched have ended."""
    opt, unknown = get_parser().parse_known_args(argv)
    if opt.remat:
        unknown = [*unknown, "model.params.ddconfig.remat=true"]
    cfg = _config(opt, unknown)  # read once, here: rank 0 rewrites a resumed run's config.yaml
    ranks = _ranks(opt, cfg)
    if ranks is None:
        return _train(opt, cfg)
    n_local, multi = ranks
    on_card = opt.device.startswith("cuda")
    if on_card:
        from sgam_neurips22_tpu_torch.ops import cuda_build

        cuda_build.build(*TRAIN_KERNELS)  # once, here, not by every rank at once
    distributed.launch(_train, n_local, args=(opt, cfg), device=opt.device,
                       torch_threads=None if on_card else max(1, (os.cpu_count() or 1) // n_local), **multi)
    return None


if __name__ == "__main__":
    main()
