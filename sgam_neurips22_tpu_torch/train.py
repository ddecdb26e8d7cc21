"""Training from the command line: config-driven codebook or
conditional-generation training (the port of the repository's
`train.py`, with the same flags).

Usage:
  python -m sgam_neurips22_tpu_torch.train --base configs/codebooks/clevr-infinite.yaml \\
      [data.params.dataset_dir=/path/to/data] [model.params.xyz=...] [--device cpu]

The YAMLs of --base merge left to right, then the `key=value` overrides
apply. `-r <run dir>` resumes a run from its config.yaml and latest
checkpoint. `--device` picks the card (`cuda`, the default) or the CPU.
The multi-process flags raise: data-parallel training (torch DDP) is not
ported yet.
"""
from __future__ import annotations

import argparse
import datetime
import os
import signal

from sgam_neurips22_tpu_torch.core.config import load_configs


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
    p.add_argument("--n_devices", type=int, default=None)
    p.add_argument("--accumulate_grad_batches", type=int, default=1)
    p.add_argument("--lpips_weights", default="weights/lpips.pkl")
    p.add_argument("--remat", action="store_true",
                   help="rematerialise the encoder and decoder levels on the backward pass")
    p.add_argument("--no_wandb", action="store_true")
    p.add_argument("--debug", action="store_true", help="post-mortem pdb on a crash")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    for flag in ("--coordinator", "--num_processes", "--process_id"):
        p.add_argument(flag, default=None, help="multi-process training: not ported yet (raises)")
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


def main(argv=None):
    """Train; returns the Trainer."""
    opt, unknown = get_parser().parse_known_args(argv)
    if any(v is not None for v in (opt.coordinator, opt.num_processes, opt.process_id)):
        raise NotImplementedError("--coordinator / --num_processes / --process_id: multi-process training (torch "
                                  "DDP) is not ported yet (ROADMAP.md, queue item 1.4)")
    if opt.remat:
        unknown = [*unknown, "model.params.ddconfig.remat=true"]
    from sgam_neurips22_tpu_torch.training.trainer import Trainer

    if opt.resume:
        if not os.path.isdir(opt.resume):
            raise FileNotFoundError(f"-r {opt.resume}: not a run directory")
        cfg = load_configs([os.path.join(opt.resume, "config.yaml"), *opt.base], unknown)
        logdir = opt.resume
    else:
        cfg = load_configs(opt.base, unknown)
        logdir = os.path.join(opt.logdir, run_name(cfg, opt))

    def _usr2(signum, frame):  # SIGUSR2: a debugger at the current frame
        import pdb

        print("SIGUSR2: entering pdb at the current frame (c to continue)")
        pdb.Pdb().set_trace(frame)

    signal.signal(signal.SIGUSR2, _usr2)
    trainer = Trainer(cfg, logdir, seed=opt.seed, n_devices=opt.n_devices,
                      accumulate_grad_batches=opt.accumulate_grad_batches,
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


if __name__ == "__main__":
    main()
