"""Checkpoints of the port's trainer, and emergency checkpoints on a
signal — the policies of `sgam_neurips22_tpu/core/checkpoint.py` (a save
interval, keep-last-k, top-k by a monitored metric; SIGUSR1 / SIGTERM) in
the port's own format (orbax is JAX's).

A checkpoint is one directory a step, `<directory>/<step>/`, holding
`last.ckpt` (a `torch.save` dict in the reference's Lightning layout:
`state_dict` with the model's tensors and the discriminator's under
`loss.discriminator.`, `optimizer_states`, `global_step`, and the port's
own entries) and, for a top-k manager, `metrics.json`. The file is written
to a temporary name and renamed into place, so a step directory without
`last.ckpt` (a save cut short) is no checkpoint. A checkpoint is
unpickled whole on restore: load only directories you trust.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import signal
from typing import Any, Callable, Dict, List, Optional

import torch

CKPT_FILE = "last.ckpt"
METRICS_FILE = "metrics.json"

# Python runs a signal handler on the main thread between bytecodes, so one
# can fire inside a save, or inside a train step that updates the state in
# place. A handler that saved there would write a torn state or collide
# with the interrupted write; both run as a critical section, and the
# handler defers its action until the section has ended.
_IN_SAVE = False
_DEFERRED: List[Callable[[], None]] = []


def _run_deferred() -> None:
    while _DEFERRED:
        _DEFERRED.pop(0)()


@contextlib.contextmanager
def critical_section():
    """Defer a checkpoint signal's action to the end of the enclosed code."""
    global _IN_SAVE
    outer, _IN_SAVE = _IN_SAVE, True
    try:
        yield
    finally:
        _IN_SAVE = outer
        if not outer:
            _run_deferred()


def complete_steps(directory: str) -> List[int]:
    """The steps under `directory` whose checkpoint file is complete, in
    increasing order."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(n) for n in os.listdir(directory)
                  if n.isdigit() and os.path.isfile(os.path.join(directory, n, CKPT_FILE)))


class CheckpointManager:
    """Step-interval and keep-last-k policies; with `monitor`, keeps the
    top-k checkpoints by that metric instead (`best_mode` 'min' keeps the
    smallest values, 'max' the largest), given as `metrics` to `save`."""

    def __init__(self, directory: str, save_interval_steps: int = 10_000, max_to_keep: int = 3,
                 monitor: Optional[str] = None, best_mode: str = "min"):
        if best_mode not in ("min", "max"):
            raise ValueError(f"best_mode must be 'min' or 'max', got {best_mode!r}")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.save_interval_steps = save_interval_steps
        self.max_to_keep = max_to_keep
        self.monitor = monitor
        self.best_mode = best_mode

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self) -> List[int]:
        return complete_steps(self.directory)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def should_save(self, step: int) -> bool:
        """Whether save(step) would write: always with no checkpoint yet,
        else at a multiple of the interval past the latest (orbax's rule)."""
        latest = self.latest_step()
        if latest is None:
            return True
        return step > latest and step % self.save_interval_steps == 0

    def save(self, step: int, state: Dict[str, Any], force: bool = False,
             metrics: Optional[Dict[str, float]] = None) -> bool:
        """Write `state` (a dict of tensors and plain values, as
        `torch.save` takes it) as step `step` unless the policy says no;
        then drop the checkpoints the policy no longer keeps."""
        if not force and not self.should_save(step):
            return False
        with critical_section():
            d = self.step_dir(step)
            os.makedirs(d, exist_ok=True)
            if metrics is not None:
                with open(os.path.join(d, METRICS_FILE), "w") as f:
                    json.dump({k: float(v) for k, v in metrics.items()}, f)
            tmp = os.path.join(d, f"{CKPT_FILE}.{os.getpid()}.tmp")
            torch.save(state, tmp)
            os.replace(tmp, os.path.join(d, CKPT_FILE))
            self._retain()
        return True

    def _metric(self, step: int) -> Optional[float]:
        try:
            with open(os.path.join(self.step_dir(step), METRICS_FILE)) as f:
                return float(json.load(f)[self.monitor])
        except (OSError, KeyError, ValueError):
            return None

    def _retain(self) -> None:
        steps = self.all_steps()
        if self.monitor is None:
            keep = steps[-self.max_to_keep:]
        else:
            scored = [(m, s) for s in steps if (m := self._metric(s)) is not None]
            scored.sort(key=lambda ms: ms[0], reverse=self.best_mode == "max")
            keep = [s for _, s in scored[: self.max_to_keep]]
        for s in steps:
            if s not in keep:
                shutil.rmtree(self.step_dir(s), ignore_errors=True)

    def restore(self, step: Optional[int] = None, map_location: Any = "cpu") -> Dict[str, Any]:
        """The saved dict of `step` (the latest by default)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(os.path.join(self.step_dir(step), CKPT_FILE), map_location=map_location,
                          weights_only=False)

    def restore_raw(self, step: Optional[int] = None) -> Dict[str, Any]:
        """The saved dict as it is, on the CPU."""
        return self.restore(step)


def checkpoint_file(path: str) -> Optional[str]:
    """The `last.ckpt` of the latest step under a port run directory, its
    `checkpoints/` or a step directory; None if `path` holds none."""
    if os.path.isfile(os.path.join(path, CKPT_FILE)):
        return os.path.join(path, CKPT_FILE)
    sub = os.path.join(path, "checkpoints")
    ckdir = sub if os.path.isdir(sub) else path
    steps = complete_steps(ckdir)
    return os.path.join(ckdir, str(steps[-1]), CKPT_FILE) if steps else None


def install_signal_checkpoint(save_fn: Callable[[], None]) -> None:
    """SIGUSR1 writes an emergency checkpoint and training goes on (the
    reference's `melk`); SIGTERM writes one and exits with 143
    (preemption). A signal that arrives during a save acts after it."""

    def action(signum):
        print(f"signal {signum}: writing emergency checkpoint", flush=True)
        save_fn()
        if signum == signal.SIGTERM:
            raise SystemExit(143)

    def handler(signum, frame):
        if _IN_SAVE:
            _DEFERRED.append(lambda: action(signum))
            return
        action(signum)

    signal.signal(signal.SIGUSR1, handler)
    signal.signal(signal.SIGTERM, handler)
