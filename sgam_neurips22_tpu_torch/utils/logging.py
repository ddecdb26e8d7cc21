"""Metric and image logging — port of `sgam_neurips22_tpu/utils/logging.py`
(the reference's WandbLogger and ImageLogger callback): metrics go to a
JSONL file under the run directory, and to wandb where it can be imported
and is asked for; image grids go to PNGs under `images/<split>/` every
`every_n_steps` steps and at log-spaced early steps, written by
`pipeline.png.write_png`."""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np

from sgam_neurips22_tpu_torch.pipeline.png import write_png


class MetricLogger:
    def __init__(self, logdir: str, use_wandb: bool = True, project: str = "SGAM", run_name: Optional[str] = None):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        self.jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self.wandb = None
        if use_wandb:
            try:
                import wandb

                self.wandb = wandb.init(project=project, name=run_name, dir=logdir)
            except Exception:
                self.wandb = None

    def log(self, metrics: Dict[str, object], step: int) -> None:
        """Scalars (numbers or 0-d tensors, read here) at `step`; arrays
        of more dimensions are left out."""
        clean = {k: float(v) for k, v in metrics.items() if np.ndim(v) == 0}
        rec = {"step": int(step), "time": time.time(), **clean}
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()
        if self.wandb is not None:
            self.wandb.log(clean, step=step)

    def close(self) -> None:
        self.jsonl.close()
        if self.wandb is not None:
            self.wandb.finish()


def _to_uint8(img: np.ndarray) -> np.ndarray:
    return np.clip((img + 1.0) / 2.0 * 255.0, 0, 255).astype(np.uint8)


def log_spaced_steps(n: int = 12, base: float = 2.0):
    """The early, log-spaced image-log steps."""
    return sorted({int(base**k) for k in range(n)})


class ImageLogger:
    """PNG strips of each panel (warped input, reconstruction, ground
    truth; RGB and disparity) under logdir/images/<split>/."""

    def __init__(self, logdir: str, every_n_steps: int = 750, max_images: int = 4, wandb_run=None):
        self.dir = os.path.join(logdir, "images")
        self.every = every_n_steps
        self.max_images = max_images
        self.early = set(log_spaced_steps())
        self.wandb = wandb_run

    def should_log(self, step: int) -> bool:
        return step % self.every == 0 or step in self.early

    def log(self, step: int, split: str, panels: Dict[str, np.ndarray]) -> None:
        """panels: name -> [B, H, W, C] arrays in [-1, 1] (C = 3 or 1)."""
        out = os.path.join(self.dir, split)
        os.makedirs(out, exist_ok=True)
        for name, arr in panels.items():
            arr = np.asarray(arr)[: self.max_images]
            if arr.ndim == 3:
                arr = arr[..., None]
            if arr.shape[-1] == 1:
                arr = np.repeat(arr, 3, axis=-1)
            grid = _to_uint8(np.concatenate(list(arr), axis=1))  # side by side
            write_png(os.path.join(out, f"{name}_gs-{step:06d}.png"), grid)
            if self.wandb is not None:
                try:
                    import wandb

                    self.wandb.log({f"{split}/{name}": wandb.Image(grid)}, step=step)
                except Exception:
                    pass
