"""The trainer's host side on one card: what decoding PNGs costs the
loader and the train loop, by the row unfilter that runs, by the
Loader's decode model (threads or processes) and by where the frames come
from.

    python3 -m sgam_neurips22_tpu_torch.studies.trainer_loader [--out DIR]

On a seeded CLEVR-style dataset (`studies/trainer_host.write_train_dataset`,
256^2, 8 + 1 scenes of 18 frames, half the PNGs Paeth-filtered):
1. the Loader's host examples/s after its first batch (batch 16) over
   Paeth-filtered one-PNG examples and over pair examples (a target and 2
   sources), with the shipped C++ row unfilter and with a Python row loop
   (the rejected design: `pipeline/png.py`'s before its unfilter went to
   C++), each decoded on 8 threads and on 8 spawned processes;
2. Trainer.fit against train_step alone (`trainer_host.fit_timing`, one
   synchronize at each end of a 5-step window) at
   configs/conditional_generation/clevr-infinite.yaml, batch 16, with the
   pair data read from PNGs through the C++ unfilter on 8 threads ("png")
   or on 8 worker processes ("png_processes", `data.params.num_workers=8`)
   and from the packed frame store ("store": C++ gathers, no PNG), in
   turns png, png_processes, store, store, png_processes, png; each after
   a warm-up fit of two steps.
Prints one JSON line a measurement; --out DIR also writes
DIR/trainer_loader.json.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

CONDITIONAL_YAML = "configs/conditional_generation/clevr-infinite.yaml"
RES = (256, 256)
MODES = ("png", "png_processes", "store", "store", "png_processes", "png")
WORKERS, BATCH, BATCHES = 8, 16, 4


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def python_unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """The rejected design: the five row filters undone in Python, Average
    and Paeth rows byte by byte under the interpreter lock."""
    out = np.zeros((h + 1, stride), np.uint8)  # row 0: the zero row above the first
    pos = 0
    for y in range(1, h + 1):
        ftype, line = raw[pos], np.frombuffer(raw, np.uint8, stride, pos + 1)
        pos += 1 + stride
        up = out[y - 1]
        if ftype == 0:
            out[y] = line
        elif ftype == 1:  # Sub: a running sum of each byte lane, mod 256
            out[y] = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint64).reshape(-1) & 0xFF
        elif ftype == 2:  # Up
            out[y] = line + up
        elif ftype in (3, 4):  # Average, Paeth: each byte needs its reconstructed left neighbour
            row, prev, filt = bytearray(stride), up.tolist(), line.tolist()
            for x in range(stride):
                a = row[x - bpp] if x >= bpp else 0
                if ftype == 3:
                    row[x] = (filt[x] + ((a + prev[x]) >> 1)) & 0xFF
                else:
                    c = prev[x - bpp] if x >= bpp else 0
                    row[x] = (filt[x] + _paeth(a, prev[x], c)) & 0xFF
            out[y] = np.frombuffer(bytes(row), np.uint8)
        else:
            raise ValueError(f"PNG row {y - 1}: unknown filter type {ftype}")
    return out[1:]


_SHIPPED = None  # pipeline/png.py's own unfilter, once replaced


def _use_unfilter(python: bool) -> None:
    global _SHIPPED
    from sgam_neurips22_tpu_torch.pipeline import png

    if _SHIPPED is None:
        _SHIPPED = png._unfilter
    png._unfilter = python_unfilter if python else _SHIPPED


@contextlib.contextmanager
def unfilter(python: bool):
    _use_unfilter(python)
    try:
        yield
    finally:
        _use_unfilter(False)


class PythonUnfilter:
    """A dataset read through the Python row loop in whichever process
    decodes it (a spawned worker too: the wrapper travels with the
    dataset)."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, i: int, rng=None) -> dict:
        from sgam_neurips22_tpu_torch.training.data.decode import get_example

        _use_unfilter(True)
        return get_example(self.dataset, i, rng)


def loader_rate(ds, processes: bool) -> float:
    """The Loader's host examples/s over BATCHES - 1 batches after the
    first, decoding on WORKERS threads or processes."""
    from sgam_neurips22_tpu_torch.training.data.datamodule import Loader

    it = iter(Loader(ds, BATCH, shuffle=True, seed=0, workers=WORKERS, processes=processes))
    try:
        marks = []
        for _ in range(BATCHES):
            next(it)
            marks.append(time.perf_counter())
    finally:
        it.close()
    return BATCH * (len(marks) - 1) / (marks[-1] - marks[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)

    import torch

    from sgam_neurips22_tpu_torch.core.config import load_configs
    from sgam_neurips22_tpu_torch.core.device import resolve_device
    from sgam_neurips22_tpu_torch.ops import attention, cuda_build, vq, zbuffer
    from sgam_neurips22_tpu_torch.studies.trainer_host import fit_timing, write_train_dataset
    from sgam_neurips22_tpu_torch.training.data import packed
    from sgam_neurips22_tpu_torch.training.data.codebook_dataset import CodebookDataset
    from sgam_neurips22_tpu_torch.training.data.pair_dataset import ClevrInfinitePairs
    from sgam_neurips22_tpu_torch.training.trainer import Trainer

    resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    cuda_build.build("zbuffer_min", "nearest_codeword", "flash_attention_fwd", "flash_attention_dq",
                     "flash_attention_dkv")
    counters = (zbuffer.zbuffer_min, vq.nearest_codeword, attention.flash_attention_fwd,
                attention.flash_attention_dq, attention.flash_attention_dkv)
    report: dict = {"card": card, "loader": {}, "fit": []}
    with tempfile.TemporaryDirectory() as tmp:
        data = Path(tmp) / "data"
        data.mkdir()
        by_filter = write_train_dataset(data, *RES, seed=11)
        (data / "paeth.txt").write_text("\n".join(by_filter["paeth"]))
        datasets = {"png_paeth": CodebookDataset("train", str(data), "clevr-infinite", RES,
                                                 training_images_list_file=str(data / "paeth.txt")),
                    "pairs": ClevrInfinitePairs("train", str(data), 2, RES)}
        for python in (False, True):
            for model in ("threads", "processes"):
                name = f"{'python' if python else 'cpp'}_{model}"
                with unfilter(False):  # put back what a Python-unfilter run on threads patches here
                    rates = {k: loader_rate(PythonUnfilter(ds) if python else ds, model == "processes")
                             for k, ds in datasets.items()}
                report["loader"][name] = rates
                print(json.dumps({"loader_examples_per_s": name, **rates}), flush=True)
        for split in ("train", "val"):
            ds = ClevrInfinitePairs(split, str(data), 2, RES)
            packed.pack_pair_frames(ds, packed.frame_store_path(str(data), split, RES))
        for i, mode in enumerate(MODES):
            cfg = load_configs([CONDITIONAL_YAML], [
                f"data.params.dataset_dir={data}", "model.params.ckpt_path=null",
                f"data.params.packed={'true' if mode == 'store' else 'false'}",
                f"data.params.num_workers={WORKERS if mode == 'png_processes' else 0}"])
            tr = Trainer(cfg, str(Path(tmp) / f"run_{i}_{mode}"), use_wandb=False, install_signals=False,
                         max_steps=1, device="cuda")
            tr.fit(epochs=1)  # warm-up: two steps, validation, test
            rep = fit_timing(tr, counters)
            rep.update(mode=mode, frame_store=tr.data.train_ds.frame_store is not None)
            tr.close()
            report["fit"].append(rep)
            print(json.dumps(rep), flush=True)
            del tr
            gc.collect()
            torch.cuda.empty_cache()
    if args.out:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "trainer_loader.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
