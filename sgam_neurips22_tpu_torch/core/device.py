"""Device selection for the port's entry points, and the process-wide f32
matmul precision mode (the counterpart of JAX's
`jax_default_matmul_precision`, which `generate --matmul_precision` sets).

The modes, on a card (cuBLAS matmuls and cuDNN convolutions of f32
tensors):
- `float32`, `highest`: full f32 (TF32 off), the port's parity mode and
  the default of every entry point but `generate`;
- `default`: TF32 on for both, what XLA on an NVIDIA GPU does for f32 dots
  and convolutions at default precision;
- `bfloat16`: TF32 as well. The card's torch has no mode that rounds f32
  operands to bf16 in cuBLAS or cuDNN (`fp32_precision = "bf16"` is refused
  for both), and TF32 keeps more mantissa bits than bf16, so the port is no
  less precise than JAX was asked to be.
On the CPU every mode computes the same, as on XLA:CPU: only the CUDA
backends' flags change, never oneDNN's or `torch.set_float32_matmul_precision`.
The hand kernels keep their own arithmetic in every mode (`ops.vq`,
`ops.attention`: 3xTF32, f32-accurate).

The flags are torch's `allow_tf32` pair. torch 2.11 and later also take
`fp32_precision` attributes, but refuse to read the `allow_tf32` flags (and
`torch.get_float32_matmul_precision()`) once those are set, so the port
keeps to the one API.
"""
from __future__ import annotations

import contextlib

import torch

MATMUL_PRECISIONS = ("bfloat16", "default", "float32", "highest")
_TF32 = {"bfloat16": True, "default": True, "float32": False, "highest": False}
_mode = "float32"  # the process's mode: one setting, as the backend flags are


def set_matmul_precision(mode: str) -> None:
    """Set the process's f32 matmul precision mode (one of
    MATMUL_PRECISIONS) and apply it to the CUDA backends now; every later
    `resolve_device` keeps it."""
    if mode not in _TF32:
        raise ValueError(f"matmul precision {mode!r} is not one of {MATMUL_PRECISIONS}")
    global _mode
    _mode = mode
    _apply()


def matmul_precision() -> str:
    """The process's f32 matmul precision mode (`float32` unless set)."""
    return _mode


@contextlib.contextmanager
def f32_matmul():
    """cuBLAS matmuls in full f32 (TF32 off) inside the block, whatever the
    mode: JAX's `precision=HIGHEST`. It flips the process-wide flag, so a
    thread that matmuls on the card at the same time sees it too."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _apply() -> None:
    tf32 = _TF32[_mode]
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch.device an entry point runs on, with the process's matmul
    precision mode applied (`float32`, TF32 off, unless
    `set_matmul_precision` chose another).

    `cuda` is the default everywhere; asking for it on a machine without a
    GPU raises instead of falling back to the CPU. A bare `cuda` is the
    current card, which a data-parallel rank has set to its own
    (`parallel.distributed.initialize`): cuda:0 in a plain process, this
    rank's card under a process group. In the `float32` mode TF32 is off
    for both matmuls and cuDNN convolutions (cuDNN convs default to TF32,
    which keeps ~3 decimal digits and breaks parity with the f32 reference).
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    _apply()
    return dev
