"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch.device an entry point runs on, in f32 parity mode.

    `cuda` is the default everywhere; asking for it on a machine without a
    GPU raises instead of falling back to the CPU. TF32 is switched off for
    both matmuls and cuDNN convolutions (cuDNN convs default to TF32, which
    keeps ~3 decimal digits and breaks parity with the f32 reference).
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
