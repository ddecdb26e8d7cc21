"""The port's hand kernels, each a `torch.library` custom op (`ops.library`,
imported here so that importing any kernel module registers them)."""
from sgam_neurips22_tpu_torch.ops import library  # noqa: F401
