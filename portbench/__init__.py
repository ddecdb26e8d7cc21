"""The benchmark of the PyTorch and CUDA port (sgam_neurips22_tpu_torch): see run.py."""
