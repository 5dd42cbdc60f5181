"""The benchmark of the PyTorch / CUDA port `cgs_tpu_torch` (see README.md)."""
