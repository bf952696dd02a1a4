"""The benchmark of the PyTorch and CUDA port (README.md)."""
