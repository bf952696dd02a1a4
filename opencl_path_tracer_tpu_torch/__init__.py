"""PyTorch/CUDA port of `opencl_path_tracer_tpu`, the progressive path
tracer rebuilt from zotya701/OpenCL_Path_tracer.

The layout mirrors the JAX package module for module; each module's
docstring names the module it ports. Plain tensor code is PyTorch; each
Pallas kernel of the JAX package becomes a CUDA C++ kernel for Hopper
(`csrc/`, wrapped in `ops/kernels/`) with a plain PyTorch version beside
it. Entry points run on CUDA unless the caller passes device="cpu".
"""

from opencl_path_tracer_tpu_torch import config as config
from opencl_path_tracer_tpu_torch.version import __version__

__all__ = ["__version__", "config"]
