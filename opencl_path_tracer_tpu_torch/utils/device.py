"""Device choice for the port's entry points.

No counterpart in `opencl_path_tracer_tpu` (JAX picks its backend
itself). The port runs on CUDA unless the caller asks for the CPU, and
never falls back to the CPU on its own.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """torch.device for `device` (None means "cuda"). Raises when CUDA is
    asked for and no GPU is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on an NVIDIA GPU; pass "
                "device='cpu' to run its plain versions on the CPU")
        return dev
    if dev.type != "cpu":
        raise ValueError(f"device {dev} is neither CUDA nor the CPU")
    return dev
