"""Exactly rounded float32 primitives the reference's rounding depends on.

No counterpart module in `opencl_path_tracer_tpu`: this holds what the
JAX package gets from XLA's CPU backend without asking.

* XLA's CPU backend contracts a multiply feeding an add inside one
  fused computation into a single fused multiply-add (it compiles with
  FP-op fusion on). The JAX package's reference values for its Pallas
  kernels (interpret mode) and for the jitted helpers it calls
  (`jnp.cross`, `jnp.linalg.norm`) carry those single roundings. `fma`
  reproduces them exactly, on any device, from float64 arithmetic.
* PyTorch's AVX-512 CPU `sqrt` for float32 is not correctly rounded
  (about 1 in 150 results is one ulp off), while XLA's CPU `sqrt` and
  CUDA's `sqrtf` are. `sqrt` rounds exactly everywhere.

The CUDA kernels use `__fmaf_rn` at exactly the places where the plain
versions call `fma`, and compile everything else with `--fmad=false`.
"""

from __future__ import annotations

import torch


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c with one rounding, like IEEE fusedMultiplyAdd.

    The product of two float32 values is exact in float64. The sum is
    rounded to float64 and then forced to round-to-odd (its lowest bit
    set when the float64 sum was inexact), which makes the final
    rounding to float32 correct: 53 >= 24 + 2 bits."""
    a, b, c = torch.broadcast_tensors(a, b, c)
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    # TwoSum: e is the exact rounding error of s = p + cd.
    bp = s - p
    e = (p - (s - bp)) + (cd - bp)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, float("inf"), float("-inf")).to(s.dtype)
    s = torch.where((e != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (through float64, where
    double rounding is innocuous for sqrt)."""
    return torch.sqrt(x.double()).float()


def div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b for a float32 tensor and a host scalar, as a true IEEE
    division on every device (CUDA PyTorch turns division by a host
    scalar into a multiplication by its rounded reciprocal)."""
    return a / torch.tensor(b, dtype=a.dtype, device=a.device)
