"""Rays, hit records and 3-vector helpers.

Port of `opencl_path_tracer_tpu/core/types.py`. Per-ray data stays
structure-of-arrays: every per-ray quantity is a 1-D (N,) tensor and a
3-vector is a tuple of three of them ("V3"), the layout the reference's
public functions use, so the tests compare like with like.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from opencl_path_tracer_tpu_torch.core import fp

V3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def vadd(a: V3, b: V3) -> V3:
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def vsub(a: V3, b: V3) -> V3:
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def vmul(a: V3, b: V3) -> V3:
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def vscale(a: V3, s) -> V3:
    return (a[0] * s, a[1] * s, a[2] * s)


def vneg(a: V3) -> V3:
    return (-a[0], -a[1], -a[2])


def vdot(a: V3, b: V3) -> torch.Tensor:
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def vcross(a: V3, b: V3) -> V3:
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def vnormalize(a: V3) -> V3:
    """OpenCL normalize(): v * (1 / sqrt(dot(v, v))), no epsilon."""
    inv = 1.0 / fp.sqrt(vdot(a, a))
    return vscale(a, inv)


def vwhere(mask: torch.Tensor, a: V3, b: V3) -> V3:
    return (
        torch.where(mask, a[0], b[0]),
        torch.where(mask, a[1], b[1]),
        torch.where(mask, a[2], b[2]),
    )


@dataclasses.dataclass(frozen=True)
class Rays:
    """A batch of rays (prog.cl:7-9). p, d: V3 of (N,) float32."""

    p: V3
    d: V3

    @property
    def count(self) -> int:
        return int(self.p[0].shape[0])

    @property
    def device(self) -> torch.device:
        return self.p[0].device


@dataclasses.dataclass(frozen=True)
class Hits:
    """A batch of hit records (prog.cl:11-16).

    t: (N,) float32; <= 0 means miss. p, n: V3. mati: (N,) int32."""

    t: torch.Tensor
    p: V3
    n: V3
    mati: torch.Tensor

    @property
    def valid(self) -> torch.Tensor:
        return self.t > 0.0
