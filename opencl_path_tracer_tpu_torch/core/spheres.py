"""Analytic sphere primitive.

Port of `opencl_path_tracer_tpu/core/spheres.py`. The reference
tessellates its spheres (main.cpp:1002,1009); the analytic quadric is a
first-class primitive here, sharing the material table with triangles.
Centers are a V3 tuple of (S,) tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from opencl_path_tracer_tpu_torch.core.types import V3


@dataclasses.dataclass(frozen=True)
class SpheresSoA:
    """c: V3 of (S,) float32 centers; rad: (S,) float32; mati: (S,) int32."""

    c: V3
    rad: torch.Tensor
    mati: torch.Tensor

    @property
    def count(self) -> int:
        return int(self.rad.shape[0])

    @staticmethod
    def build(centers, radii, mati, device="cpu") -> "SpheresSoA":
        centers = np.asarray(centers, np.float32).reshape(-1, 3)
        radii = np.asarray(radii, np.float32).reshape(-1)
        mati = np.asarray(mati, np.int32).reshape(-1)
        if not (centers.shape[0] == radii.shape[0] == mati.shape[0]):
            raise ValueError(
                f"mismatched sphere arrays: {centers.shape[0]} centers, "
                f"{radii.shape[0]} radii, {mati.shape[0]} materials"
            )
        if np.any(radii <= 0.0):
            raise ValueError("sphere radii must be > 0")
        return SpheresSoA(
            c=tuple(torch.as_tensor(np.ascontiguousarray(centers[:, k]),
                                    device=device) for k in range(3)),
            rad=torch.as_tensor(radii, device=device),
            mati=torch.as_tensor(mati, device=device),
        )

    def to(self, device) -> "SpheresSoA":
        return SpheresSoA(c=tuple(x.to(device) for x in self.c),
                          rad=self.rad.to(device), mati=self.mati.to(device))
