"""Rotations and the triangle structure-of-arrays.

Port of `opencl_path_tracer_tpu/core/geometry.py` (reference host
geometry main.cpp:47-70 and 139-182). Per triangle it precomputes the
constants that turn the reference's three cross-product edge tests
(prog.cl:104-106) into dot products: with m_k = cross(n, e_k),
dot(cross(e_k, p - v_k), n) >= 0 becomes dot(p, m_k) >= dot(v_k, m_k).

The constants are bit-equal to the JAX package's: its `jnp.cross` and
`jnp.linalg.norm` are jitted, so XLA fuses their multiply-adds
(`core.fp.fma` at the same places); its plane and edge offsets are sums
of separately rounded products.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from opencl_path_tracer_tpu_torch.core import fp

# The reference uses 3.141593f, not M_PI, for host rotations (main.cpp:48).
REF_PI = np.float32(3.141593)


def _angle(deg) -> np.float32:
    return np.float32(np.float32(deg) / np.float32(180.0)) * REF_PI


def _cos_sin(deg):
    a = float(_angle(deg))
    return np.float32(math.cos(a)), np.float32(math.sin(a))


def _rot(v: torch.Tensor, deg, ix: int, iy: int) -> torch.Tensor:
    c, s = _cos_sin(deg)
    out = list(v.to(torch.float32).unbind(-1))
    x, y = out[ix], out[iy]
    out[ix] = x * float(c) - y * float(s)
    out[iy] = x * float(s) + y * float(c)
    return torch.stack(out, dim=-1)


def rotate_z(v: torch.Tensor, alpha_deg) -> torch.Tensor:
    """main.cpp:47-54 — rotate about +z by degrees."""
    return _rot(v, alpha_deg, 0, 1)


def rotate_y(v: torch.Tensor, beta_deg) -> torch.Tensor:
    """main.cpp:55-62: x' = x c + z s, z' = -x s + z c."""
    c, s = (float(a) for a in _cos_sin(beta_deg))
    x, y, z = v.to(torch.float32).unbind(-1)
    return torch.stack([x * c + z * s, y, -x * s + z * c], dim=-1)


def rotate_x(v: torch.Tensor, gamma_deg) -> torch.Tensor:
    """main.cpp:63-70 — rotate about +x by degrees."""
    return _rot(v, gamma_deg, 1, 2)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3) cross product rounded like the jitted `jnp.cross`: the
    first product of each component fused into the subtraction."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([
        fp.fma(a1, b2, -(a2 * b1)),
        fp.fma(a2, b0, -(a0 * b2)),
        fp.fma(a0, b1, -(a1 * b0)),
    ], dim=-1)


def _dot_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b, -1) of separately rounded products, left to right from
    XLA's reduction init of +0.0 (so an all -0.0 row sums to +0.0)."""
    p = a * b
    return ((p[..., 0] + 0.0) + p[..., 1]) + p[..., 2]


def triangle_normals(r1: torch.Tensor, r2: torch.Tensor,
                     r3: torch.Tensor) -> torch.Tensor:
    """Unit face normals cross(r2 - r1, r3 - r1) / |.| (main.cpp:144-166).

    A degenerate (zero-area) triangle gets n = 0, not the reference's
    NaN: both make every intersection test reject, and n = 0 is the
    never-hit padding convention of the kernels' packs."""
    n = cross(r2 - r1, r3 - r1)
    nx, ny, nz = n.unbind(-1)
    norm = fp.sqrt(fp.fma(nz, nz, fp.fma(ny, ny, nx * nx)))[..., None]
    return torch.where(norm > 0.0, n / norm, torch.zeros_like(n))


@dataclasses.dataclass(frozen=True)
class TrianglesSoA:
    """All scene triangles (prog.cl:18-21) plus intersection constants.

    r1, r2, r3, n, m1, m2, m3: (T, 3) float32. mati: (T,) int32.
    c0 = dot(r1, n); d_k = dot(v_k, m_k) with v_k = r1, r2, r3: (T,)."""

    r1: torch.Tensor
    r2: torch.Tensor
    r3: torch.Tensor
    n: torch.Tensor
    mati: torch.Tensor
    m1: torch.Tensor
    m2: torch.Tensor
    m3: torch.Tensor
    c0: torch.Tensor
    d1: torch.Tensor
    d2: torch.Tensor
    d3: torch.Tensor

    @property
    def count(self) -> int:
        return int(self.r1.shape[0])

    @property
    def device(self) -> torch.device:
        return self.r1.device

    @staticmethod
    def build(r1, r2, r3, mati) -> "TrianglesSoA":
        """From numpy vertices, on the CPU (move with `.to(device)`)."""
        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32))

        r1, r2, r3 = f32(r1), f32(r2), f32(r3)
        mati = torch.as_tensor(np.asarray(mati, np.int32))
        n = triangle_normals(r1, r2, r3)
        m1 = cross(n, r2 - r1)
        m2 = cross(n, r3 - r2)
        m3 = cross(n, r1 - r3)
        return TrianglesSoA(
            r1=r1, r2=r2, r3=r3, n=n, mati=mati, m1=m1, m2=m2, m3=m3,
            c0=_dot_rows(r1, n), d1=_dot_rows(r1, m1),
            d2=_dot_rows(r2, m2), d3=_dot_rows(r3, m3),
        )

    def take(self, idx) -> "TrianglesSoA":
        """The triangles at rows idx, in that order (constants move with
        their rows unchanged)."""
        idx = torch.as_tensor(np.asarray(idx, np.int64), device=self.device)
        return TrianglesSoA(**{
            f.name: getattr(self, f.name)[idx]
            for f in dataclasses.fields(self)
        })

    def to(self, device) -> "TrianglesSoA":
        return TrianglesSoA(**{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
        })
