"""BSDF sampling and bounce logic (prog.cl:186-245, dispatch :329-366).

Port of `opencl_path_tracer_tpu/ops/bsdf.py`. Every branch is computed
for every lane and selected; the models own the dispatch.

  * orthonormal_base (prog.cl:186-204), with the axis-aligned special
    case (|x|, |z| <= 1e-3).
  * diffuse: cosine-weighted hemisphere sample around N, origin offset
    by N * 1e-3 (prog.cl:205-218).
  * Fresnel: Schlick with per-channel conductor F0 (prog.cl:219-222).
  * specular: mirror reflection (prog.cl:223-227).
  * refractive: Snell with the 1/n flip inside, Russian roulette between
    refraction and reflection with throughput compensation
    (prog.cl:228-245, :346-357).
"""

from __future__ import annotations

import numpy as np
import torch

from opencl_path_tracer_tpu_torch.core import fp
from opencl_path_tracer_tpu_torch.core.types import (
    V3, vadd, vcross, vdot, vneg, vnormalize, vscale, vsub, vwhere,
)

EPS = float(np.float32(0.001))
TWO_PI = float(np.float32(2.0 * np.pi))


def orthonormal_base(v1: V3) -> tuple[V3, V3]:
    """(v2, v3) with v3 = cross(v1, v2) for unit v1 (prog.cl:186-204)."""
    x, y, z = v1
    near_y_axis = (torch.abs(x) <= EPS) & (torch.abs(z) <= EPS)
    zero = torch.zeros_like(x)
    rl_a = 1.0 / fp.sqrt(y * y + z * z)
    v2_a = (zero, -z * rl_a, y * rl_a)
    rl_b = 1.0 / fp.sqrt(x * x + z * z)
    v2_b = (-z * rl_b, zero, x * rl_b)
    v2 = vwhere(near_y_axis, v2_a, v2_b)
    return v2, vcross(v1, v2)


def diffuse_ray(hit_p: V3, hit_n: V3, rnd1: torch.Tensor,
                rnd2: torch.Tensor) -> tuple[V3, V3]:
    """Cosine-weighted bounce (new_ray_diffuse). Returns (origin, dir)."""
    y_axis = hit_n
    z_axis, x_axis = orthonormal_base(y_axis)
    r = fp.sqrt(rnd1)
    theta = TWO_PI * rnd2
    x = r * torch.cos(theta)
    y = r * torch.sin(theta)
    z = fp.sqrt(1.0 - rnd1)
    d = vnormalize(vadd(
        vadd(vscale(x_axis, x), vscale(y_axis, z)), vscale(z_axis, y)))
    return vadd(hit_p, vscale(y_axis, EPS)), d


def fresnel(f0: V3, hit_n: V3, d: V3) -> V3:
    """Schlick: F = F0 + (1 - F0)(1 - |dot(N, D)|)^5, per channel."""
    cosa = torch.abs(vdot(hit_n, d))
    one_minus = 1.0 - cosa
    p2 = one_minus * one_minus
    p5 = p2 * p2 * one_minus
    return tuple(c + (1.0 - c) * p5 for c in f0)


def specular_ray(hit_p: V3, hit_n: V3, d: V3) -> tuple[V3, V3]:
    """Mirror reflection (new_ray_specular, prog.cl:223-227)."""
    cosa = vdot(hit_n, d)
    new_d = vnormalize(vsub(d, vscale(hit_n, cosa * 2.0)))
    return vadd(hit_p, vscale(hit_n, EPS)), new_d


def refractive_ray(hit_p: V3, hit_n: V3, d: V3, mat_n, f0: V3, inside, rnd):
    """Refract-or-reflect with Russian roulette plus the factor_R update.
    Returns (origin, direction, new_inside, factor_r multiplier V3)."""
    n_eff = torch.where(inside, 1.0 / mat_n, mat_n)
    cosa = vdot(vneg(d), hit_n)
    disc = 1.0 - (1.0 - cosa * cosa) / n_eff / n_eff
    f = fresnel(f0, hit_n, d)
    prob = fp.div(f[0] + f[1] + f[2], 3.0)
    refracted = (disc > 0.0) & (rnd > prob)

    inv_n = 1.0 / n_eff
    safe_disc = torch.clamp_min(disc, 0.0)
    refr_d = vnormalize(vadd(
        vscale(d, inv_n), vscale(hit_n, cosa * inv_n - fp.sqrt(safe_disc))))
    refr_p = vsub(hit_p, vscale(hit_n, EPS))
    spec_p, spec_d = specular_ray(hit_p, hit_n, d)

    origin = vwhere(refracted, refr_p, spec_p)
    direction = vwhere(refracted, refr_d, spec_d)
    new_inside = torch.where(refracted, ~inside, inside)
    inv_1mp = 1.0 / (1.0 - prob)
    inv_p = 1.0 / prob
    factor_r = tuple(torch.where(refracted, (1.0 - c) * inv_1mp, c * inv_p)
                     for c in f)
    return origin, direction, new_inside, factor_r
