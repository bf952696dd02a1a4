"""Camera ray generation (gen_ray, prog.cl:384-389 + 82-92).

Port of `camera_rays`, `camera_rays_dof`, the pixel ids,
`tile_major_ids` and `inverse_permutation` of
`opencl_path_tracer_tpu/ops/raygen.py`: one lane per pixel id, two
jitter draws per lane, the pinhole projection (or the thin lens) as
elementwise tensor arithmetic over 1-D component tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from opencl_path_tracer_tpu_torch.core import fp
from opencl_path_tracer_tpu_torch.core.camera import Camera
from opencl_path_tracer_tpu_torch.core.types import Rays, vnormalize

_TWO_PI = float(np.float32(2.0 * np.pi))


def camera_rays(cam: Camera, ids: torch.Tensor, rnd1: torch.Tensor,
                rnd2: torch.Tensor) -> Rays:
    """camera_get_ray (prog.cl:82-92) over linear pixel ids
    (row-major, id = y * W + x) with (N,) float32 jitter in [0, 1)."""
    x_dim = int(cam.xm)
    x = (ids % x_dim).to(torch.float32) + rnd1
    y = torch.div(ids, x_dim, rounding_mode="floor").to(torch.float32) + rnd2
    sx = fp.div(2.0 * x, cam.xm) - 1.0
    sy = fp.div(2.0 * y, cam.ym) - 1.0
    d = tuple(
        cam.lookat[k] + cam.right[k] * sx + cam.up[k] * sy - cam.eye[k]
        for k in range(3)
    )
    d = vnormalize(d)
    origins = tuple(cam.eye[k].expand(d[0].shape) for k in range(3))
    return Rays(p=origins, d=d)


def camera_rays_dof(cam: Camera, ids: torch.Tensor, rnd1, rnd2, lens1,
                    lens2, aperture: float, focus: float) -> Rays:
    """Thin-lens camera rays (no reference counterpart: the reference
    camera is a pinhole, prog.cl:82-92). Each ray starts at a uniform
    point of a lens disk of radius `aperture` (world units, spanned by
    the camera's unit right and up) and is aimed at the pinhole ray's
    point on the focal plane at distance `focus` along the view axis, so
    all of a pixel's rays meet there. aperture 0 gives the pinhole ray.
    lens1, lens2: (N,) float32 lens draws in [0, 1)."""
    pin = camera_rays(cam, ids, rnd1, rnd2)
    ahead = vnormalize(tuple(cam.lookat[k] - cam.eye[k] for k in range(3)))
    right_u = vnormalize(tuple(cam.right[k] for k in range(3)))
    up_u = vnormalize(tuple(cam.up[k] for k in range(3)))
    # The pinhole ray's focal-plane point: t = focus / dot(d, ahead).
    cosv = sum(pin.d[k] * ahead[k] for k in range(3))
    t = (torch.tensor(float(np.float32(focus)), dtype=torch.float32,
                      device=cosv.device) / torch.clamp_min(cosv, 1e-6))
    target = tuple(pin.p[k] + pin.d[k] * t for k in range(3))
    # A uniform point of the lens disk.
    r = fp.sqrt(lens1) * float(np.float32(aperture))
    th = _TWO_PI * lens2
    lx = r * torch.cos(th)
    ly = r * torch.sin(th)
    origin = tuple(pin.p[k] + right_u[k] * lx + up_u[k] * ly
                   for k in range(3))
    d = vnormalize(tuple(target[k] - origin[k] for k in range(3)))
    return Rays(p=origin, d=d)


def pixel_ids(width: int, height: int, device="cpu") -> torch.Tensor:
    return torch.arange(width * height, dtype=torch.int32, device=device)


def pixel_ids_like(num_pixels: int, device="cpu") -> torch.Tensor:
    return torch.arange(num_pixels, dtype=torch.int32, device=device)


def tile_major_ids(width: int, height: int, tile_w: int = 16,
                   tile_h: int = 16, device="cpu") -> torch.Tensor:
    """Linear pixel ids in tile-major order: (tile_w x tile_h) screen
    tiles in row-major tile order, row-major inside each tile."""
    if width % tile_w or height % tile_h:
        raise ValueError(f"{width}x{height} not divisible by "
                         f"{tile_w}x{tile_h} tiles")
    ids = np.arange(width * height, dtype=np.int32).reshape(
        height // tile_h, tile_h, width // tile_w, tile_w)
    return torch.as_tensor(ids.transpose(0, 2, 1, 3).reshape(-1).copy(),
                           device=device)


def inverse_permutation(perm: torch.Tensor) -> torch.Tensor:
    """inv with inv[perm[j]] = j, int32."""
    inv = torch.empty_like(perm, dtype=torch.int32)
    inv[perm.long()] = torch.arange(perm.shape[0], dtype=torch.int32,
                                    device=perm.device)
    return inv
