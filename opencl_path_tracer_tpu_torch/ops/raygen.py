"""Camera ray generation (gen_ray, prog.cl:384-389 + 82-92).

Port of `camera_rays` and the pixel ids of
`opencl_path_tracer_tpu/ops/raygen.py`: one lane per pixel id, two
jitter draws per lane, the pinhole projection as elementwise tensor
arithmetic over 1-D component tensors.
"""

from __future__ import annotations

import torch

from opencl_path_tracer_tpu_torch.core import fp
from opencl_path_tracer_tpu_torch.core.camera import Camera
from opencl_path_tracer_tpu_torch.core.types import Rays, vnormalize


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


def pixel_ids(width: int, height: int, device="cpu") -> torch.Tensor:
    return torch.arange(width * height, dtype=torch.int32, device=device)


def pixel_ids_like(num_pixels: int, device="cpu") -> torch.Tensor:
    return torch.arange(num_pixels, dtype=torch.int32, device=device)
