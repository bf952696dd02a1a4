"""Pinhole camera, exact reference math.

Port of `opencl_path_tracer_tpu/core/camera.py` (host Camera ctor
main.cpp:306-348, device mirror prog.cl:32-35). The basis starts axis
aligned, is rotated by pitch (about x) then yaw (about y); up is scaled
by H/2, right by W/2, and ahead_length = (W/2) / tan(fov/2)
(main.cpp:321). The eye sits at (500, 500, -1299.037842) + shift.

The camera is a handful of host scalars: trigonometry is taken in
float64 and rounded once to float32.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from opencl_path_tracer_tpu_torch.core.geometry import (
    REF_PI, rotate_x, rotate_y,
)

BASE_EYE = np.array([500.0, 500.0, -1299.037842], np.float32)


@dataclasses.dataclass(frozen=True)
class Camera:
    """eye, lookat, up * (H/2), right * (W/2): (3,) float32 tensors;
    xm, ym: the screen width and height as float32 scalars."""

    eye: torch.Tensor
    lookat: torch.Tensor
    up: torch.Tensor
    right: torch.Tensor
    xm: float
    ym: float

    def to(self, device) -> "Camera":
        return dataclasses.replace(
            self, eye=self.eye.to(device), lookat=self.lookat.to(device),
            up=self.up.to(device), right=self.right.to(device))


def basis(yaw: float, pitch: float):
    """Unit up/right/ahead after pitch-then-yaw rotation
    (main.cpp:323-332)."""
    axes = torch.eye(3, dtype=torch.float32)
    up, right, ahead = axes[1], axes[0], axes[2]
    return tuple(rotate_y(rotate_x(v, pitch), yaw) for v in (up, right, ahead))


def make_camera(width: int, height: int, fov: float, yaw: float,
                pitch: float, shift, device="cpu") -> Camera:
    """The device camera (main.cpp:306-348)."""
    up, right, ahead = basis(yaw, pitch)
    up_length = np.float32(height) / np.float32(2.0)
    right_length = np.float32(width) / np.float32(2.0)
    fov_rad = np.float32(np.float32(np.float32(fov) / np.float32(2.0))
                         / np.float32(180.0)) * REF_PI
    ahead_length = right_length / np.float32(math.tan(float(fov_rad)))
    eye = torch.as_tensor(BASE_EYE) + torch.as_tensor(
        np.asarray(shift, np.float32))
    return Camera(
        eye=eye.to(device),
        lookat=(eye + ahead * float(ahead_length)).to(device),
        up=(up * float(up_length)).to(device),
        right=(right * float(right_length)).to(device),
        xm=float(np.float32(width)),
        ym=float(np.float32(height)),
    )
