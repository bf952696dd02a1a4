"""Tone mapping (prog.cl:247-269).

Port of `opencl_path_tracer_tpu/ops/tonemap.py`: Reinhard on Rec.709
luminance and the reference's piecewise sRGB encode (constants 0.00304
and 0.4167), and the filmic curve of the dormant median-filter kernel.
The reference computes c * (L / (1 + L)) / L, which is NaN at L == 0:
`safe=True` maps that to black, `safe=False` keeps the reference's NaN.
"""

from __future__ import annotations

import torch


def srgb(c: torch.Tensor) -> torch.Tensor:
    """Piecewise sRGB encode, reference constants (prog.cl:247-258)."""
    return torch.where(c <= 0.00304, 12.92 * c,
                       1.055 * torch.pow(c, 0.4167) - 0.055)


def reinhard(c: torch.Tensor, safe: bool = True) -> torch.Tensor:
    """Reinhard luminance tonemap + sRGB (prog.cl:264-269); c: (..., 3)."""
    lum = (0.2126 * c[..., 0] + 0.7152 * c[..., 1]
           + 0.0722 * c[..., 2])[..., None]
    l2 = lum / (1.0 + lum)
    if safe:
        pos = lum > 0.0
        scale = torch.where(pos, l2 / torch.where(pos, lum,
                                                  torch.ones_like(lum)),
                            torch.zeros_like(lum))
    else:
        scale = l2 / lum
    return srgb(c * scale)


def filmic(c: torch.Tensor) -> torch.Tensor:
    """Hable-style filmic curve (prog.cl:259-263); no sRGB step."""
    c = torch.clamp_min(c - 0.004, 0.0)
    return (c * (c * 6.2 + 0.5)) / (c * (c * 6.2 + 1.7) + 0.06)


def apply(c: torch.Tensor, kind: str = "reinhard", safe: bool = True):
    if kind == "reinhard":
        return reinhard(c, safe=safe)
    if kind == "filmic":
        return filmic(c)
    if kind == "none":
        return c
    raise ValueError(f"unknown tonemap {kind!r}")
