"""Edge-aware à-trous wavelet denoiser and its primary-ray guides.

Port of `opencl_path_tracer_tpu/ops/denoise.py` (plain XLA there, plain
PyTorch here): `primary_aovs` and `atrous_denoise`. The reference's only
post-process is the dormant 3x3 luminance median (`filt_im`,
prog.cl:391-427; `ops/median_filter.py`). This is the à-trous filter of
Dammertz et al. 2010 ("Edge-Avoiding À-Trous Wavelet Transform for Fast
Global Illumination Filtering") with colour, normal and depth
edge-stopping weights: each iteration reads 25 shifted views of the
edge-padded (H, W, ...) buffers, with the taps 2**i apart, so 5
iterations cover a 63-pixel footprint at 5x5 cost each.

The guides come from one deterministic primary-ray pass through the
render's own intersector (pixel-centre rays, no jitter, no RNG), so
every accel and the textured and smooth paths give consistent normals.

Rounding: `primary_aovs` is the JAX package's IEEE operations in its
order, bit for bit. `atrous_denoise` calls exp and log1p, which differ by
ulps between XLA's and PyTorch's libraries (and between the CPU and
CUDA), so it agrees with the JAX package to a tolerance
(tests/test_torch_denoise.py states it); the clamp's percentile is
`torch.quantile` (linear interpolation, as `jnp.percentile`), which takes
at most 2**24 values (4K frames fit).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from opencl_path_tracer_tpu_torch.core.types import vdot, vneg, vwhere
from opencl_path_tracer_tpu_torch.ops import raygen
from opencl_path_tracer_tpu_torch.ops.intersect import hits_of

# The B3-spline 5-tap kernel (Dammertz et al. section 3): its outer
# product is the 5x5 à-trous stencil.
_H5 = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)


def primary_aovs(cam, mats, intersect_fn, width: int, height: int):
    """Deterministic first-hit guides: (normal (H, W, 3), depth (H, W)),
    on the camera's device. Pixel-centre rays (jitter 0.5, the
    expectation of the reference's rand() jitter, prog.cl:388); a miss
    gets normal 0 and depth -1. Rows follow the framebuffer's bottom-up
    pixel order. `mats` is unused: the JAX package's signature (it
    fetches the materials and drops them)."""
    n = width * height
    dev = cam.eye.device
    ids = raygen.pixel_ids_like(n, device=dev)
    half = torch.full((n,), 0.5, dtype=torch.float32, device=dev)
    rays = raygen.camera_rays(cam, ids, half, half)
    hit = hits_of(intersect_fn(rays))
    n_vec = vwhere(vdot(rays.d, hit.n) > 0.0, vneg(hit.n), hit.n)
    valid = hit.valid
    a = torch.stack(n_vec, -1).reshape(height, width, 3)
    normal = torch.where(valid.reshape(height, width, 1), a,
                         torch.zeros_like(a))
    depth = torch.where(valid, hit.t, -1.0).reshape(height, width)
    return normal, depth


def _pad_edge(x: torch.Tensor, p: int) -> torch.Tensor:
    """x (H, W) or (H, W, C) padded by p on both image axes with its edge
    values (numpy's mode='edge')."""
    planes = x[None, None] if x.dim() == 2 else x.permute(2, 0, 1)[None]
    out = F.pad(planes, (p, p, p, p), mode="replicate")[0]
    return out[0] if x.dim() == 2 else out.permute(1, 2, 0)


def _sum3(v: torch.Tensor) -> torch.Tensor:
    return v[..., 0] + v[..., 1] + v[..., 2]


def atrous_denoise(colors, normal, depth, *, iterations: int = 5,
                   sigma_color: float = 3.0, sigma_normal: float = 0.2,
                   sigma_depth: float = 0.05,
                   clamp_percentile: float | None = 99.0) -> torch.Tensor:
    """Edge-aware à-trous filter of a linear radiance image.

    colors: (H, W, 3) float32, untonemapped (filter in linear light,
    tonemap after); normal: (H, W, 3) unit first-hit normals (0 on a
    miss); depth: (H, W) first-hit t (-1 on a miss), all on one device.

    clamp_percentile: firefly suppression: each pixel's RGB is scaled so
    that its luminance caps at this percentile of the frame before
    filtering (None: no clamp). Iteration i weights the taps 2**i apart
    by the B3 stencil times
      w_c = exp(-||log1p(c_p) - log1p(c_q)||^2 / sigma_c^2),
      w_n = exp(-||n_p - n_q||^2 / sigma_n^2),
      w_d = exp(-|d_p - d_q| / (sigma_d (|d_p| + 1e-3)));
    the average stays in linear radiance. Returns the (H, W, 3) image."""
    c = torch.as_tensor(colors, dtype=torch.float32)
    nrm = torch.as_tensor(normal, dtype=torch.float32, device=c.device)
    dep = torch.as_tensor(depth, dtype=torch.float32, device=c.device)

    if clamp_percentile is not None:
        lum = 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]
        cap = torch.quantile(lum.reshape(-1), clamp_percentile / 100.0)
        c = c * torch.clamp_max(cap / torch.clamp_min(lum, 1e-9),
                                1.0)[..., None]

    inv_sn2 = 1.0 / (sigma_normal * sigma_normal)
    inv_sc2 = 1.0 / (sigma_color * sigma_color)
    eps = 1e-3
    h, w = dep.shape
    # The depth term's denominator does not depend on the tap.
    den_d = sigma_depth * (torch.abs(dep) + eps)

    for i in range(iterations):
        step = 1 << i
        lc = torch.log1p(c)
        pc = _pad_edge(c, 2 * step)
        pl = _pad_edge(lc, 2 * step)
        pn = _pad_edge(nrm, 2 * step)
        pd = _pad_edge(dep, 2 * step)
        acc = torch.zeros_like(c)
        wacc = torch.zeros_like(dep)
        for ky in range(5):
            for kx in range(5):
                oy = ky * step
                ox = kx * step
                qc = pc[oy:oy + h, ox:ox + w]
                dl = lc - pl[oy:oy + h, ox:ox + w]
                dn = nrm - pn[oy:oy + h, ox:ox + w]
                w_c = torch.exp(-_sum3(dl * dl) * inv_sc2)
                w_n = torch.exp(-_sum3(dn * dn) * inv_sn2)
                w_d = torch.exp(-torch.abs(dep - pd[oy:oy + h, ox:ox + w])
                                / den_d)
                wgt = _H5[ky] * _H5[kx] * w_c * w_n * w_d
                acc = acc + qc * wgt[..., None]
                wacc = wacc + wgt
        c = acc / wacc[..., None]
    return c
