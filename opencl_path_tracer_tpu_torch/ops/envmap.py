"""Image-based environment light (an equirectangular radiance map) with
luminance-importance-sampled next-event estimation and MIS.

Port of `opencl_path_tracer_tpu/ops/envmap.py`, which is plain XLA there
and plain PyTorch here: `EnvMap`, `build_envmap` (host numpy, bit-equal
to the JAX package's), the procedural skies, `load_envmap`, and the
device lookups `env_radiance`, `sample_envmap`, `env_pdf_sa`,
`direct_light_env` and `envmap_miss_update`.

The reference's only environment is the dormant constant sky of its miss
branch (prog.cl:367-376, `models.megakernel.EnvLight`). Here a radiance
image lights the scene through the emitter NEE's two-estimator MIS split
(ops/nee.py): a gather importance-samples the map's luminance and traces
one shadow ray that must escape the scene (any-hit at rmax 3.0e38), the
BSDF pickup collects what a cosine-sampled bounce finds on a miss, and
balance-heuristic weights share every direction between them.

Radiance is bilinear over a row-packed (Hi * Wi, 4) table. The sampling
distribution lives on a coarse (Hs, Ws) grid (64 x 32 by default);
inside the chosen texel the direction is uniform in solid angle (phi
uniform in the texel's longitude span, cos theta uniform between its
rows' bounds), so the pdf is prob[texel] / (dphi (cos theta0 - cos
theta1)) and `env_pdf_sa` recomputes it from any direction. The texel is
the count of cumulative entries below u1: `torch.searchsorted(cum, u1)`
(side 'left') gives that count exactly for a non-decreasing table, ties
included, where the JAX package counts a broadcast compare (which at
1080p would hold a 2,073,600 x 2,048 mask).

Rounding: every operation is the JAX package's IEEE operation in the
same order (square roots through `core.fp.sqrt`, divisions of tensors),
except arccos, arctan2, cos, sin and pow, whose float32 results may
differ by an ulp between XLA's CPU, PyTorch's CPU and CUDA.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from opencl_path_tracer_tpu_torch.core import fp
from opencl_path_tracer_tpu_torch.core.types import (
    Rays, V3, vadd, vdot, vmul, vnormalize, vscale, vwhere,
)
from opencl_path_tracer_tpu_torch.ops import bsdf
from opencl_path_tracer_tpu_torch.ops.intersect import hits_of

_INV_PI = float(np.float32(1.0 / np.pi))
_TWO_PI = float(np.float32(2.0 * np.pi))
_INV_TWO_PI = float(np.float32(1.0) / np.float32(2.0 * np.pi))
_PI = float(np.float32(np.pi))
_LUM = (0.2126, 0.7152, 0.0722)  # Reinhard's weights (prog.cl:249)
ESCAPE_RMAX = 3.0e38   # the escape test's segment length


@dataclasses.dataclass(frozen=True)
class EnvMap:
    """Equirectangular environment light (y up: v = 0 is the +y pole).

    img: (Hi * Wi, 4) float32 radiance rows [r, g, b, 0]; prob: (Hs * Ws,)
    float32 coarse-texel probabilities (luminance x solid angle,
    normalised); cum: (Hs * Ws,) their inclusive cumulative, cum[-1] = 1;
    Wi, Hi, Ws, Hs: the resolutions. nee=True adds the gather and the
    MIS weights to the render models; False lights misses only (full
    pickup, no shadow rays)."""

    img: torch.Tensor
    prob: torch.Tensor
    cum: torch.Tensor
    Wi: int
    Hi: int
    Ws: int
    Hs: int
    nee: bool = True

    def to(self, device) -> "EnvMap":
        return dataclasses.replace(self, img=self.img.to(device),
                                   prob=self.prob.to(device),
                                   cum=self.cum.to(device))


def _bin_power(lum: np.ndarray, hs: int, ws: int) -> np.ndarray:
    """Fine-texel luminance binned into the (hs, ws) grid as power
    (radiance x solid angle) with the sampler's own pi/hs x 2pi/ws
    edges: each fine row carries its exact solid-angle weight
    cos(theta_i) - cos(theta_i+1) and lands in the coarse bin its centre
    falls in."""
    hi, wi = lum.shape
    edges = np.cos(np.linspace(0.0, np.pi, hi + 1))
    wrow = edges[:-1] - edges[1:]
    rbin = ((np.arange(hi) + 0.5) * hs / hi).astype(np.int64)
    cbin = ((np.arange(wi) + 0.5) * ws / wi).astype(np.int64)
    power = np.zeros((hs, ws), np.float64)
    np.add.at(power, (rbin[:, None], cbin[None, :]), lum * wrow[:, None])
    return power * (2.0 * np.pi / wi)


def build_envmap(img: np.ndarray, *, sample_res=(64, 32), scale: float = 1.0,
                 nee: bool = True, device="cpu") -> EnvMap:
    """Pack the radiance image and derive the coarse importance table on
    the host (once per scene), then place both on `device`.

    img: (Hi, Wi, 3) finite non-negative radiance; sample_res: (Ws, Hs);
    `scale` multiplies the radiance."""
    img = np.asarray(img, np.float64)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"envmap image must be (H, W, 3), got {img.shape}")
    if np.any(img < 0) or not np.all(np.isfinite(img)):
        raise ValueError("envmap radiance must be finite and >= 0")
    img = img * float(scale)
    hi, wi, _ = img.shape
    ws, hs = int(sample_res[0]), int(sample_res[1])
    ws, hs = min(ws, wi), min(hs, hi)

    lum = img @ np.asarray(_LUM, np.float64)
    power = _bin_power(lum, hs, ws)
    total = power.sum()
    if total <= 0:
        raise ValueError("envmap is black — nothing to sample")
    prob = (power / total).reshape(-1)
    cum = np.cumsum(prob)
    cum[-1] = 1.0

    packed = np.zeros((hi * wi, 4), np.float32)
    packed[:, :3] = img.reshape(-1, 3).astype(np.float32)
    return EnvMap(
        img=torch.as_tensor(packed, device=device),
        prob=torch.as_tensor(prob.astype(np.float32), device=device),
        cum=torch.as_tensor(cum.astype(np.float32), device=device),
        Wi=wi, Hi=hi, Ws=ws, Hs=hs, nee=nee,
    )


# --- procedural skies (tests, `--envmap gradient|sunsky`) -------------


def gradient_sky(top=(0.35, 0.55, 1.0), horizon=(0.9, 0.9, 0.85),
                 bottom=(0.18, 0.15, 0.12), res=(128, 64)) -> np.ndarray:
    """A vertical three-stop gradient: `top` at the +y pole, `horizon` at
    the equator, `bottom` at the -y pole."""
    wi, hi = int(res[0]), int(res[1])
    v = (np.arange(hi) + 0.5) / hi
    up = np.clip(1.0 - 2.0 * v, 0.0, 1.0)[:, None]
    dn = np.clip(2.0 * v - 1.0, 0.0, 1.0)[:, None]
    t, hz, b = (np.asarray(c, np.float64) for c in (top, horizon, bottom))
    row = up * t + dn * b + (1.0 - up - dn) * hz
    return np.broadcast_to(row[:, None, :], (hi, wi, 3)).copy()


def sun_sky(sun_dir=(0.3, 0.8, 0.2), sun_radiance=(4000.0, 3600.0, 3000.0),
            sun_angle_deg: float = 1.5, sky=(0.1, 0.15, 0.3),
            res=(256, 128)) -> np.ndarray:
    """A constant sky with a small bright sun disc around sun_dir: plain
    pickup almost never finds the disc, the gather samples it at once."""
    wi, hi = int(res[0]), int(res[1])
    d = np.asarray(sun_dir, np.float64)
    d = d / np.linalg.norm(d)
    v = (np.arange(hi) + 0.5) / hi
    u = (np.arange(wi) + 0.5) / wi
    theta = v * np.pi
    phi = u * 2.0 * np.pi - np.pi
    st = np.sin(theta)[:, None]
    dirs = np.stack(
        [st * np.cos(phi)[None, :],
         np.broadcast_to(np.cos(theta)[:, None], (hi, wi)),
         st * np.sin(phi)[None, :]], axis=-1)
    cosang = dirs @ d
    disc = cosang >= np.cos(np.deg2rad(sun_angle_deg))
    img = np.broadcast_to(np.asarray(sky, np.float64), (hi, wi, 3)).copy()
    img[disc] = np.asarray(sun_radiance, np.float64)
    return img


def _srgb_to_linear(c: np.ndarray) -> np.ndarray:
    """The inverse of the reference's piecewise sRGB encode
    (prog.cl:247-258): PNG pixels are sRGB-encoded radiance."""
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def load_envmap(source: str, *, scale: float = 1.0, sample_res=(64, 32),
                nee: bool = True, srgb: bool = True,
                device="cpu") -> EnvMap:
    """An EnvMap from a source string: 'gradient' or 'sunsky'
    (procedural), a .pfm path (linear HDR), a .npy path ((H, W, 3)
    linear radiance) or a .png path (sRGB-decoded to linear unless
    srgb=False)."""
    if source == "gradient":
        img = gradient_sky()
    elif source == "sunsky":
        img = sun_sky()
    elif source.endswith(".pfm"):
        from opencl_path_tracer_tpu_torch.io.image import read_pfm
        img = read_pfm(source)
    elif source.endswith(".npy"):
        img = np.load(source)
    elif source.endswith(".png"):
        from opencl_path_tracer_tpu_torch.io.image import read_png
        img = np.asarray(read_png(source), np.float64) / 255.0
        if img.ndim == 2:
            img = np.repeat(img[:, :, None], 3, axis=2)
        img = img[:, :, :3]
        if srgb:
            img = _srgb_to_linear(img)
    else:
        raise ValueError(
            f"envmap source {source!r}: expected 'gradient', 'sunsky', a "
            ".pfm, .npy or .png path")
    return build_envmap(img, sample_res=sample_res, scale=scale, nee=nee,
                        device=device)


# --- device-side lookups ----------------------------------------------


def _dir_angles(d: V3):
    """(theta, phi) of the unit direction d, y up."""
    theta = torch.acos(torch.clamp(d[1], -1.0, 1.0))
    phi = torch.atan2(d[2], d[0])  # (-pi, pi]
    return theta, phi


def env_radiance(em: EnvMap, d: V3) -> V3:
    """Bilinear full-resolution radiance in direction d (unit V3): four
    row gathers; columns wrap in longitude, rows clamp at the poles."""
    theta, phi = _dir_angles(d)
    u = phi * _INV_TWO_PI + 0.5
    v = theta * _INV_PI
    x = u * float(em.Wi) - 0.5
    y = v * float(em.Hi) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    xi = x0.to(torch.int32)
    yi = y0.to(torch.int32)
    c0 = torch.remainder(xi, em.Wi)
    c1 = torch.remainder(xi + 1, em.Wi)
    r0 = torch.clamp(yi, 0, em.Hi - 1)
    r1 = torch.clamp(yi + 1, 0, em.Hi - 1)

    def tap(r, c):
        return em.img[(r * em.Wi + c).long()]   # (N, 4)

    w00 = ((1.0 - fx) * (1.0 - fy))[:, None]
    w10 = (fx * (1.0 - fy))[:, None]
    w01 = ((1.0 - fx) * fy)[:, None]
    w11 = (fx * fy)[:, None]
    rgb = (tap(r0, c0) * w00 + tap(r0, c1) * w10
           + tap(r1, c0) * w01 + tap(r1, c1) * w11)
    return (rgb[:, 0], rgb[:, 1], rgb[:, 2])


def _row_cos_bounds(em: EnvMap, r):
    """(cos theta0, cos theta1) of coarse row r; theta0 is the row's upper
    (smaller theta) edge, so cos theta0 > cos theta1."""
    step = float(np.float32(np.pi / em.Hs))
    rf = r.to(torch.float32)
    return torch.cos(rf * step), torch.cos((rf + 1.0) * step)


def _texel_pdf(em: EnvMap, idx, ct0, ct1):
    dphi = float(np.float32(2.0 * np.pi / em.Ws))
    return em.prob[idx.long()] / torch.clamp_min(dphi * (ct0 - ct1), 1e-12)


def sample_envmap(em: EnvMap, u1, u2, u3):
    """Importance-sample a direction from the coarse luminance table: u1
    picks the texel (the count of cumulative entries below it), (u2, u3)
    place the direction uniformly in the texel's solid angle. Returns
    (d: V3, pdf_sa: (N,)); pdf_sa is what env_pdf_sa(em, d) recomputes
    away from texel borders."""
    idx = torch.searchsorted(em.cum, u1.contiguous(), side="left")
    idx = torch.clamp_max(idx, em.Hs * em.Ws - 1).to(torch.int32)
    r = torch.div(idx, em.Ws, rounding_mode="floor")
    c = idx - r * em.Ws
    ct0, ct1 = _row_cos_bounds(em, r)
    cos_t = ct0 + (ct1 - ct0) * u3
    sin_t = fp.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    inv_ws = float(np.float32(1.0 / em.Ws))
    phi = ((c.to(torch.float32) + u2) * inv_ws) * _TWO_PI - _PI
    d = (sin_t * torch.cos(phi), cos_t, sin_t * torch.sin(phi))
    return d, _texel_pdf(em, idx, ct0, ct1)


def env_pdf_sa(em: EnvMap, d: V3) -> torch.Tensor:
    """The solid-angle pdf the sampler gives direction d: the pickup side
    of the MIS split evaluates it at its BSDF-sampled miss direction.
    Longitude wraps (phi = +pi is texel 0, as env_radiance's taps)."""
    theta, phi = _dir_angles(d)
    r = torch.clamp((theta * _INV_PI * float(em.Hs)).to(torch.int32),
                    0, em.Hs - 1)
    c = torch.remainder(((phi * _INV_TWO_PI + 0.5) * float(em.Ws))
                        .to(torch.int32), em.Ws)
    ct0, ct1 = _row_cos_bounds(em, r)
    return _texel_pdf(em, r * em.Ws + c, ct0, ct1)


def direct_light_env(em: EnvMap, *, intersect_fn, cam_eye, hit_p: V3,
                     n_vec: V3, mat, f_l: V3, f_b: V3, f_s: V3, f_r: V3,
                     is_diff, u1, u2, u3, occluded_fn=None) -> V3:
    """Per-lane environment gather at a diffuse vertex (zeros where
    is_diff is false): one importance-sampled direction, one shadow ray
    from hit_p + EPS n that must escape the scene, MIS against the cosine
    pickup. `ops.nee.direct_light` with the area measure replaced by
    solid angle:

        w f_s f_r L (cos_l / pi) / (p_env + cos_l / pi)

    Visibility: with occluded_fn (the any-hit contract), visible =
    ~occluded(rays, 3.0e38); otherwise visible = ~intersect_fn(rays).valid
    (the same flag: no hit has t at or above 3.0e38)."""
    n = u1.shape[0]
    origin = vadd(hit_p, vscale(n_vec, bsdf.EPS))
    d_l, p_env = sample_envmap(em, u1, u2, u3)
    cos_l = torch.clamp_min(vdot(d_l, n_vec), 0.0)
    if occluded_fn is not None:
        rmax = torch.full((n,), ESCAPE_RMAX, dtype=torch.float32,
                          device=u1.device)
        visible = ~occluded_fn(Rays(p=origin, d=d_l), rmax)
    else:
        visible = ~hits_of(intersect_fn(Rays(p=origin, d=d_l))).valid
    radiance = env_radiance(em, d_l)
    eye_dir = vnormalize(tuple(cam_eye[k] - hit_p[k] for k in range(3)))
    halfway = vnormalize(vadd(eye_dir, d_l))
    blinn = torch.pow(torch.clamp_min(vdot(n_vec, halfway), 0.0),
                      mat.shininess)
    w = vadd(vscale(vmul(f_l, mat.kd), cos_l),
             vscale(vmul(f_b, mat.ks), blinn))
    p_bsdf = _INV_PI * cos_l
    scale = _INV_PI * cos_l / torch.clamp_min(p_env + p_bsdf, 1e-30)
    contrib = vscale(vmul(vmul(vmul(w, f_s), f_r), radiance), scale)
    take_it = is_diff & visible & (cos_l > 0.0) & (p_env > 0.0)
    zeros = tuple(torch.zeros(n, dtype=torch.float32, device=u1.device)
                  for _ in range(3))
    return vwhere(take_it, contrib, zeros)


def envmap_miss_update(em: EnvMap, miss_now, is_primary, prev_pdf, f_l: V3,
                       f_b: V3, f_s: V3, f_r: V3, d: V3, color: V3) -> V3:
    """Fold the environment pickup into `color` on the lanes whose live
    path missed this bounce (they die right after). A primary miss shows
    the map; a deeper miss adds throughput-tinted radiance, MIS-weighted
    against the gather where the previous bounce was diffuse (prev_pdf =
    cos / pi > 0; with em.nee False there is no gather and the pickup
    keeps full weight). is_primary: a bool or a per-lane mask."""
    radiance = env_radiance(em, d)
    tinted = vmul(vmul(vadd(f_l, f_b), f_s), vmul(f_r, radiance))
    if em.nee:
        p_env = env_pdf_sa(em, d)
        w_mis = torch.where(prev_pdf > 0.0,
                            prev_pdf / torch.clamp_min(prev_pdf + p_env,
                                                       1e-30),
                            torch.ones_like(prev_pdf))
        tinted = vscale(tinted, w_mis)
    if isinstance(is_primary, bool):
        contrib = radiance if is_primary else tinted
    else:
        contrib = vwhere(is_primary, radiance, tinted)
    return vwhere(miss_now, vadd(color, contrib), color)
