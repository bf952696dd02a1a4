"""The plain reference: the reference renderer's sample, in plain PyTorch.

This is the benchmark's own statement of what one progressive sample of
a pixel is, written from the reference kernel (zotya701/OpenCL_Path_
tracer prog.cl:82-381, fast sampler) and independent of the program: it
imports nothing of the port. It renders any set of (pixel, sample)
lanes, so a run's answers can be checked pixel by pixel after the
window:

* the camera ray of gen_ray (prog.cl:82-92, 384-389) with two jitter
  draws;
* the nearest triangle hit by brute force over every triangle
  (prog.cl:94-122: the plane's t, the three edge-side tests, the lowest
  index on an exact tie), with the dot products taken as (R, 3) x
  (3, 4T) products in full float32 (TF32 off);
* the four material branches (prog.cl:186-245, 326-366): Lambert +
  Blinn with the camera's halfway vector, the mirror, the dielectric's
  refract-or-reflect roulette with throughput compensation, the emitter;
* optionally next-event estimation: one power-selected point on an
  emissive triangle per diffuse vertex, a shadow ray tested against
  every triangle, and the balance-heuristic weight of the next bounce's
  emitter pickup;
* the tonemap of the display (Reinhard on Rec.709 luminance, the
  reference's sRGB constants, prog.cl:247-269) and its uint8 quantisation.

Random numbers: the fast sampler's counter hash, a double murmur3
finalizer over (lane, sample, bounce, draw) keyed by a threefry2x32 key
of the render seed (the sampler's definition, restated here). A frame
rendered as contiguous bands of pixel ids, one a rank, keys each band on
its first pixel id and counts its lanes from there (pixel id minus that
first id); on one device the band is the whole frame, its first id 0
and a lane its pixel id. A lane's draws depend on nothing but those
numbers, so any lane can be rendered alone.

`dtype` sets the precision of everything but the integer hash and the
final per-pixel sum (float64): float32 is the reference; bfloat16 is the
control that the comparison must reject.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_M1, _M2, _GOLD = 0x85EBCA6B, 0xC2B2AE35, 0x9E3779B9
EPS = float(np.float32(0.001))
TWO_PI = float(np.float32(2.0 * np.pi))
INV_PI = float(np.float32(1.0 / np.pi))
LUM = (0.2126, 0.7152, 0.0722)
CELLS = 1 << 25          # (ray, triangle) tests per intersect chunk
LANES = 1 << 20          # lanes per path chunk


# --- the fast sampler's hash ----------------------------------------------

def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(key, x):
    """Threefry-2x32, 20 rounds (Salmon et al. 2011)."""
    k0, k1 = key[0] & MASK32, key[1] & MASK32
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0, x1 = (x[0] + ks[0]) & MASK32, (x[1] + ks[1]) & MASK32
    for i in range(5):
        for r in rot[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def sample_key(seed: int, first_id: int = 0):
    """The key the draws of a band of pixel ids use: the seed's key (0,
    seed mod 2^32) folded with the band's first pixel id (the whole frame
    on one device: 0)."""
    return threefry2x32((0, int(seed) & MASK32),
                        (0, int(first_id) & MASK32))


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    lo, hi = b & 0xFFFF, b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 13)
    h = _mul32(h, _M2)
    return h ^ (h >> 16)


def uniforms(key, pix: torch.Tensor, smp: torch.Tensor, bounce: int,
             num: int, dtype) -> list:
    """`num` draws in [0, 1) for each lane (lane pix of its band, sample
    smp) at one bounce (or salt)."""
    h = (_mul32(pix, _GOLD) + key[0]) & MASK32
    h = h ^ ((smp * _M1) & MASK32)
    h = (h + ((bounce * _M2) & MASK32)) & MASK32
    out = []
    for j in range(num):
        g = h ^ ((j * _GOLD) & MASK32) ^ key[1]
        g = _fmix32(_fmix32(g))
        u = (g >> 8).to(torch.float32) * float(np.float32(1.0 / (1 << 24)))
        out.append(u.to(dtype))
    return out


# --- 3-vectors as (N, 3) tensors --------------------------------------------

def dot(a, b):
    return (a * b).sum(-1)


def cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], -1)


def normalize(a):
    return a * (1.0 / torch.sqrt(dot(a, a)))[:, None]


def where3(m, a, b):
    return torch.where(m[:, None], a, b)


# --- the scene --------------------------------------------------------------

class Scene:
    """Triangles, materials, emitters and camera on a device, in dtype."""

    def __init__(self, arrays, cam: dict, device, dtype=torch.float32):
        self.dtype, self.device = dtype, device
        v = arrays.v.astype(np.float32)
        v0, v1, v2 = v[:, 0], v[:, 1], v[:, 2]
        cr = np.cross(v1 - v0, v2 - v0)
        nrm = np.linalg.norm(cr, axis=1, keepdims=True)
        n = np.where(nrm > 0, cr / np.where(nrm > 0, nrm, 1), 0)
        n = n.astype(np.float32)
        rows, consts = [n], [(n * v0).sum(1)]
        for a, b in ((v0, v1), (v1, v2), (v2, v0)):
            m = np.cross(n, b - a).astype(np.float32)
            rows.append(m)
            consts.append((m * a).sum(1))

        def t(a, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(a), device=device
                                   ).to(dt)

        self.num_tris = v.shape[0]
        self.w = t(np.concatenate(rows))          # (4T, 3): n, m1, m2, m3
        self.c = t(np.concatenate(consts))        # (4T,)
        self.n = t(n)
        self.mati = t(arrays.mat, torch.long)
        mats = arrays.materials
        f = np.float32

        def col(key):
            return np.asarray([m[key] for m in mats], np.float32)

        big_n, big_k = col("N"), col("K")
        f0 = (big_k * big_k + (big_n - 1) * (big_n - 1)) / (
            big_k * big_k + (big_n + 1) * (big_n + 1))
        self.kd, self.ks = t(col("kd")), t(col("ks"))
        self.em = t(col("emission"))
        self.f0 = t(f0.astype(f))
        self.ior = t(big_n.mean(1).astype(f))
        self.shin = t(col("shininess"))
        self.type = t(np.asarray([m["type"] for m in mats]), torch.long)
        # Emitters: the triangles of an emissive material, power-selected.
        em = col("emission")[arrays.mat]
        is_em = (em != 0).any(1)
        e_v0, e_e1, e_e2 = v0[is_em], (v1 - v0)[is_em], (v2 - v0)[is_em]
        e_cr = np.cross(e_e1, e_e2)
        area = 0.5 * np.linalg.norm(e_cr, axis=1)
        keep = area > 0
        lum = em[is_em][keep] @ np.asarray(LUM, np.float32)
        power = area[keep] * lum
        total = float(power.astype(np.float64).sum())
        cum = np.cumsum(power / total).astype(f)
        if cum.size:
            cum[-1] = 1.0
        self.e_v0, self.e_e1, self.e_e2 = (t(a[keep]) for a in
                                           (e_v0, e_e1, e_e2))
        self.e_m = t(e_cr[keep] / np.linalg.norm(e_cr[keep], axis=1,
                                                 keepdims=True))
        self.e_em = t(em[is_em][keep])
        self.e_cum = t(cum)
        self.e_parea = t((lum / total).astype(f)) if cum.size else None
        self.power = total
        self.cam = {k: t(np.asarray(cam[k], f)) for k in
                    ("eye", "lookat", "up", "right")}
        self.width, self.height = int(cam["width"]), int(cam["height"])

    def _tests(self, o, d):
        """Per ray chunk: the (R, T) t and edge-side validity."""
        T = self.num_tris
        a = o @ self.w.T
        b = d @ self.w.T
        t = (self.c[:T] - a[:, :T]) / b[:, :T]
        ok = t > 0
        for k in (1, 2, 3):
            s = slice(k * T, (k + 1) * T)
            ok &= a[:, s] + t * b[:, s] - self.c[s] >= 0
        return t, ok

    def _chunks(self, n):
        step = max(1, CELLS // self.num_tris)
        return range(0, n, step), step

    def nearest(self, o, d):
        """(t, triangle): the nearest hit, t = inf and triangle 0 on a
        miss."""
        ts, ids = [], []
        rng, step = self._chunks(o.shape[0])
        for s in rng:
            t, ok = self._tests(o[s:s + step], d[s:s + step])
            tm, i = torch.where(ok, t, torch.full_like(t, math.inf)).min(1)
            ts.append(tm)
            ids.append(i)
        return torch.cat(ts), torch.cat(ids)

    def occluded(self, o, d, rmax):
        """Whether any triangle lies at 0 < t < rmax."""
        out = []
        rng, step = self._chunks(o.shape[0])
        for s in rng:
            t, ok = self._tests(o[s:s + step], d[s:s + step])
            out.append((ok & (t < rmax[s:s + step, None])).any(1))
        return torch.cat(out)


# --- one sample of a batch of lanes -----------------------------------------

def _fresnel(f0, n, d):
    om = 1.0 - torch.abs(dot(n, d))
    p2 = om * om
    p5 = (p2 * p2 * om)[:, None]
    return f0 + (1.0 - f0) * p5


def _direct_light(sc, key, pix, smp, b, hit_p, n_vec, kd, ks, shin,
                  f_l, f_b, f_s, f_r, gather):
    """NEE at the diffuse vertices `gather`: one emitter sample, one
    shadow ray."""
    u1, u2, u3 = uniforms(key, pix, smp, 10_000 + b, 3, sc.dtype)
    origin = hit_p + n_vec * EPS
    idx = (sc.e_cum[None, :] < u1[:, None]).sum(1)
    idx = torch.clamp_max(idx, sc.e_cum.shape[0] - 1)
    s = torch.sqrt(u2)
    y = sc.e_v0[idx] + (sc.e_e1[idx] * (s * (1.0 - u3))[:, None]
                        + sc.e_e2[idx] * (s * u3)[:, None])
    delta = y - origin
    dist2 = dot(delta, delta)
    dist = torch.sqrt(dist2)
    d_l = delta * (1.0 / torch.clamp_min(dist, 1e-12))[:, None]
    cos_l = torch.clamp_min(dot(d_l, n_vec), 0.0)
    ecos = torch.abs(dot(d_l, sc.e_m[idx]))
    want = gather & (cos_l > 0)
    visible = torch.zeros_like(want)
    lanes = torch.nonzero(want).flatten()
    if lanes.numel():
        visible[lanes] = ~sc.occluded(origin[lanes], d_l[lanes],
                                      dist[lanes] * (1.0 - 1e-3))
    eye_dir = normalize(sc.cam["eye"][None, :] - hit_p)
    halfway = normalize(eye_dir + d_l)
    blinn = torch.pow(torch.clamp_min(dot(n_vec, halfway), 0.0), shin)
    w = f_l * kd * cos_l[:, None] + f_b * ks * blinn[:, None]
    den2 = torch.clamp_min(dist2, 1e-12)
    p_bsdf = INV_PI * cos_l * ecos / den2
    mis = (INV_PI * cos_l * ecos * ecos / den2
           / torch.clamp_min(sc.e_parea[idx] + p_bsdf, 1e-30))
    contrib = w * f_s * f_r * sc.e_em[idx] * mis[:, None]
    return where3(want & visible, contrib, torch.zeros_like(contrib))


def trace(sc: Scene, key, pix, smp, iterations: int, nee: bool,
          first_id: int = 0):
    """Radiance of one sample for each lane (pixel pix, sample smp) of the
    band that starts at first_id: (L, 3) in sc.dtype."""
    dt, dev = sc.dtype, sc.device
    L = pix.shape[0]
    lane = pix - first_id
    r1, r2 = uniforms(key, lane, smp, 0, 2, dt)
    x = (pix % sc.width).to(dt) + r1
    y = torch.div(pix, sc.width, rounding_mode="floor").to(dt) + r2
    sx = 2.0 * x / sc.width - 1.0
    sy = 2.0 * y / sc.height - 1.0
    cam = sc.cam
    d = normalize(cam["lookat"][None] + cam["right"][None] * sx[:, None]
                  + cam["up"][None] * sy[:, None] - cam["eye"][None])
    o = cam["eye"][None].expand(L, 3)
    ones = torch.ones(L, 3, dtype=dt, device=dev)
    f_l, f_b, f_s, f_r = ones, ones, ones, ones
    color = torch.zeros(L, 3, dtype=dt, device=dev)
    alive = torch.ones(L, dtype=torch.bool, device=dev)
    inside = torch.zeros(L, dtype=torch.bool, device=dev)
    prev_pdf = torch.zeros(L, dtype=dt, device=dev)
    for b in range(iterations):
        t, tri = sc.nearest(o, d)
        valid = torch.isfinite(t)
        has_hit = valid & alive
        t0 = torch.where(valid, t, torch.zeros_like(t))
        hit_p = o + d * t0[:, None]
        hit_n = sc.n[tri]
        mi = torch.where(valid, sc.mati[tri], torch.zeros_like(tri))
        kd, ks, em, f0 = sc.kd[mi], sc.ks[mi], sc.em[mi], sc.f0[mi]
        ior, shin, mtype = sc.ior[mi], sc.shin[mi], sc.type[mi]
        r1, r2 = uniforms(key, lane, smp, b + 1, 2, dt)
        n_vec = where3(dot(d, hit_n) > 0, -hit_n, hit_n)
        is_diff = has_hit & (mtype == 0)
        is_spec = has_hit & (mtype == 1)
        is_refr = has_hit & (mtype == 2)
        is_emit = has_hit & (mtype == 3)
        # Diffuse: cosine-weighted around n_vec (prog.cl:186-218).
        nx, ny, nz = n_vec.unbind(1)
        near_y = (torch.abs(nx) <= EPS) & (torch.abs(nz) <= EPS)
        zero = torch.zeros_like(nx)
        ra = 1.0 / torch.sqrt(ny * ny + nz * nz)
        rb = 1.0 / torch.sqrt(nx * nx + nz * nz)
        z_ax = where3(near_y, torch.stack([zero, -nz * ra, ny * ra], 1),
                      torch.stack([-nz * rb, zero, nx * rb], 1))
        x_ax = cross(n_vec, z_ax)
        r = torch.sqrt(r1)
        th = TWO_PI * r2
        diff_d = normalize(x_ax * (r * torch.cos(th))[:, None]
                           + n_vec * torch.sqrt(1.0 - r1)[:, None]
                           + z_ax * (r * torch.sin(th))[:, None])
        diff_p = hit_p + n_vec * EPS
        # Mirror (prog.cl:223-227).
        spec_d = normalize(d - n_vec * (dot(n_vec, d) * 2.0)[:, None])
        spec_p = hit_p + n_vec * EPS
        # Dielectric (prog.cl:228-245, 346-357).
        n_eff = torch.where(inside, 1.0 / ior, ior)
        cosa = dot(-d, n_vec)
        disc = 1.0 - (1.0 - cosa * cosa) / n_eff / n_eff
        fr = _fresnel(f0, n_vec, d)
        prob = fr.sum(1) / 3.0
        refracted = (disc > 0) & (r1 > prob)
        inv_n = 1.0 / n_eff
        refr_d = normalize(d * inv_n[:, None] + n_vec * (
            cosa * inv_n - torch.sqrt(torch.clamp_min(disc, 0.0)))[:, None])
        refr_p = hit_p - n_vec * EPS
        rr_p = where3(refracted, refr_p, spec_p)
        rr_d = where3(refracted, refr_d, spec_d)
        rr_f = torch.where(refracted[:, None], (1.0 - fr) / (1.0 - prob)[:, None],
                           fr / prob[:, None])
        # Lambert + Blinn with the camera's halfway vector (prog.cl:79-81).
        intens_d = torch.clamp_min(dot(diff_d, n_vec), 0.0)
        halfway = normalize(normalize(cam["eye"][None] - hit_p) + diff_d)
        intens_s = torch.pow(torch.clamp_min(dot(n_vec, halfway), 0.0), shin)
        emit_cos = torch.clamp_min(dot(-d, n_vec), 0.0)
        use_diff = is_diff | is_emit
        new_p = where3(use_diff, diff_p, where3(is_refr, rr_p, spec_p))
        new_d = where3(use_diff, diff_d, where3(is_refr, rr_d, spec_d))
        if iterations == 1:
            color = where3(has_hit, kd + em, color)
        emit_w = None
        if nee:
            gather = is_diff & (b < iterations - 1)
            color = color + _direct_light(sc, key, lane, smp, b, hit_p,
                                          n_vec, kd, ks, shin, f_l, f_b, f_s,
                                          f_r, gather)
            p_bsdf = prev_pdf * emit_cos / torch.clamp_min(t0 * t0, 1e-12)
            p_area = (em * torch.as_tensor(LUM, dtype=dt, device=dev)
                      ).sum(1) / sc.power
            emit_w = torch.where(
                prev_pdf > 0, p_bsdf / torch.clamp_min(p_bsdf + p_area, 1e-30),
                torch.ones_like(p_bsdf))
            prev_pdf = torch.where(is_diff, intens_d * INV_PI,
                                   torch.zeros_like(prev_pdf))
        f_l = where3(is_diff, f_l * kd * intens_d[:, None], f_l)
        f_b = where3(is_diff, f_b * ks * intens_s[:, None], f_b)
        f_s = where3(is_spec, f_s * _fresnel(f0, n_vec, d), f_s)
        f_r = where3(is_refr, f_r * rr_f, f_r)
        inside = torch.where(is_refr, torch.where(refracted, ~inside, inside),
                             inside)
        contrib = em * ((f_l + f_b) * (f_s * f_r)) * emit_cos[:, None]
        if emit_w is not None:
            contrib = contrib * emit_w[:, None]
        color = where3(is_emit, color + contrib, color)
        alive = has_hit
        o = where3(has_hit, new_p, o)
        d = where3(has_hit, new_d, d)
    return color


@contextlib.contextmanager
def _full_float32():
    """Matrix products in full float32 (no TF32) while rendering."""
    cuda = torch.backends.cuda.matmul.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda
        torch.set_float32_matmul_precision(prec)


def render_pixels(sc: Scene, seed: int, pixels: np.ndarray, samples: int,
                  iterations: int, nee: bool, tiles: int = 1) -> np.ndarray:
    """The average over samples 0..samples-1 of each listed pixel's
    radiance: (P, 3) float64 on the host. tiles: the frame rendered as
    that many equal contiguous bands of pixel ids, each keyed on its
    first id."""
    pixels = np.asarray(pixels, np.int64)
    band = sc.width * sc.height // tiles
    out = np.zeros((pixels.shape[0], 3))
    for k in np.unique(pixels // band):
        sel = pixels // band == k
        out[sel] = _render_band(sc, seed, int(k) * band, pixels[sel],
                                samples, iterations, nee)
    return out


def _render_band(sc: Scene, seed: int, first_id: int, pixels: np.ndarray,
                 samples: int, iterations: int, nee: bool) -> np.ndarray:
    """render_pixels for pixels of the band that starts at first_id."""
    key = sample_key(seed, first_id)
    dev = sc.device
    pix_all = torch.as_tensor(np.asarray(pixels, np.int64), device=dev)
    P = pix_all.shape[0]
    acc = torch.zeros(P, 3, dtype=torch.float64, device=dev)
    per = max(1, LANES // P)
    with _full_float32(), torch.no_grad():
        for s0 in range(0, samples, per):
            ns = min(per, samples - s0)
            smp = torch.arange(s0, s0 + ns, device=dev).repeat_interleave(P)
            slot = torch.arange(P, device=dev).repeat(ns)
            col = trace(sc, key, pix_all[slot], smp, iterations, nee,
                        first_id)
            acc.index_add_(0, slot, col.to(torch.float64))
    return (acc / samples).cpu().numpy()


def display_u8(colors: np.ndarray) -> np.ndarray:
    """The display's uint8 of (P, 3) linear colours: Reinhard on Rec.709
    luminance (0 where the luminance is not positive), the reference's
    sRGB encode, clamp, x 255 + 0.5, truncate; NaN is 0."""
    c = np.asarray(colors, np.float64)
    lum = c @ np.asarray(LUM)
    scale = np.where(lum > 0, (lum / (1.0 + lum)) / np.where(lum > 0, lum, 1),
                     0.0)
    c = c * scale[:, None]
    s = np.where(c <= 0.00304, 12.92 * c,
                 1.055 * np.power(np.maximum(c, 0.0), 0.4167) - 0.055)
    s = np.nan_to_num(s, nan=0.0, posinf=1.0, neginf=0.0)
    return (np.clip(s, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
