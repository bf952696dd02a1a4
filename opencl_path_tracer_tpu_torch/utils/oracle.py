"""Scalar reference oracle: a literal re-execution of prog.cl.

Port of `opencl_path_tracer_tpu/utils/oracle.py`, the port's own copy
of the JAX package's numpy oracle (the port imports nothing of that
package). It reads the port's scene, materials and camera tensors
(copied to the host first, so a scene on the card works too) and seeds
the pixels with the port's `ops/rng.py::minstd_rand0_raw`; the scalar
walk is the JAX module's, statement for statement.

This module is parity EVIDENCE, not a production path: it executes the
reference's device code (gen_ray prog.cl:384-389, trace_ray
prog.cl:292-381 and everything they call) pixel by pixel, bounce by
bounce, as sequential float32 scalar statements in the same order the
OpenCL source writes them — the way a human hand-executing the kernel
would. It shares NO code with the vectorized renderer (models/
megakernel.py builds every branch and selects; this walks the actual
control flow), so agreement between the two is meaningful:

  * the per-pixel Lehmer streams (integer states) must match EXACTLY —
    this verifies the draw ORDER and per-branch draw COUNTS across
    data-dependent control flow, which transitively verifies every
    hit/miss and material-type decision along every path;
  * colors must match to float32 rounding (a few ulp: op ORDER inside
    expressions differs between a scalar walk and a vectorized select).

Interpretation contract (where prog.cl's semantics are device-defined,
both implementations agree to these readings — see docs/PARITY.md):
  * half_sqrt (prog.cl:190,195,211,214,240) -> full f32 sqrt;
  * normalize(v) -> v / sqrt(dot(v,v)) in f32;
  * 2*M_PI*rnd2 (prog.cl:212) -> float32(2*pi) * rnd2 (f32 multiply);
  * pow -> f32 pow.

The tree traversal is replaced by the same-result linear scan the
reference keeps commented next to it (first_intersect, prog.cl:318);
ties in t resolve to the first triangle in array order in both.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np

from opencl_path_tracer_tpu_torch.ops.rng import minstd_rand0_raw

F = np.float32
TWO_PI = np.float32(2.0 * np.pi)
EPS = np.float32(0.001)


def rand(seeds: np.ndarray, i: int) -> np.float32:
    """rand (prog.cl:72-77): ulong n = seed; n = n*48271 % 2147483647;
    seed = n; return n / 2147483647.0f."""
    n = (int(seeds[i]) * 48271) % 2147483647
    seeds[i] = n
    return F(n) / F(2147483647.0)


def _normalize(v: np.ndarray) -> np.ndarray:
    return (v / np.sqrt(v @ v)).astype(np.float32)


@dataclasses.dataclass
class OracleTrace:
    """Per-event log for the pixel-transcript artifact."""
    events: list


def _host(a, dtype=np.float32) -> np.ndarray:
    """A numpy copy of a tensor (on any device) or array-like."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def camera_get_ray(pixel_id: int, cam, rnd1: F, rnd2: F):
    """camera_get_ray (prog.cl:82-92)."""
    X = int(cam.xm)
    Y = int(cam.ym)
    x = F(pixel_id % X) + rnd1
    y = F(pixel_id // X) + rnd2
    right = _host(cam.right) * (F(2.0) * x / F(X) - F(1.0))
    up = _host(cam.up) * (F(2.0) * y / F(Y) - F(1.0))
    p = _host(cam.lookat) + right + up
    eye = _host(cam.eye)
    d = _normalize(p - eye)
    return eye.copy(), d


def first_intersect(tris_np, P, D):
    """first_intersect over all triangles (prog.cl:94-122 semantics,
    vectorized over triangles only — the per-triangle math is the
    literal plane + three edge-sign tests). Returns (t, p, N, mati) or
    t = -1 on miss. Ties pick the lowest triangle index, like the
    reference's strict < scan."""
    r1, r2, r3, n, mati = tris_np
    vn = (D[None, :] * n).sum(1)
    t = ((r1 - P[None, :]) * n).sum(1) / vn
    p = P[None, :] + D[None, :] * t[:, None]
    e1 = (np.cross(r2 - r1, p - r1) * n).sum(1)
    e2 = (np.cross(r3 - r2, p - r2) * n).sum(1)
    e3 = (np.cross(r1 - r3, p - r3) * n).sum(1)
    # t<0 early-returns in prog.cl:99-101; t==0 passes the edge tests
    # but fails first_intersect's accept test hit.t>0 (prog.cl:117);
    # NaN t (vn==0) fails every comparison in both.
    with np.errstate(invalid="ignore"):
        ok = (t > 0) & (e1 >= 0) & (e2 >= 0) & (e3 >= 0)
    if not ok.any():
        return F(-1.0), None, None, -1
    tm = np.where(ok, t, np.float32(np.inf))
    i = int(np.argmin(tm))
    return F(t[i]), p[i].astype(np.float32), n[i].astype(np.float32), \
        int(mati[i])


def orthonormal_base(v1):
    """orthonormal_base (prog.cl:186-204)."""
    E = np.float32(0.001)
    if abs(v1[0]) <= E and abs(v1[2]) <= E:
        rl = F(1.0) / np.sqrt(F(v1[1] * v1[1] + v1[2] * v1[2]))
        v2 = np.asarray([0.0, -v1[2] * rl, v1[1] * rl], np.float32)
    else:
        rl = F(1.0) / np.sqrt(F(v1[0] * v1[0] + v1[2] * v1[2]))
        v2 = np.asarray([-v1[2] * rl, 0.0, v1[0] * rl], np.float32)
    v3 = np.cross(v1, v2).astype(np.float32)
    return v2, v3


def new_ray_diffuse(hit_p, hit_n, rnd1, rnd2):
    """new_ray_diffuse (prog.cl:205-218)."""
    Y = hit_n
    Z, X = orthonormal_base(Y)
    r = np.sqrt(rnd1)
    theta = TWO_PI * rnd2
    x = r * np.cos(theta)
    y = r * np.sin(theta)
    z = np.sqrt(F(1.0) - rnd1)
    new_d = _normalize(X * x + Y * z + Z * y)
    return (hit_p + Y * EPS).astype(np.float32), new_d


def fresnel(f0, hit_n, d):
    """Fresnel (prog.cl:219-222)."""
    cosa = F(abs(hit_n @ d))
    return (f0 + (F(1.0) - f0) * (F(1.0) - cosa) ** F(5.0)).astype(
        np.float32
    )


def new_ray_specular(hit_p, hit_n, d):
    """new_ray_specular (prog.cl:223-227)."""
    cosa = F(hit_n @ d)
    new_d = _normalize(d - hit_n * cosa * F(2.0))
    return (hit_p + hit_n * F(0.001)).astype(np.float32), new_d


def trace_pixel(pixel_id, seeds, cam, tris_np, mats_np, iterations,
                trace: OracleTrace | None = None, env=None):
    """One sample of trace_ray for one pixel (prog.cl:292-377), with the
    gen_ray that precedes it (prog.cl:384-389). Returns the sample color
    (before progressive averaging); mutates seeds[pixel_id].

    env: optional models.megakernel.EnvLight — executes the dormant
    miss-branch sky code (prog.cl:367-376) literally: primary miss adds
    sky*scale; miss with cntr<=0 (no diffuse bounce yet, cntr++ only in
    the type-0 branch, prog.cl:339) adds sky*scale*(factor_L+factor_B)
    *factor_S*factor_R; otherwise deep*(same factors)."""
    kd, ks, emission, f0, n_mat, shin, mtype = mats_np

    def log(ev, **kw):
        if trace is not None:
            trace.events.append(dict(ev=ev, **kw))

    # gen_ray: two unconditional draws (prog.cl:388).
    s_before = int(seeds[pixel_id])
    g1 = rand(seeds, pixel_id)
    g2 = rand(seeds, pixel_id)
    ray_p, ray_d = camera_get_ray(pixel_id, cam, g1, g2)
    log("gen_ray", seed_in=s_before, r1=float(g1), r2=float(g2),
        seed_out=int(seeds[pixel_id]), d=ray_d.tolist(),
        cite="prog.cl:384-389, 82-92")

    one3 = np.ones(3, np.float32)
    factor_l = one3.copy()
    factor_b = one3.copy()
    factor_s = one3.copy()
    factor_r = one3.copy()
    color = np.zeros(3, np.float32)
    inside = False
    cntr = 0  # diffuse bounces (prog.cl:316,339)

    for current in range(iterations):
        t, hp, hn, mati = first_intersect(tris_np, ray_p, ray_d)
        if not (t > 0):
            if env is not None:
                sky = np.asarray(env.sky, np.float32) * F(env.scale)
                if current == 0:        # prog.cl:368-369
                    color = (color + sky).astype(np.float32)
                elif cntr <= 0:         # prog.cl:370-371
                    color = (color + sky * (factor_l + factor_b)
                             * factor_s * factor_r).astype(np.float32)
                else:                   # prog.cl:372-373
                    deep = np.asarray(env.deep, np.float32)
                    color = (color + deep * (factor_l + factor_b)
                             * factor_s * factor_r).astype(np.float32)
            log("miss_break", bounce=current, cite="prog.cl:367-376")
            break
        mt = int(mtype[mati])
        if iterations == 1:  # preview (prog.cl:323-325)
            color = (kd[mati] + emission[mati]).astype(np.float32)
        if F(ray_d @ hn) > 0:  # flip toward ray (prog.cl:326-328)
            hn = (-hn).astype(np.float32)
        log("hit", bounce=current, t=float(t), mati=mati, mtype=mt,
            p=hp.tolist(), n=hn.tolist(), cite="prog.cl:319-328")

        if mt == 0:  # diffuse (prog.cl:329-341)
            r1 = rand(seeds, pixel_id)
            r2 = rand(seeds, pixel_id)
            new_p, new_d = new_ray_diffuse(hp, hn, r1, r2)
            cos_theta = F(new_d @ hn)
            intensity_diffuse = max(F(0.0), cos_theta)
            factor_l = (factor_l * (kd[mati] * intensity_diffuse)).astype(
                np.float32
            )
            view = _normalize(_host(cam.eye) - hp)
            halfway = _normalize(view + new_d)
            cos_delta = F(hn @ halfway)
            intensity_specular = max(F(0.0), cos_delta)
            factor_b = (factor_b * (
                ks[mati] * intensity_specular ** F(shin[mati])
            )).astype(np.float32)
            cntr += 1  # prog.cl:339
            log("diffuse", r1=float(r1), r2=float(r2),
                seed_out=int(seeds[pixel_id]), new_d=new_d.tolist(),
                factor_l=factor_l.tolist(), factor_b=factor_b.tolist(),
                cite="prog.cl:329-341, 205-218")
            ray_p, ray_d = new_p, new_d
        elif mt == 1:  # specular (prog.cl:342-346)
            fr = fresnel(f0[mati], hn, ray_d)
            new_p, new_d = new_ray_specular(hp, hn, ray_d)
            factor_s = (factor_s * fr).astype(np.float32)
            log("specular", fresnel=fr.tolist(),
                factor_s=factor_s.tolist(), new_d=new_d.tolist(),
                cite="prog.cl:342-346, 223-227")
            ray_p, ray_d = new_p, new_d
        elif mt == 2:  # refractive (prog.cl:347-357, 228-245)
            before = inside
            # new_ray_refractive body, literally:
            n_eff = F(1.0) / F(n_mat[mati]) if inside else F(n_mat[mati])
            cosa = F((-ray_d) @ hn)
            disc = F(1.0) - (F(1.0) - cosa * cosa) / n_eff / n_eff
            fr = fresnel(f0[mati], hn, ray_d)
            prob = F((fr[0] + fr[1] + fr[2]) / F(3.0))
            rr = rand(seeds, pixel_id)
            if disc > 0 and rr > prob:
                inside = not inside
                new_p = (hp - hn * F(0.001)).astype(np.float32)
                new_d = _normalize(
                    ray_d / n_eff
                    + hn * (cosa / n_eff - np.sqrt(disc))
                )
            else:
                new_p, new_d = new_ray_specular(hp, hn, ray_d)
            if before != inside:
                factor_r = (factor_r * (F(1.0) - fr)
                            * (F(1.0) / (F(1.0) - prob))).astype(
                                np.float32)
            else:
                factor_r = (factor_r * fr
                            * (F(1.0) / prob)).astype(np.float32)
            log("refractive", rnd=float(rr), prob=float(prob),
                refracted=before != inside, inside=inside,
                seed_out=int(seeds[pixel_id]),
                factor_r=factor_r.tolist(), new_d=new_d.tolist(),
                cite="prog.cl:347-357, 228-245")
            ray_p, ray_d = new_p, new_d
        elif mt == 3:  # emitter (prog.cl:358-366)
            cos_theta = F((-ray_d) @ hn)
            intensity = max(F(0.0), cos_theta)
            r1 = rand(seeds, pixel_id)
            r2 = rand(seeds, pixel_id)
            new_p, new_d = new_ray_diffuse(hp, hn, r1, r2)
            color = (color + emission[mati] * (factor_l + factor_b)
                     * factor_s * factor_r * intensity).astype(np.float32)
            log("emitter", r1=float(r1), r2=float(r2),
                seed_out=int(seeds[pixel_id]),
                contrib_color=color.tolist(), intensity=float(intensity),
                cite="prog.cl:358-366")
            ray_p, ray_d = new_p, new_d
    return color


def scene_to_numpy(scene):
    """(r1, r2, r3, N, mati) host arrays from a builder Scene (any
    device); face normals exactly as TrianglesSoA computed them."""
    t = scene.tris
    return (_host(t.r1), _host(t.r2), _host(t.r3), _host(t.n),
            _host(t.mati, np.int64))


def mats_to_numpy(mats):
    """(kd, ks, emission, f0, n, shininess, type) host arrays of a
    MaterialsSoA (any device); colors as (M, 3)."""
    def rgb(v):
        return np.stack([_host(c) for c in v], axis=-1)

    return (rgb(mats.kd), rgb(mats.ks), rgb(mats.emission), rgb(mats.f0),
            _host(mats.n), _host(mats.shininess),
            _host(mats.type, np.int64))


def render_oracle(scene, cam, *, width, height, iterations, spp,
                  seed=1, pixels=None, env=None):
    """Progressive oracle render. pixels: optional subset of pixel ids
    (for transcript / spot checks); default all.

    Returns (colors (N, 3) f32 — only `pixels` rows filled if subset,
    seeds (N,) uint32 final Lehmer states)."""
    n = width * height
    # The camera's vectors on the host once (the walk reads them a pixel).
    cam = types.SimpleNamespace(xm=cam.xm, ym=cam.ym, eye=_host(cam.eye),
                                lookat=_host(cam.lookat), up=_host(cam.up),
                                right=_host(cam.right))
    tris_np = scene_to_numpy(scene)
    mats_np = mats_to_numpy(scene.mats)
    seeds = minstd_rand0_raw(n, seed).astype(np.int64)
    colors = np.zeros((n, 3), np.float32)
    pix = range(n) if pixels is None else pixels
    for s in range(spp):
        s_f = F(s)
        inv = F(1.0) / (s_f + F(1.0))
        for pid in pix:
            c = trace_pixel(pid, seeds, cam, tris_np, mats_np,
                            iterations, env=env)
            # progressive average (prog.cl:379)
            colors[pid] = (colors[pid] * s_f + c) * inv
    return colors, seeds.astype(np.uint32)
