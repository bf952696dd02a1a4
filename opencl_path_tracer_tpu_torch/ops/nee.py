"""Next-event estimation (explicit light sampling) with MIS.

Port of `opencl_path_tracer_tpu/ops/nee.py`, which is plain XLA there and
plain PyTorch here: `EmitterTable`, `build_emitter_table`, the emitter
samplers (`sample_emitters` with the power-proportional compare-count
CDF or the per-lane 'distance' select, the triangle area sampler and the
sphere cone sampler), `direct_light` (one shadow ray per diffuse vertex)
and `pickup_mis_weight` (the balance-heuristic weight of the next
bounce's emitter pickup).

The reference is a pure path tracer (prog.cl:292-381): light reaches a
pixel only when a bounce ray happens to hit an emitter. At each diffuse
vertex x with flipped normal n, the gather samples a point y on an
emitter with area density p_area and adds

    (cos_l / pi) (f_l kd cos_l + f_b ks blinn(d_l)) f_s f_r emission
        * ecos^2 / r^2 / (p_area + p_bsdf) * V

where d_l is the unit direction x -> y, cos_l = max(0, d_l . n),
ecos = |d_l . m_y|, p_bsdf = (cos_l / pi) ecos / r^2 (the cosine
sampler's density in area measure) and V the visibility of y. The next
bounce's pickup of an emitter is weighted by p_bsdf / (p_bsdf + p_area),
computed from the previous bounce's direction pdf (`prev_pdf`, 0 for a
bounce that was not diffuse: full weight). Both terms sum to the base
estimator's expectation. Sphere emitters are cone-sampled in solid
angle and report the equivalent area density; the pickup recognises a
sphere emitter by its material id (emissive materials are kind-unique)
and its position.

Divisions keep the JAX package's single rounding: a host constant over
a tensor is divided as a tensor (PyTorch would multiply by the
reciprocal), and square roots are `core.fp.sqrt`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from opencl_path_tracer_tpu_torch.core import fp
from opencl_path_tracer_tpu_torch.core.types import (
    Rays, V3, vadd, vdot, vmul, vnormalize, vscale, vsub, vwhere,
)
from opencl_path_tracer_tpu_torch.ops import bsdf
from opencl_path_tracer_tpu_torch.ops.intersect import hits_of

_INV_PI = float(np.float32(1.0 / np.pi))
_TWO_PI = float(np.float32(2.0 * np.pi))
_LUM = (0.2126, 0.7152, 0.0722)  # Reinhard's weights (prog.cl:249)


def _cdiv(c: float, x: torch.Tensor) -> torch.Tensor:
    """float32(c) / x with one rounding (`c / x` in PyTorch multiplies by
    the reciprocal of x)."""
    return torch.tensor(c, dtype=x.dtype, device=x.device) / x


@dataclasses.dataclass(frozen=True)
class EmitterTable:
    """The scene's emitters as device tensors.

    Triangles (E entries): v0, e1, e2 (first vertex and edges), m (unit
    normals), emission: V3 of (E,); p_area (E,): the sampler's area
    density lum_i / total power; packed (E, 16): [v0 e1 e2 m emission
    p_area] for the per-lane row fetch. Spheres (Es entries): s_c,
    s_emission: V3 of (Es,); s_rad, s_sel (selection probability, the
    power fraction), s_mati (int32) of (Es,); s_packed (Es, 8): [c rad
    emission sel]; s_host (Es, 6) float32 numpy [c rad sel mati], the
    host copy the pickup loop reads. cum ((E + Es,)): inclusive
    cumulative power fractions, cum[-1] = 1. total_area and power_lum:
    0-dim tensors (summed triangle area, total power). select: 'power'
    (global power-proportional) or 'distance' (per-lane weights
    P_j / max(d^2, r_j^2), sphere emitters only)."""

    v0: V3
    e1: V3
    e2: V3
    m: V3
    emission: V3
    cum: torch.Tensor
    p_area: torch.Tensor
    total_area: torch.Tensor
    power_lum: torch.Tensor
    packed: torch.Tensor
    s_c: V3
    s_rad: torch.Tensor
    s_emission: V3
    s_sel: torch.Tensor
    s_mati: torch.Tensor
    s_packed: torch.Tensor
    s_host: np.ndarray
    select: str = "power"

    @property
    def count(self) -> int:
        return int(self.cum.shape[0])

    @property
    def tri_count(self) -> int:
        return int(self.p_area.shape[0])

    @property
    def sphere_count(self) -> int:
        return int(self.s_rad.shape[0])


def build_emitter_table(tris, mats, spheres=None,
                        select: str = "power") -> EmitterTable:
    """Collect the emissive triangles and analytic spheres (host side,
    once per scene) on the triangles' device.

    Raises if the scene has no emitter, if an emissive material id is
    used by both a triangle and a sphere (the pickup tells the kinds
    apart by material id), or for select='distance' with emissive
    triangles (only spheres carry an exact per-lane identity on the
    pickup side)."""
    if select not in ("power", "distance"):
        raise ValueError(f"unknown emitter select mode {select!r}")
    dev = tris.device
    mati = tris.mati.cpu().numpy()
    em_cols = [c.cpu().numpy() for c in mats.emission]
    em = np.stack([c[mati] for c in em_cols], axis=-1)
    is_em = np.any(em != 0.0, axis=-1)
    r1 = tris.r1.cpu().numpy()[is_em]
    r2 = tris.r2.cpu().numpy()[is_em]
    r3 = tris.r3.cpu().numpy()[is_em]
    e1 = r2 - r1
    e2 = r3 - r1
    cr = np.cross(e1, e2)
    area = 0.5 * np.linalg.norm(cr, axis=-1)
    keep = area > 0.0  # degenerate faces are never hit (n = 0)
    r1, e1, e2, cr, area = (a[keep] for a in (r1, e1, e2, cr, area))
    em = em[is_em][keep]
    tri_mati_em = mati[is_em][keep]
    m = cr / np.maximum(np.linalg.norm(cr, axis=-1, keepdims=True), 1e-30)
    total = float(area.sum())
    lum = em @ np.asarray(_LUM, np.float32)
    power = area * lum

    if spheres is not None and spheres.count:
        s_mati = spheres.mati.cpu().numpy()
        s_em_all = np.stack([c[s_mati] for c in em_cols], axis=-1)
        s_is_em = np.any(s_em_all != 0.0, axis=-1)
        s_c = np.stack([c.cpu().numpy() for c in spheres.c],
                       axis=-1)[s_is_em]
        s_rad = spheres.rad.cpu().numpy()[s_is_em]
        s_em = s_em_all[s_is_em]
        s_mati = s_mati[s_is_em]
        shared = np.intersect1d(np.unique(tri_mati_em), np.unique(s_mati))
        if shared.size:
            raise ValueError(
                "NEE pickup identifies the emitter kind by material id, but "
                f"material(s) {shared.tolist()} are emissive on both a "
                "triangle and an analytic sphere; give the sphere emitters "
                "their own material")
    else:
        s_c = np.zeros((0, 3), np.float32)
        s_rad = np.zeros((0,), np.float32)
        s_em = np.zeros((0, 3), np.float32)
        s_mati = np.zeros((0,), np.int32)
    s_lum = s_em @ np.asarray(_LUM, np.float32)
    s_power = 4.0 * np.pi * s_rad * s_rad * s_lum

    if power.size + s_power.size == 0 or not (
            float(power.sum()) + float(s_power.sum()) > 0.0):
        raise ValueError("NEE needs at least one emitter (emissive triangle "
                         "or analytic sphere)")
    if select == "distance" and power.size:
        raise ValueError(
            "select='distance' needs analytic-sphere emitters only (found "
            f"{power.size} emissive triangles): the pickup MIS side can only "
            "identify sphere emitters exactly; use select='power'")
    w_total = float(power.sum()) + float(s_power.sum())
    cum = np.cumsum(np.concatenate([power, s_power]) / w_total).astype(
        np.float32)
    cum[-1] = 1.0
    p_area = (lum / w_total).astype(np.float32)
    s_sel = (s_power / w_total).astype(np.float32)
    packed = np.concatenate([r1, e1, e2, m, em, p_area[:, None]],
                            axis=-1).astype(np.float32)
    s_packed = np.concatenate([s_c, s_rad[:, None], s_em, s_sel[:, None]],
                              axis=-1).astype(np.float32)
    s_host = np.concatenate([s_c, s_rad[:, None], s_sel[:, None],
                             s_mati[:, None]], axis=-1).astype(np.float32)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    def v3(a):
        return tuple(t(a[:, k]) for k in range(3))

    return EmitterTable(
        v0=v3(r1), e1=v3(e1), e2=v3(e2), m=v3(m), emission=v3(em),
        cum=t(cum), p_area=t(p_area), total_area=t(np.float32(total)),
        power_lum=t(np.float32(w_total)), packed=t(packed),
        s_c=v3(s_c), s_rad=t(s_rad), s_emission=v3(s_em), s_sel=t(s_sel),
        s_mati=t(s_mati, torch.int32), s_packed=t(s_packed), s_host=s_host,
        select=select,
    )


def _fetch_rows(packed: torch.Tensor, idx: torch.Tensor, ncols: int):
    """Per-lane row fetch: one row gather at every table size. The JAX
    package uses a chain of wheres for 64 rows or fewer, a choice made
    on TPU gather timings; for indices in [0, rows - 1], which is all
    NEE produces, the gather returns the same bits, signed zeros
    included."""
    row = packed[idx.long()]
    return [row[:, c] for c in range(ncols)]


def _sample_tri(table: EmitterTable, idx, u2, u3):
    """Point on emissive triangle idx by sqrt-warped barycentrics:
    (y, m, emission, p_area) per lane."""
    cols = _fetch_rows(table.packed, idx, 16)

    def col3(base):
        return (cols[base], cols[base + 1], cols[base + 2])

    s = fp.sqrt(u2)
    b1 = s * (1.0 - u3)
    b2 = s * u3
    y = vadd(col3(0), vadd(vscale(col3(3), b1), vscale(col3(6), b2)))
    return y, col3(9), col3(12), cols[15]


def _distance_select(table: EmitterTable, origin: V3, u1):
    """Per-lane pick over the spheres with weights w_j = P_j / max(|x -
    c_j|^2, r_j^2): (idx, sel), the chosen index and its selection
    probability w_idx / sum_j w_j. Three streaming passes, no (Es, N)
    array."""

    def weight(j):
        c = (table.s_c[0][j], table.s_c[1][j], table.s_c[2][j])
        dv = vsub(c, origin)
        d2 = vdot(dv, dv)
        r2 = table.s_rad[j] * table.s_rad[j]
        return table.s_sel[j] / torch.maximum(d2, r2)

    es = table.sphere_count
    total = weight(0)
    for j in range(1, es):
        total = total + weight(j)
    target = u1 * total
    acc = torch.zeros_like(u1)
    idx = torch.zeros(u1.shape, dtype=torch.int32, device=u1.device)
    for j in range(es - 1):
        acc = acc + weight(j)
        idx = idx + (acc < target).to(torch.int32)
    sel = weight(0)
    for j in range(1, es):
        sel = torch.where(idx == j, weight(j), sel)
    return idx, sel / torch.clamp_min(total, 1e-30)


def _sample_sphere(table: EmitterTable, idx, origin: V3, u2, u3, sel=None):
    """Cone-sample emissive sphere idx as seen from origin (the whole
    sphere of directions from inside): the forward hit y, its outward
    normal m, the emission and the equivalent area density
    p_area = pdf_sa * ecos / r^2."""
    cols = _fetch_rows(table.s_packed, idx, 8)
    c = (cols[0], cols[1], cols[2])
    rad, emission = cols[3], (cols[4], cols[5], cols[6])
    if sel is None:  # power mode: the static power fraction
        sel = cols[7]
    dcv = vsub(c, origin)
    dc2 = vdot(dcv, dcv)
    safe_dc2 = torch.clamp_min(dc2, 1e-12)
    outside = dc2 > rad * rad
    cosmax = torch.where(
        outside, fp.sqrt(torch.clamp_min(1.0 - rad * rad / safe_dc2, 0.0)),
        torch.full_like(dc2, -1.0))
    one_minus = 1.0 - cosmax
    cos_t = 1.0 - u2 * one_minus
    sin_t = fp.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = _TWO_PI * u3
    w_axis = vscale(dcv, 1.0 / fp.sqrt(safe_dc2))
    t1v, t2v = bsdf.orthonormal_base(w_axis)
    d = vadd(vscale(w_axis, cos_t),
             vadd(vscale(t1v, sin_t * torch.cos(phi)),
                  vscale(t2v, sin_t * torch.sin(phi))))
    b = vdot(d, dcv)
    disc = torch.clamp_min(b * b - (dc2 - rad * rad), 0.0)
    sq = fp.sqrt(disc)
    t = torch.where(outside, b - sq, b + sq)
    y = vadd(origin, vscale(d, t))
    m = vnormalize(vsub(y, c))
    q_sa = sel / (_TWO_PI * one_minus)
    ecos = torch.abs(vdot(d, m))
    p_area = q_sa * ecos / torch.clamp_min(t * t, 1e-12)
    return y, m, emission, p_area


def sample_emitters(table: EmitterTable, u1, u2, u3, origin: V3 = None):
    """One emitter sample per lane: (y, m, emission, p_area), p_area in
    area measure at y. u1 picks the emitter (power-proportional by a
    compare-count over the cumulative table, or the 'distance' select);
    (u2, u3) place the point (sqrt-barycentrics on a triangle, a cone
    direction toward a sphere, which needs `origin`, the shading
    point)."""
    if table.select == "distance":
        if origin is None:
            raise ValueError("sample_emitters needs `origin` for "
                             "select='distance'")
        idx, sel = _distance_select(table, origin, u1)
        return _sample_sphere(table, idx, origin, u2, u3, sel=sel)
    idx = (table.cum[None, :] < u1[:, None]).sum(dim=1)
    idx = torch.clamp_max(idx, table.count - 1).to(torch.int32)
    et, es = table.tri_count, table.sphere_count
    if es == 0:
        return _sample_tri(table, idx, u2, u3)
    if origin is None:
        raise ValueError("sample_emitters needs `origin` (the shading "
                         "point) when the table has analytic-sphere emitters")
    if et == 0:
        return _sample_sphere(table, idx, origin, u2, u3)
    is_sph = idx >= et
    yt, mt, emt, pt = _sample_tri(table, torch.clamp_max(idx, et - 1),
                                  u2, u3)
    ys, ms, ems, ps = _sample_sphere(table, torch.clamp(idx - et, 0, es - 1),
                                     origin, u2, u3)
    return (vwhere(is_sph, ys, yt), vwhere(is_sph, ms, mt),
            vwhere(is_sph, ems, emt), torch.where(is_sph, ps, pt))


def direct_light(table: EmitterTable, *, intersect_fn, cam_eye, hit_p: V3,
                 n_vec: V3, mat, f_l: V3, f_b: V3, f_s: V3, f_r: V3,
                 is_diff, u1, u2, u3, occluded_fn=None) -> V3:
    """Per-lane NEE contribution (zeros where is_diff is false): one
    emitter sample and one shadow ray from hit_p + EPS n. `mat` is the
    per-lane material (kd, ks, shininess); cam_eye gives the Blinn
    term's camera halfway vector (prog.cl:79-81, :335).

    Visibility of y at distance dist: with occluded_fn (the any-hit
    contract, occluded(rays, rmax) -> bool), visible = ~occluded(rays,
    dist (1 - 1e-3)); otherwise the shadow ray goes through
    intersect_fn and visible = miss or t >= dist (1 - 1e-3). Both give
    the same bits, but where a ray grazes a zero-area triangle, which the
    any-hit kernel's group culling never reaches (ROADMAP.md queue 3)."""
    n = u1.shape[0]
    origin = vadd(hit_p, vscale(n_vec, bsdf.EPS))
    y, m_y, emission, p_area = sample_emitters(table, u1, u2, u3,
                                               origin=origin)
    delta = vsub(y, origin)
    dist2 = vdot(delta, delta)
    dist = fp.sqrt(dist2)
    d_l = vscale(delta, 1.0 / torch.clamp_min(dist, 1e-12))
    cos_l = torch.clamp_min(vdot(d_l, n_vec), 0.0)
    ecos = torch.abs(vdot(d_l, m_y))
    rmax = dist * (1.0 - 1e-3)
    if occluded_fn is not None:
        visible = ~occluded_fn(Rays(p=origin, d=d_l), rmax)
    else:
        sh = hits_of(intersect_fn(Rays(p=origin, d=d_l)))
        visible = (~sh.valid) | (sh.t >= rmax)
    eye_dir = vnormalize(tuple(cam_eye[k] - hit_p[k] for k in range(3)))
    halfway = vnormalize(vadd(eye_dir, d_l))
    blinn = torch.pow(torch.clamp_min(vdot(n_vec, halfway), 0.0),
                      mat.shininess)
    w = vadd(vscale(vmul(f_l, mat.kd), cos_l),
             vscale(vmul(f_b, mat.ks), blinn))
    den2 = torch.clamp_min(dist2, 1e-12)
    p_bsdf = _INV_PI * cos_l * ecos / den2
    scale_mis = (_INV_PI * cos_l * ecos * ecos / den2
                 / torch.clamp_min(p_area + p_bsdf, 1e-30))
    contrib = vscale(vmul(vmul(vmul(w, f_s), f_r), emission), scale_mis)
    take_it = is_diff & visible & (cos_l > 0.0)
    zeros = tuple(torch.zeros(n, dtype=torch.float32, device=u1.device)
                  for _ in range(3))
    return vwhere(take_it, contrib, zeros)


def pickup_mis_weight(table: EmitterTable, prev_pdf, emit_cos, t,
                      emission: V3, *, mati=None, hit_p: V3 = None,
                      ray_p: V3 = None):
    """Balance-heuristic weight of an emitter pickup reached by the
    previous bounce's cosine-sampled ray: p_bsdf / (p_bsdf + p_area)
    where prev_pdf > 0, else 1. p_area is the gather's density at the
    hit: lum(emission) / total power for a triangle; for a hit on an
    emissive sphere (found by material id, and among spheres sharing it
    by |hit_p - c_j|), the cone density recomputed from the previous
    vertex ray_p. mati, hit_p and ray_p are needed when the table has
    sphere emitters."""
    p_bsdf = prev_pdf * emit_cos / torch.clamp_min(t * t, 1e-12)
    lum = (_LUM[0] * emission[0] + _LUM[1] * emission[1]
           + _LUM[2] * emission[2])
    p_area = lum / table.power_lum
    es = table.sphere_count
    if es:
        if mati is None or hit_p is None or ray_p is None:
            raise ValueError("pickup_mis_weight needs mati/hit_p/ray_p when "
                             "the emitter table has analytic-sphere emitters")
        sh = table.s_host

        def w_of(j):
            cj = tuple(float(sh[j, k]) for k in range(3))
            dv = vsub(cj, ray_p)
            d2 = vdot(dv, dv)
            r2j = float(sh[j, 3] * sh[j, 3])
            return _cdiv(float(sh[j, 4]), torch.clamp_min(d2, r2j))

        if table.select == "distance":
            total_w = w_of(0)
            for j in range(1, es):
                total_w = total_w + w_of(j)
        best = torch.full_like(t, float("inf"))
        for j in range(es):
            cj = tuple(float(sh[j, k]) for k in range(3))
            r2j = float(sh[j, 3] * sh[j, 3])
            dy = vsub(hit_p, cj)
            score = torch.abs(vdot(dy, dy) - r2j)
            dcv = vsub(cj, ray_p)
            dc2 = vdot(dcv, dcv)
            outside = dc2 > r2j
            cosmax = torch.where(
                outside,
                fp.sqrt(torch.clamp_min(
                    1.0 - _cdiv(r2j, torch.clamp_min(dc2, 1e-12)), 0.0)),
                torch.full_like(dc2, -1.0))
            if table.select == "distance":
                q_sa = (w_of(j) / torch.clamp_min(total_w, 1e-30)
                        / (_TWO_PI * (1.0 - cosmax)))
            else:
                q_sa = _cdiv(float(sh[j, 4]), _TWO_PI * (1.0 - cosmax))
            p_j = q_sa * emit_cos / torch.clamp_min(t * t, 1e-12)
            match = (mati == int(sh[j, 5])) & (score < best)
            p_area = torch.where(match, p_j, p_area)
            best = torch.where(match, score, best)
    return torch.where(prev_pdf > 0.0,
                       p_bsdf / torch.clamp_min(p_bsdf + p_area, 1e-30),
                       torch.ones_like(p_bsdf))
