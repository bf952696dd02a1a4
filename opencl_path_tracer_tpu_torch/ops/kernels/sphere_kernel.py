"""K3 and K3b: nearest analytic-sphere hit (CUDA kernels and plain
versions).

Port of `opencl_path_tracer_tpu/ops/pallas/sphere_kernel.py`:
`_sphere_kernel` (launched by `_run_spheres`, up to 64 spheres),
`_sphere_table_kernel` (launched by `_run_sphere_table`, any count),
`make_sphere_intersect`, which sends more than 64 spheres to the table
kernel, and `make_sphere_table_intersect`.

Per (ray, sphere), in the TPU kernel's order: b = p.d - d.c,
cc = p.p - 2 p.c + (c.c - r^2), disc = b^2 - cc, t = -b - sqrt(disc)
when that is > 0, else -b + sqrt(disc); a hit needs disc > 0 and t > 0.
A strict < across spheres keeps the lower index on ties. The outward
normal is (p + t d - c) / r, with 1/r and c.c - r^2 precomputed in
float32. On a miss t = -1 and the normal and material are 0.

XLA fuses multiply-adds in the interpret-mode reference; the plain
versions apply `core.fp.fma` where it does, and the CUDA kernels
(`csrc/spheres.cu`, `csrc/sphere_table.cu`) `__fmaf_rn`. The JAX package
warns that its two kernels need not agree bit for bit, as XLA may
contract them differently; a probe of interpret-mode K3b on the CPU
(3,000 rays at the 66 spheres of `many_light_scene(64)`) found every
dot product fma(a2, b2, fma(a0, b0, a1 * b1)), disc = fma(b, b, -cc) and
p + t d = fma(d, t, p), which K3b's plain version and kernel use: t,
all three normal components and mati come out bit-equal. K3b fetches
the winner's row after the loop (the TPU's one-hot matmul, an indexed
load plus `+ 0.0` here).

On the card K3b walks groups of at most SPHERE_GROUP spheres in Morton
order (`sphere_groups`, built on the host once per scene) and skips per
ray each group whose box, widened by the margin proved in
`csrc/sphere_table.cu`, its segment to its running best misses; it
merges with the lowest table index on exact-t ties, so its outputs are
the table-order scan's bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from opencl_path_tracer_tpu_torch.core import fp
from opencl_path_tracer_tpu_torch.core.spheres import SpheresSoA
from opencl_path_tracer_tpu_torch.core.types import Hits, Rays
from opencl_path_tracer_tpu_torch.accel.lbvh import morton3
from opencl_path_tracer_tpu_torch.ops.kernels import _build
from opencl_path_tracer_tpu_torch.ops.kernels.cluster_kernel import (
    _f32_down, _f32_up,
)
from opencl_path_tracer_tpu_torch.ops.kernels.intersect_kernel import (
    BIG, assemble_hits, pack_rays,
)

MAX_SPHERES = 64
SPH_COLS = 8
# K3b's groups (csrc/sphere_table.cu): at most SPHERE_GROUP spheres each,
# GROUP_F4 float4s a group ([lo A] [hi Gp], the members' [c ccdot], their
# table indices as int bits), staged through shared memory.
SPHERE_GROUP = 8
GROUP_F4 = 2 + SPHERE_GROUP + SPHERE_GROUP // 4
# The margin's coefficient (csrc/sphere_table.cu): X within 2^-8 (|P|_1 +
# |c| + sqrt|ccdot| + 2^-50) of the sphere's box, and its ranges.
MARGIN = 2.0 ** -8
MARGIN_FLOOR = 2.0 ** -50
COORD_LIMIT = 2.0 ** 60
CCDOT_LIMIT = 2.0 ** 120


class SphereGroups(NamedTuple):
    """K3b's group table, (G, GROUP_F4, 4) float32 on the sphere table's
    device, for a table of n_rows spheres."""
    data: torch.Tensor
    n_rows: int


def sphere_groups(table: torch.Tensor) -> SphereGroups:
    """K3b's groups of the (S, 8) sphere table, built on the host in
    float64: the rows with live > 0 (the others never hit) in Morton order
    of their centres, SPHERE_GROUP at a time; per group the union of its
    spheres' boxes [c - r_box, c + r_box] with r_box^2 = |c|^2 - ccdot
    (enlarged for float64's roundings), A = MARGIN (|c| + sqrt|ccdot| +
    MARGIN_FLOOR) at its largest and Gp = MARGIN, rounded outward to
    float32 ([lo A] [hi Gp], as `cluster_kernel.sub_boxes`); then the
    members' [cx cy cz ccdot] (an unused place [0 0 0 +inf], which never
    hits) and their table indices (-1 unused) as int32 bits. A group with a
    sphere outside the margin's ranges (c or ccdot not finite, |c_i| >
    2^60 or |ccdot| > 2^120) gets lo = -inf, hi = inf, A = inf: it is never
    skipped."""
    tab = table.detach().cpu().numpy().astype(np.float32)
    live = np.nonzero(tab[:, 7] > 0)[0]
    c = tab[live, 0:3].astype(np.float64)
    ccd = tab[live, 5].astype(np.float64)
    with np.errstate(invalid="ignore", over="ignore"):
        ok = ((np.abs(c) <= COORD_LIMIT).all(1)
              & (np.abs(ccd) <= CCDOT_LIMIT))      # NaN fails too
        cf = np.where(ok[:, None], c, 0.0)
        lo_c, hi_c = (cf.min(0), cf.max(0)) if live.size else (0.0, 1.0)
        q = (cf - lo_c) / np.maximum(hi_c - lo_c, 1e-30)
    order = np.argsort(morton3(np.clip(q, 0.0, 1.0 - 2.0 ** -24)),
                       kind="stable")
    live, c, ccd, ok = live[order], c[order], ccd[order], ok[order]
    n = live.size
    g = -(-n // SPHERE_GROUP)
    pad = g * SPHERE_GROUP - n
    with np.errstate(invalid="ignore", over="ignore"):
        cn = np.sqrt((c * c).sum(1))
        scale = (c * c).sum(1) + np.abs(ccd)
        r2 = (c * c).sum(1) - ccd + 2.0 ** -50 * scale
        r_box = np.sqrt(np.maximum(r2, 0.0))
        # The float64 roundings of r_box, c -+ ext and A stay far below
        # these enlargements.
        ext = r_box + 2.0 ** -40 * (np.abs(c).max(1) + r_box)
        a = MARGIN * (cn + np.sqrt(np.abs(ccd)) + MARGIN_FLOOR) * (
            1 + 2.0 ** -40)
    lo = np.concatenate([c - ext[:, None], np.full((pad, 3), np.inf)])
    hi = np.concatenate([c + ext[:, None], np.full((pad, 3), -np.inf)])
    a = np.concatenate([a, np.zeros(pad)])
    bad = np.concatenate([~ok, np.zeros(pad, bool)])
    out = np.zeros((g, GROUP_F4, 4), np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        out[:, 0, 0:3] = _f32_down(lo.reshape(g, SPHERE_GROUP, 3).min(1))
        out[:, 1, 0:3] = _f32_up(hi.reshape(g, SPHERE_GROUP, 3).max(1))
        out[:, 0, 3] = _f32_up(a.reshape(g, SPHERE_GROUP).max(1))
    out[:, 1, 3] = np.float32(MARGIN)
    never = bad.reshape(g, SPHERE_GROUP).any(1)
    out[never, 0, :] = [-np.inf, -np.inf, -np.inf, np.inf]
    out[never, 1, 0:3] = np.inf
    mem = np.zeros((g * SPHERE_GROUP, 4), np.float32)
    mem[:, 3] = np.inf
    mem[:n, 0:3] = tab[live, 0:3]
    mem[:n, 3] = tab[live, 5]
    out[:, 2:2 + SPHERE_GROUP] = mem.reshape(g, SPHERE_GROUP, 4)
    idx = np.full(g * SPHERE_GROUP, -1, np.int32)
    idx[:n] = live
    out[:, 2 + SPHERE_GROUP:] = idx.view(np.float32).reshape(
        g, SPHERE_GROUP // 4, 4)
    return SphereGroups(data=torch.from_numpy(out).to(table.device),
                        n_rows=tab.shape[0])


def build_sphere_table(spheres: SpheresSoA) -> torch.Tensor:
    """(S, 8) float32 rows [cx cy cz rad 1/rad ccdot mati live] with
    ccdot = c.c - r^2, computed in float32 like the TPU kernels'
    constants, and live = 1 (K3b's table marks padding rows 0; K3
    ignores the column)."""
    c = [np.asarray(x.cpu(), np.float32) for x in spheres.c]
    rad = np.asarray(spheres.rad.cpu(), np.float32)
    tab = np.zeros((spheres.count, SPH_COLS), np.float32)
    for k in range(3):
        tab[:, k] = c[k]
    tab[:, 3] = rad
    tab[:, 4] = np.float32(1.0) / rad
    tab[:, 5] = (c[0] * c[0] + c[1] * c[1] + c[2] * c[2] - rad * rad)
    tab[:, 6] = np.asarray(spheres.mati.cpu(), np.float32)
    tab[:, 7] = 1.0
    return torch.as_tensor(tab, device=spheres.rad.device)


def _dot3(a, b):
    return fp.fma(a[2], b[2], fp.fma(a[0], b[0], a[1] * b[1]))


def spheres_plain(rays8: torch.Tensor, table: torch.Tensor):
    """Plain PyTorch version of K3: (t, nx, ny, nz, m), (R,) float32. K3
    keeps its best normal in the loop, K3b fetches the winner's row after
    it; the arithmetic and the tie rule are the same, so this is K3b's
    plain version."""
    return sphere_table_plain(rays8, table)


def spheres(rays8: torch.Tensor, table: torch.Tensor):
    """K3 for the (8, R) ray pack against the (S, 8) sphere table. CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    _build.check(rays8, "rays8", (8, None))
    _build.check(table, "sphere table", (None, SPH_COLS))
    if rays8.device != table.device:
        raise ValueError("rays8 and the sphere table must be on one device")
    if not 0 < table.shape[0] <= MAX_SPHERES:
        raise ValueError(
            f"{table.shape[0]} spheres: K3 takes 1 to {MAX_SPHERES}; "
            "make_sphere_intersect sends more to K3b (sphere_table)")
    if rays8.device.type == "cpu":
        return spheres_plain(rays8, table)
    r = rays8.shape[1]
    outs = [torch.empty(r, dtype=torch.float32, device=rays8.device)
            for _ in range(5)]
    _build.launch("spheres", rays8, table, *outs, r, table.shape[0])
    return tuple(outs)


def sphere_table_plain(rays8: torch.Tensor, table: torch.Tensor,
                       ray_chunk: int = 65536):
    """Plain PyTorch version of K3b: (t, nx, ny, nz, m), (R,) float32."""
    r = rays8.shape[1]
    outs = [torch.empty(r, dtype=torch.float32, device=rays8.device)
            for _ in range(5)]
    col = table[:, :, None]                          # (S, 8, 1)
    c = (col[:, 0], col[:, 1], col[:, 2])
    for s in range(0, r, ray_chunk):
        x = rays8[:, s:s + ray_chunk]
        p, d = (x[0], x[1], x[2]), (x[3], x[4], x[5])
        b_half = _dot3(p, d) - _dot3(d, c)           # (S, Rc)
        cc = (_dot3(p, p) - 2.0 * _dot3(p, c)) + col[:, 5]
        disc = fp.fma(b_half, b_half, -cc)
        sq = fp.sqrt(torch.clamp_min(disc, 0.0))
        t_near = -b_half - sq
        t = torch.where(t_near > 0.0, t_near, -b_half + sq)
        valid = (disc > 0.0) & (t > 0.0) & (col[:, 7] > 0.0)
        best_t, g = torch.min(torch.where(valid, t, torch.full_like(t, BIG)),
                              dim=0)                 # first index on ties
        hit = best_t < BIG
        row = table[g] + 0.0
        safe_t = torch.where(hit, best_t, torch.zeros_like(best_t))
        z = torch.zeros_like(best_t)
        outs[0][s:s + ray_chunk] = torch.where(hit, best_t,
                                               torch.full_like(z, -1.0))
        for k in range(3):
            n = (fp.fma(d[k], safe_t, p[k]) - row[:, k]) * row[:, 4]
            outs[1 + k][s:s + ray_chunk] = torch.where(hit, n, z)
        outs[4][s:s + ray_chunk] = torch.where(hit, row[:, 6], z)
    return tuple(outs)


def _check_table(rays8, table, groups):
    """(R, five output rows) after checking K3b's arguments; groups may be
    None (the plain version and the first kernel need none)."""
    _build.check(rays8, "rays8", (8, None))
    _build.check(table, "sphere table", (None, SPH_COLS))
    if rays8.device != table.device:
        raise ValueError("rays8 and the sphere table must be on one device")
    if table.shape[0] == 0:
        raise ValueError("K3b needs at least one sphere")
    if groups is not None:
        _build.check(groups.data, "groups.data", (None, GROUP_F4, 4))
        if groups.data.device != table.device:
            raise ValueError("groups.data must be on the table's device")
        if groups.n_rows != table.shape[0]:
            raise ValueError(f"groups of a table of {groups.n_rows} spheres, "
                             f"not {table.shape[0]}")
    r = rays8.shape[1]
    return r, [torch.empty(r, dtype=torch.float32, device=rays8.device)
               for _ in range(5)]


def sphere_table(rays8: torch.Tensor, table: torch.Tensor,
                 groups: SphereGroups | None = None):
    """K3b for the (8, R) ray pack against an (S, 8) sphere table of any
    size: (t, nx, ny, nz, m), five (R,) float32 tensors. groups: the
    table's `sphere_groups`, which the kernel needs
    (`make_sphere_table_intersect` builds them once per scene; the plain
    version ignores them). CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    r, outs = _check_table(rays8, table, groups)
    if rays8.device.type == "cpu":
        return sphere_table_plain(rays8, table)
    if groups is None:
        raise ValueError("sphere_table on CUDA tensors needs groups, the "
                         "table's sphere_groups")
    _build.launch("sphere_table", rays8, table, groups.data, *outs, r,
                  groups.data.shape[0])
    return tuple(outs)


def sphere_table_simt(rays8: torch.Tensor, table: torch.Tensor):
    """K3b's first kernel (`csrc/sphere_table.cu::sphere_table_simt_kernel`:
    every (ray, sphere) pair, the table staged in shared memory), on CUDA
    tensors: sphere_table's outputs. For the checks only (the smoke and the
    cuda tests hold the new kernel against it and time the two in turns);
    no render path calls it."""
    r, outs = _check_table(rays8, table, None)
    if rays8.device.type != "cuda":
        raise ValueError("sphere_table_simt runs on CUDA tensors only")
    _build.launch("sphere_table_simt", rays8, table, *outs, r,
                  table.shape[0])
    return tuple(outs)


def sphere_table_counted(rays8: torch.Tensor, table: torch.Tensor,
                         groups: SphereGroups):
    """sphere_table's kernel on CUDA tensors, also counting: (outputs,
    ((ray, group) box tests made, those that passed, pairs whose disc was
    computed in the groups a ray entered, those with disc > 0, (warp,
    group) steps that some lane of the warp entered)). For the checks
    only; no render path calls it."""
    r, outs = _check_table(rays8, table, groups)
    if rays8.device.type != "cuda":
        raise ValueError("sphere_table_counted runs on CUDA tensors only")
    count = torch.zeros(5, dtype=torch.int64, device=rays8.device)
    _build.launch("sphere_table_count", rays8, table, groups.data, *outs, r,
                  groups.data.shape[0], count)
    return tuple(outs), tuple(int(x) for x in count.tolist())


def make_sphere_table_intersect(sph: SpheresSoA):
    """intersect(rays) -> Hits over the analytic spheres through K3b
    (t = -1, p = 0, n = 0, mati = 0 on a miss); on the card the table's
    groups are built once here."""
    table = build_sphere_table(sph)
    groups = sphere_groups(table) if table.device.type == "cuda" else None

    def intersect(rays: Rays) -> Hits:
        return assemble_hits(rays, rays.count, *sphere_table(
            pack_rays(rays.p, rays.d), table, groups))

    return intersect


def make_sphere_intersect(sph: SpheresSoA):
    """intersect(rays) -> Hits over the analytic spheres (t = -1, p = 0,
    n = 0, mati = 0 on a miss): K3 up to 64 spheres, K3b above, as the
    JAX package dispatches."""
    if sph.count > MAX_SPHERES:
        return make_sphere_table_intersect(sph)
    table = build_sphere_table(sph)

    def intersect(rays: Rays) -> Hits:
        return assemble_hits(rays, rays.count,
                             *spheres(pack_rays(rays.p, rays.d), table))

    return intersect
