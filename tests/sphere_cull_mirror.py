"""An exact float32 mirror of K3b's loop (csrc/sphere_table.cu) on the
CPU, and a crafted batch for it. Shared by tests/test_torch_sphere_cull.py,
tests/test_torch_cuda.py and chip_smoke.py.

The loop walks the groups of `sphere_kernel.sphere_groups` in order and
skips, per ray, a group whose box (widened by I = A + Gp |P|_1, the
sphere margin) its segment P + s D, 0 <= s <= best, misses: the slab test
is tests/sub_cull_mirror.py's (CUDA's directed roundings emulated
exactly), with |P|_1 made infinite for a ray outside the margin's ranges.
In a group a ray enters, each sphere's b, cc and disc are the kernel's
(`core.fp.fma`, correctly rounded sqrt), and a pair with disc > 0 and t >
0 is merged with t < best or (t == best and index < best index), from
(BIG, -1). The warp's votes only skip work that changes nothing, so the
mirror has none.
"""

import numpy as np
import torch

from sub_cull_mirror import box_maybe, cull_ray
from opencl_path_tracer_tpu_torch.core import fp
from opencl_path_tracer_tpu_torch.ops.kernels import sphere_kernel as k3
from opencl_path_tracer_tpu_torch.ops.kernels.intersect_kernel import BIG

F32 = np.float32
BIG32 = F32(BIG)


def sphere_cull_ray(r8):
    """The slab test's ray for the (8, R) float32 rays: sub_cull_mirror's,
    with |P|_1 infinite outside the sphere margin's ranges (|P_i| <= 2^60
    and |fl(D.D) - 1| <= 2^-20; a NaN fails)."""
    p, rlo, rhi, pn = cull_ray(r8[0:3], r8[3:6])
    d = torch.from_numpy(np.ascontiguousarray(r8[3:6]))
    dd = k3._dot3(d, d).numpy()
    with np.errstate(invalid="ignore"):
        ok = ((np.abs(r8[0:3]) <= k3.COORD_LIMIT).all(0)
              & (np.abs(dd - F32(1.0)) <= F32(2.0 ** -20)))
    return p, rlo, rhi, np.where(ok, pn, F32(np.inf))


def pair_values(r8, members):
    """(disc, t) of every (member, ray) pair, (M, R) float32 each, as the
    kernel rounds them: members (M, 4) [cx cy cz ccdot]."""
    x = torch.from_numpy(np.ascontiguousarray(r8))
    p, d = (x[0], x[1], x[2]), (x[3], x[4], x[5])
    col = torch.from_numpy(np.ascontiguousarray(members))[:, :, None]
    c = (col[:, 0], col[:, 1], col[:, 2])
    b_half = k3._dot3(p, d) - k3._dot3(d, c)
    cc = (k3._dot3(p, p) - 2.0 * k3._dot3(p, c)) + col[:, 3]
    disc = fp.fma(b_half, b_half, -cc)
    sq = fp.sqrt(torch.clamp_min(disc, 0.0))
    t_near = -b_half - sq
    t = torch.where(t_near > 0.0, t_near, -b_half + sq)
    return disc.numpy(), t.numpy()


def mirrored_sphere_table(r8, table, groups):
    """K3b's loop on the (8, R) float32 rays r8 against the (S, 8) table
    and its `sphere_groups`: ((t, nx, ny, nz, m) as the kernel writes them,
    ((ray, group) box tests made, those that passed, pairs whose disc is
    computed in the groups a ray enters, those with disc > 0 there, (warp,
    group) steps that some ray of the warp (32 consecutive rays) enters))."""
    g = groups.data.cpu().numpy()
    n_groups = g.shape[0]
    members = g[:, 2:2 + k3.SPHERE_GROUP].reshape(-1, 4)
    idx = g[:, 2 + k3.SPHERE_GROUP:].reshape(n_groups, -1).view(np.int32)
    disc, t = pair_values(r8, members)
    disc = disc.reshape(n_groups, k3.SPHERE_GROUP, -1)
    t = t.reshape(n_groups, k3.SPHERE_GROUP, -1)
    cr = sphere_cull_ray(r8)
    r = r8.shape[1]
    bt = np.full(r, BIG32)
    bs = np.full(r, -1, np.int64)
    made = passed = n_disc = n_sqrt = n_warp = 0
    for gi in range(n_groups):
        box = np.concatenate([g[gi, 0], g[gi, 1]])[:, None]
        go = box_maybe(cr, box, bt)
        made += r
        passed += int(go.sum())
        n_warp += int(np.concatenate([go, np.zeros(-r % 32, bool)]).reshape(
            -1, 32).any(1).sum())
        for k in range(k3.SPHERE_GROUP):
            s = int(idx[gi, k])
            with np.errstate(invalid="ignore"):
                can = go & (disc[gi, k] > 0)
                tk = t[gi, k]
                win = can & (tk > 0) & ((tk < bt) | ((tk == bt) & (s < bs)))
            assert s >= 0 or not can.any()      # an unused place never hits
            n_disc += int(go.sum()) if s >= 0 else 0
            n_sqrt += int(can.sum())
            bt = np.where(win, tk, bt)
            bs = np.where(win, s, bs)
    hit = torch.from_numpy(bt < BIG32)
    best_t = torch.from_numpy(bt)
    row = table[torch.from_numpy(np.maximum(bs, 0))] + 0.0
    x = torch.from_numpy(np.ascontiguousarray(r8))
    z = torch.zeros_like(best_t)
    safe_t = torch.where(hit, best_t, z)
    outs = [torch.where(hit, best_t, torch.full_like(z, -1.0))]
    for k in range(3):
        n = (fp.fma(x[3 + k], safe_t, x[k]) - row[:, k]) * row[:, 4]
        outs.append(torch.where(hit, n, z))
    outs.append(torch.where(hit, row[:, 6], z))
    return tuple(outs), (made, passed, n_disc, n_sqrt, n_warp)


def _unit(v):
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def crafted_spheres():
    """(centres (S, 3), radii (S,), materials (S,)) for the crafted batch:
    ten copies of one sphere (exact-t ties that cross groups: a group holds
    eight), spheres of radius 1e-3, 0.1, 1e3 and 1e4 at several places
    (one at the origin), and 40 scattered spheres of radius 5 to 60."""
    rs = np.random.default_rng(41)
    c = [(300.0, 200.0, 100.0)] * 10
    r = [50.0] * 10
    for cen, rad in (((0.0, 0.0, 0.0), 1e-3), ((700.0, 300.0, -200.0), 1e-3),
                     ((-2000.0, 50.0, 30.0), 0.1), ((30000.0, 10.0, -20.0),
                                                    1e4),
                     ((5000.0, 5000.0, 5000.0), 1e3),
                     ((-300.0, 900.0, 400.0), 1e3)):
        c.append(cen)
        r.append(rad)
    for _ in range(40):
        c.append(tuple(rs.uniform(-1500.0, 1500.0, 3)))
        r.append(float(rs.uniform(5.0, 60.0)))
    m = np.arange(len(c), dtype=np.int32) % 13
    return np.float32(c), np.float32(r), m


KINDS = 6


def crafted_rays(centres, radii, n, seed=0):
    """(8, n) float32 unit-direction rays against the crafted spheres,
    lane i of kind i % KINDS: 0 grazing (tangent to a sphere, the tangent
    point nudged by -2..2 ulps of the radius, from up to 3 radii away);
    1 tangent at a face of the sphere's box (along an axis plane x_i = c_i
    +- r); 2 from inside a sphere (the origin near its centre or just under
    its surface); 3 from a sphere's surface point outward or inward; 4 aimed
    at a sphere's centre from afar (the tied copies among them); 5 a random
    direction from a random place."""
    rs = np.random.default_rng(seed)
    c = centres.astype(np.float64)
    rad = radii.astype(np.float64)
    k = rs.integers(0, c.shape[0], n)
    k[rs.random(n) < 0.2] = 0            # the tied copies
    ck, rk = c[k], rad[k]
    kind = np.arange(n) % KINDS
    u = _unit(rs.normal(size=(n, 3)))
    w = _unit(np.cross(u, rs.normal(size=(n, 3))))   # w orthogonal to u
    p = np.zeros((n, 3))
    d = np.zeros((n, 3))
    # 0: tangent at ck + rk u along w, from up to 3 radii back.
    m = kind == 0
    nudge = 1.0 + rs.integers(-2, 3, n) * 2.0 ** -24
    touch = ck + (rk * nudge)[:, None] * u
    back = rs.uniform(0.0, 3.0, n)[:, None] * rk[:, None]
    p[m], d[m] = (touch - back * w)[m], w[m]
    # 1: tangent at a box face: axis a, along axis b.
    m = kind == 1
    a = rs.integers(0, 3, n)
    b = (a + 1 + rs.integers(0, 2, n)) % 3
    sign = np.where(rs.random(n) < 0.5, -1.0, 1.0)
    face = ck.copy()
    face[np.arange(n), a] += sign * rk
    start = face.copy()
    start[np.arange(n), b] -= 2.0 * rk
    e = np.zeros((n, 3))
    e[np.arange(n), b] = 1.0
    p[m], d[m] = start[m], e[m]
    # 2: inside, near the centre or just under the surface.
    m = kind == 2
    depth = np.where(rs.random(n) < 0.5, rs.uniform(0.0, 0.1, n),
                     1.0 - rs.uniform(0.0, 1e-5, n))
    p[m] = (ck + (depth * rk)[:, None] * u)[m]
    d[m] = _unit(rs.normal(size=(n, 3)))[m]
    # 3: on the surface, outward or inward.
    m = kind == 3
    p[m] = (ck + rk[:, None] * u)[m]
    d[m] = np.where(rs.random((n, 1)) < 0.5, u, -u)[m]
    # 4: aimed at the centre from 2 to 50 radii away.
    m = kind == 4
    far = rs.uniform(2.0, 50.0, n)[:, None] * rk[:, None]
    p[m] = (ck + far * u)[m]
    d[m] = -u[m]
    # 5: random.
    m = kind == 5
    p[m] = rs.uniform(-3000.0, 3000.0, (n, 3))[m]
    d[m] = u[m]
    r8 = np.zeros((8, n), F32)
    r8[0:3] = p.T
    d32 = d.astype(F32)
    r8[3:6] = (d32 / np.sqrt((d32.astype(np.float64) ** 2).sum(1,
               keepdims=True)).astype(F32)).T
    return r8
