"""K3b with its groups (csrc/sphere_table.cu), on the CPU.

Per ray the kernel walks `sphere_kernel.sphere_groups`' groups of at most
eight spheres in Morton order and skips each whose box, widened by the
sphere margin that the kernel's header proves, its segment to its running
best misses; in a group it enters it runs each sphere's arithmetic as the
first kernel does and merges with the lowest table index on exact-t ties.
A mirror of that loop (tests/sphere_cull_mirror.py) must give
`sphere_table_plain`'s outputs bit for bit: on the camera and
first-bounce rays of the many-light scene (66 spheres) and of the
analytic stress scene (138 spheres) at 32x18, and on a crafted batch
(grazing rays, tangents on box faces, origins inside and on spheres,
exact-t ties across groups, radii from 1e-3 to 1e4), where the port also
equals interpret-mode K3b of the JAX package. The margin itself is held
by a hypothesis property: wherever the kernel's rounded arithmetic
accepts a pair with t, the sphere's one-sphere group is not skipped at
best = t.
"""

import numpy as np
import pytest
import torch

from sphere_cull_mirror import (
    KINDS, crafted_rays, crafted_spheres, mirrored_sphere_table, pair_values,
    sphere_cull_ray,
)
from sub_cull_mirror import box_maybe
from opencl_path_tracer_tpu_torch.core.spheres import SpheresSoA
from opencl_path_tracer_tpu_torch.core.types import Rays
from opencl_path_tracer_tpu_torch.ops import raygen, rng
from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
from opencl_path_tracer_tpu_torch.ops.kernels import sphere_kernel as k3
from opencl_path_tracer_tpu_torch.runtime.minarg_ab import _bounce
from opencl_path_tracer_tpu_torch.scene import library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

W, H = 32, 18
F32 = np.float32
_CACHE = {}


def scene(name):
    if name not in _CACHE:
        _CACHE[name] = (library.many_light_scene(64) if name == "many-lights"
                        else library.stress_scene(analytic=True))
    return _CACHE[name]


def rays8(name, bounce):
    """(8, R) float32: the Cornell camera's rays after `bounce` bounces."""
    if (name, bounce) not in _CACHE:
        sc = scene(name)
        cam = library.cornell_camera(W, H)
        s1, u1 = rng.lehmer_step(rng.seed_pixel_streams(W * H, 1))
        _, u2 = rng.lehmer_step(s1)
        rays = raygen.camera_rays(cam, raygen.pixel_ids(W, H, "cpu"), u1,
                                  u2)
        for _ in range(bounce):
            rays = _bounce(sc, cam, rays)
        _CACHE[name, bounce] = k1.pack_rays(rays.p, rays.d).contiguous()
    return _CACHE[name, bounce]


def bits_equal(a, b):
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


def crafted():
    c, r, m = crafted_spheres()
    table = k3.build_sphere_table(SpheresSoA.build(c, r, m))
    return c, r, table, crafted_rays(c, r, 25 * KINDS)


def test_groups_hold_every_live_sphere_once():
    table = k3.build_sphere_table(scene("many-lights").spheres)
    table[5, 7] = 0.0                      # a row that never hits
    g = k3.sphere_groups(table)
    gh = g.data.numpy()
    assert gh.shape == (9, k3.GROUP_F4, 4) and g.data.device == table.device
    idx = gh[:, 2 + k3.SPHERE_GROUP:].reshape(9, -1).view(np.int32)
    live = np.sort(idx[idx >= 0])
    assert np.array_equal(live, np.delete(np.arange(66), 5))
    mem = gh[:, 2:2 + k3.SPHERE_GROUP]
    tab = table.numpy()
    for gi in range(9):
        for k in range(k3.SPHERE_GROUP):
            s = idx[gi, k]
            if s < 0:
                assert mem[gi, k, 3] == np.inf
                continue
            assert np.array_equal(mem[gi, k], tab[s, [0, 1, 2, 5]])
            # The sphere the row describes (r_eff^2 = |c|^2 - ccdot, within
            # a few thousandths of rad) lies in its group's box, and A is
            # the margin's.
            cs = tab[s, 0:3].astype(np.float64)
            r_eff = np.sqrt(cs @ cs - float(tab[s, 5]))
            assert abs(r_eff - tab[s, 3]) < 1e-2
            assert (gh[gi, 0, 0:3] <= cs - r_eff).all()
            assert (gh[gi, 1, 0:3] >= cs + r_eff).all()
            a = k3.MARGIN * (np.linalg.norm(cs)
                             + np.sqrt(abs(float(tab[s, 5]))))
            assert gh[gi, 0, 3] >= a
    assert (gh[:, 1, 3] == F32(k3.MARGIN)).all() and g.n_rows == 66
    with pytest.raises(ValueError, match="of 66 spheres, not 65"):
        k3.sphere_table(rays8("many-lights", 0), table[:65].contiguous(), g)
    # A sphere outside the margin's ranges makes its group's box infinite.
    table[7, 5] = float("inf")
    gh = k3.sphere_groups(table).data.numpy()
    idx = gh[:, 2 + k3.SPHERE_GROUP:].reshape(9, -1).view(np.int32)
    gi = np.nonzero((idx == 7).any(1))[0][0]
    assert (gh[gi, 0] == [-np.inf, -np.inf, -np.inf, np.inf]).all()
    assert (gh[gi, 1, 0:3] == np.inf).all()


@pytest.mark.parametrize("bounce", [0, 1])
@pytest.mark.parametrize("name", ["many-lights", "stress-analytic"])
def test_mirrored_loop_equals_plain(name, bounce):
    table = k3.build_sphere_table(scene(name).spheres)
    groups = k3.sphere_groups(table)
    r8 = rays8(name, bounce)
    plain = k3.sphere_table_plain(r8, table)
    got, (made, passed, n_disc, n_sqrt, n_warp) = mirrored_sphere_table(
        r8.numpy(), table, groups)
    assert bits_equal(got, plain)
    r, s = r8.shape[1], table.shape[0]
    assert made == r * groups.data.shape[0]
    # The rule is not vacuous: boxes are skipped, and fewer pairs compute
    # disc than the first kernel's r * s, fewer still reach the sqrt.
    assert 0 < passed < made and n_sqrt < n_disc < r * s
    assert passed / 32 <= n_warp <= min(passed, made / 32)
    assert int((plain[0] > 0).sum()) > 10


def test_mirrored_loop_holds_on_the_crafted_batch():
    c, r, table, r8 = crafted()
    groups = k3.sphere_groups(table)
    assert groups.data.shape[0] == -(-c.shape[0] // k3.SPHERE_GROUP)
    got, counts = mirrored_sphere_table(r8, table, groups)
    plain = k3.sphere_table_plain(torch.from_numpy(r8), table)
    assert bits_equal(got, plain)
    # Copies 0-9 of the tied sphere span two groups; rays that hit it take
    # copy 0, the lowest index, whatever the group order.
    idx = groups.data.numpy()[:, 2 + k3.SPHERE_GROUP:].reshape(
        groups.data.shape[0], -1).view(np.int32)
    homes = {int(np.nonzero((idx == s).any(1))[0][0]) for s in range(10)}
    assert len(homes) > 1
    disc, t = pair_values(r8, table.numpy()[:10, [0, 1, 2, 5]])
    tie = (disc[0] > 0) & (t[0] > 0) & (plain[0].numpy() == t[0])
    assert tie.sum() > 5 and (plain[4].numpy()[tie] == 0).all()
    kind = np.arange(r8.shape[1]) % KINDS
    hit = plain[0].numpy() > 0
    for k in range(KINDS):
        assert hit[kind == k].any(), k
    assert (~hit[kind == 0]).any()         # grazing rays miss too


def test_crafted_batch_matches_interpret_mode():
    """The port's K3b (its plain version, equal to the mirror above) on
    the crafted batch against the JAX package's interpret-mode K3b:
    bit-equal."""
    import jax.numpy as jnp
    from opencl_path_tracer_tpu.core.spheres import SpheresSoA as JSph
    from opencl_path_tracer_tpu.core.types import Rays as JRays
    from opencl_path_tracer_tpu.ops.pallas.sphere_kernel import (
        make_sphere_table_intersect as jmake)
    c, r, m = crafted_spheres()
    _, _, table, r8 = crafted()
    jr = JRays(p=tuple(jnp.asarray(r8[k]) for k in range(3)),
               d=tuple(jnp.asarray(r8[3 + k]) for k in range(3)))
    pr = Rays(p=tuple(torch.from_numpy(r8[k].copy()) for k in range(3)),
              d=tuple(torch.from_numpy(r8[3 + k].copy()) for k in range(3)))
    jh = jmake(JSph.build(c, r, m), interpret=True)(jr)
    ph = k3.make_sphere_table_intersect(SpheresSoA.build(c, r, m))(pr)
    got, _ = mirrored_sphere_table(r8, table, k3.sphere_groups(table))
    assert torch.equal(ph.t, got[0])

    def b(x):
        return np.ascontiguousarray(np.asarray(x, F32)).view(np.int32)

    np.testing.assert_array_equal(b(ph.t.numpy()), b(jh.t))
    np.testing.assert_array_equal(ph.mati.numpy(), np.asarray(jh.mati))
    for k in range(3):
        np.testing.assert_array_equal(b(ph.n[k].numpy()), b(jh.n[k]))


def _margin_holds(c, rad, p, d):
    """Whether every pair the kernel's arithmetic accepts (disc > 0, t >
    0) enters its one-sphere group's box at best = t: c (3,), rad (), p,
    d (R, 3) float32."""
    sph = SpheresSoA.build(c[None], np.float32([rad]), np.int32([1]))
    table = k3.build_sphere_table(sph)
    box = np.concatenate(k3.sphere_groups(table).data.numpy()[0, 0:2])
    r8 = np.zeros((8, p.shape[0]), F32)
    r8[0:3], r8[3:6] = p.T, d.T
    disc, t = pair_values(r8, table.numpy()[:, [0, 1, 2, 5]])
    with np.errstate(invalid="ignore"):
        ok = (disc[0] > 0) & (t[0] > 0) & (t[0] < F32(k1.BIG))
    if not ok.any():
        return True, 0
    sel = r8[:, ok]
    go = box_maybe(sphere_cull_ray(sel), box[:, None], t[0][ok])
    return bool(go.all()), int(ok.sum())


def test_margin_property_hypothesis():
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies
    coord = st.floats(-1e4, 1e4, width=32)
    unit = st.floats(-1.0, 1.0, width=32)
    accepted = []

    @hypothesis.settings(max_examples=400, deadline=None, derandomize=True,
                         database=None)
    @hypothesis.given(c=st.tuples(coord, coord, coord),
                      log_r=st.floats(-3.0, 4.0), u=st.tuples(unit, unit,
                                                              unit),
                      w=st.tuples(unit, unit, unit),
                      h=st.floats(0.9, 1.1), back=st.floats(-3.0, 3.0),
                      ulps=st.integers(-8, 8))
    def margin(c, log_r, u, w, h, back, ulps):
        cen = np.float64(c)
        rad = F32(10.0 ** log_r)
        uu = np.float64(u)
        ww = np.cross(uu, np.float64(w))
        if np.linalg.norm(uu) < 1e-3 or np.linalg.norm(ww) < 1e-3:
            return
        uu /= np.linalg.norm(uu)
        ww /= np.linalg.norm(ww)
        # A ray tangent to (h = 1), through (h < 1) or past (h > 1) the
        # sphere, nudged by ulps, from up to 3 radii before or after the
        # tangent point, both ways.
        touch = cen + float(rad) * h * (1.0 + ulps * 2.0 ** -24) * uu
        p = np.stack([touch - back * float(rad) * ww,
                      touch + back * float(rad) * ww]).astype(F32)
        d = np.stack([ww, -ww]).astype(F32)
        d = (d / np.sqrt((d.astype(np.float64) ** 2).sum(1,
                                                         keepdims=True))
             ).astype(F32)
        holds, n = _margin_holds(np.float32(c), rad, p, d)
        assert holds
        accepted.append(n)

    margin()
    assert sum(accepted) > 50


def test_margin_on_seeded_extremes():
    """Origins inside, on and near spheres of radius 1e-3 to 1e4 far from
    the origin and near it, many directions each: every accepted pair
    enters its group's box at best = t."""
    rs = np.random.default_rng(3)
    n_ok = 0
    for rad in (1e-3, 0.05, 3.0, 250.0, 1e4):
        for cen in ((0.0, 0.0, 0.0), (900.0, -40.0, 300.0),
                    (-9000.0, 9000.0, 5000.0)):
            c = np.float32(cen)
            u = rs.normal(size=(400, 3))
            u /= np.linalg.norm(u, axis=1, keepdims=True)
            dist = np.concatenate([rs.uniform(0.0, 1.0, 200),
                                   1.0 + rs.normal(size=200) * 1e-6])
            p = (c + (rad * dist)[:, None] * u).astype(F32)
            d = rs.normal(size=(400, 3)).astype(F32)
            d = (d / np.sqrt((d.astype(np.float64) ** 2).sum(
                1, keepdims=True))).astype(F32)
            holds, n = _margin_holds(c, F32(rad), p, d)
            assert holds, (rad, cen)
            n_ok += n
    assert n_ok > 1000
