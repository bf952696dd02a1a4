"""Tests that need an NVIDIA GPU (the CUDA kernels have no CPU mode).
They carry the `cuda` marker and skip elsewhere; `python3 chip_smoke.py`
runs the same checks at full size on the card.

Run on a GPU machine with: python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu_torch.ops.kernels import _build
from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
from opencl_path_tracer_tpu_torch.ops.kernels import plucker_kernel as k2
from opencl_path_tracer_tpu_torch.ops.kernels import sphere_kernel as k3
from opencl_path_tracer_tpu_torch.scene import library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rays8(n, seed, device):
    rs = np.random.default_rng(seed)
    p = np.stack([rs.uniform(-100, 1100, n), rs.uniform(0, 1000, n),
                  rs.uniform(-1000, 1000, n)]).astype(np.float32)
    d = rs.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    r = torch.zeros((8, n))
    r[0:3], r[3:6] = torch.from_numpy(p), torch.from_numpy(d)
    return r.to(device)


@pytest.mark.cuda
def test_kernels_equal_plain_versions(cuda):
    scene = library.cornell_box(with_spheres=True, analytic_spheres=False,
                                device=cuda)
    sa = library.cornell_box(with_spheres=True, analytic_spheres=True,
                             device=cuda)
    rays8 = _rays8(100_003, 0, cuda)          # a ragged tail
    pack = k1.build_tri_pack(scene.tris)
    before = _build.launches["minarg"]
    t, g = k1.minarg(rays8, pack)
    assert _build.launches["minarg"] == before + 1
    tp, gp = k1.minarg_plain(rays8, pack)
    assert torch.equal(t, tp) and torch.equal(g, gp)
    for a, b in zip(k2.refine1(t, g, pack), k2.refine1_plain(t, g, pack)):
        assert torch.equal(a, b)
    table = k3.build_sphere_table(sa.spheres)
    for a, b in zip(k3.spheres(rays8, table), k3.spheres_plain(rays8, table)):
        assert torch.equal(a, b)
    # The CPU plain versions agree with the card bit for bit.
    tc, gc = k1.minarg(rays8[:, :5000].cpu(), pack.cpu())
    assert torch.equal(tc, t[:5000].cpu()) and torch.equal(gc, g[:5000].cpu())


@pytest.mark.cuda
def test_second_slice_kernels_equal_plain_versions(cuda):
    """One launch each of K4, K13a, K13b and K5 against its plain version
    on the card (chip_smoke.py runs them at 1080p)."""
    from opencl_path_tracer_tpu_torch.models import fused_step as fs
    from opencl_path_tracer_tpu_torch.models import pipeline
    from opencl_path_tracer_tpu_torch.ops import rng
    scene = library.cornell_box(with_spheres=True, device=cuda)
    cam = library.cornell_camera(128, 64, device=cuda)
    (F, I, ctr), step, _ = pipeline.make_fast_pipeline(
        scene, cam, width=128, height=64, iterations=3, key=rng.key(2))
    F, I, ctr = step(F, I, ctr)
    rays8 = F[3:11]
    pack = k1.build_tri_pack(scene.tris)
    trig, tric, _ = k2.build_plucker_packs(scene.tris)
    counts = dict(_build.launches)
    sl = rays8[:, 1024:3072]                  # a column slice, read in place
    assert torch.equal(torch.stack(k1.dense(sl, pack)),
                       torch.stack(k1.dense_plain(sl, pack)))
    h, hp = (torch.full((6, rays8.shape[1]), 7.0, device=cuda)
             for _ in range(2))
    k1.dense(sl, pack, out=h[:, 1024:3072])   # written in place
    k1.dense_plain(sl, pack, out=hp[:, 1024:3072])
    assert torch.equal(h, hp)
    cand = k2.candidates(rays8, trig, tric, live=scene.tris.count)
    assert torch.equal(cand, k2.candidates_plain(rays8, trig, tric))
    rows = k2.refine(rays8, cand, pack)
    assert torch.equal(rows, k2.refine_plain(rays8, cand, pack))
    hr = step.hit_rows(F, ctr)
    Fk, Ik = fs.fused_step(F, I, ctr, hr, step_table(scene, cam), rng.key(2), 3)
    Fp, Ip = fs.step_plain(F, I, ctr, hr, step_table(scene, cam), rng.key(2),
                           3)
    assert torch.equal(Ik, Ip)
    torch.testing.assert_close(Fk, Fp, rtol=1e-6, atol=1e-3, equal_nan=True)
    for name in ("dense", "plucker_cand", "plucker_refine", "fused_step"):
        assert _build.launches[name] > counts[name]


def step_table(scene, cam):
    from opencl_path_tracer_tpu_torch.models import fused_step as fs
    return fs.fused_table(cam, scene.mats, 128, 64)


@pytest.mark.cuda
def test_third_slice_kernels_equal_plain_versions(cuda):
    """One launch each of K7, K6 and K3b against its plain version on the
    card (chip_smoke.py runs them at 1080p): K7's flags equal (K4 t valid
    and t < rmax), K6's t equals K1's."""
    from opencl_path_tracer_tpu_torch.ops.kernels import tilecull_kernel as tk
    scene = library.cornell_box(with_spheres=True, device=cuda)
    rays8 = _rays8(50_001, 3, cuda)
    pack, groups, _ = tk.grouped_pack(scene.tris, 128,
                                     origin=(500.0, 500.0, -1299.0))
    counts = dict(_build.launches)
    sub = tk.anyhit_sub_boxes(pack, groups)
    t, g = tk.tilecull(rays8, pack, groups, sub)
    tp, gp = tk.tilecull_plain(rays8, pack, groups)
    assert torch.equal(t, tp) and torch.equal(g, gp)
    t1, _ = k1.minarg(rays8, k1.build_tri_pack(scene.tris))
    assert torch.equal(t, t1)
    rmax = torch.rand(rays8.shape[1], device=cuda,
                      generator=torch.Generator(cuda).manual_seed(0)) * 900.0
    occ = tk.anyhit(rays8, rmax, pack, groups, sub)
    assert torch.equal(occ, tk.anyhit_plain(rays8, rmax, pack, groups))
    assert torch.equal(occ, (t1 < k1.BIG) & (t1 < rmax))
    many = library.many_light_scene(64, device=cuda)
    table = k3.build_sphere_table(many.spheres)
    for a, b in zip(k3.sphere_table(rays8, table, k3.sphere_groups(table)),
                    k3.sphere_table_plain(rays8, table)):
        assert torch.equal(a, b)
    for name in ("tilecull", "anyhit", "sphere_table"):
        assert _build.launches[name] == counts[name] + 1


@pytest.mark.cuda
def test_no_fallback_when_the_loader_fails(cuda, monkeypatch):
    def broken(name):
        raise RuntimeError("kernel loader disabled by the test")

    monkeypatch.setattr(_build, "library", broken)
    scene = library.cornell_box(with_spheres=False, device=cuda)
    with pytest.raises(RuntimeError, match="disabled"):
        k1.minarg(_rays8(64, 1, cuda), k1.build_tri_pack(scene.tris))
    with pytest.raises(RuntimeError, match="disabled"):
        k1.dense(_rays8(64, 1, cuda), k1.build_tri_pack(scene.tris))
    from opencl_path_tracer_tpu_torch.ops.kernels import tilecull_kernel as tk
    pack, groups, _ = tk.grouped_pack(scene.tris, 128)
    sub = tk.anyhit_sub_boxes(pack, groups)
    with pytest.raises(RuntimeError, match="disabled"):
        tk.tilecull(_rays8(64, 1, cuda), pack, groups, sub)
    with pytest.raises(RuntimeError, match="disabled"):
        tk.anyhit(_rays8(64, 1, cuda), torch.ones(64, device=cuda), pack,
                  groups, sub)
    many = library.many_light_scene(64, device=cuda)
    table = k3.build_sphere_table(many.spheres)
    with pytest.raises(RuntimeError, match="disabled"):
        k3.sphere_table(_rays8(64, 1, cuda), table, k3.sphere_groups(table))


@pytest.mark.cuda
def test_fourth_slice_kernel_equals_plain_version(cuda, monkeypatch):
    """One launch of K8 against its plain version on the card, on the
    smooth reference scene (chip_smoke.py runs it at 1080p), and the CPU
    plain version agrees with the card bit for bit; with the loader
    broken, K8 raises."""
    import pathlib
    from opencl_path_tracer_tpu_torch.ops.kernels import shading_kernel as k8
    models = pathlib.Path(__file__).resolve().parent / "assets" / "models"
    scene = library.reference_scene(str(models), smooth=True, device=cuda)
    rays8 = _rays8(60_001, 4, cuda)
    rays8[0:3] -= torch.tensor([[600.0], [0.0], [300.0]], device=cuda)
    pack = k1.build_tri_pack(scene.tris)
    spack = k8.build_shading_pack(scene.attribs)
    t, g = k1.minarg(rays8, pack)
    before = _build.launches["smooth_refine"]
    out = k8.smooth_refine(rays8, t, g, pack, spack)
    assert _build.launches["smooth_refine"] == before + 1
    plain = k8.smooth_refine_plain(rays8, t, g, pack, spack)
    assert all(torch.equal(a, b) for a, b in zip(out, plain))
    assert bool((out[0] > 0).any()) and bool((out[0] < 0).any())
    cpu = k8.smooth_refine(rays8[:, :5000].cpu(), t[:5000].cpu(),
                           g[:5000].cpu(), pack.cpu(), spack.cpu())
    assert all(torch.equal(a, b[:5000].cpu()) for a, b in zip(cpu, out))

    def broken(name):
        raise RuntimeError("kernel loader disabled by the test")

    monkeypatch.setattr(_build, "library", broken)
    with pytest.raises(RuntimeError, match="disabled"):
        k8.smooth_refine(rays8, t, g, pack, spack)


@pytest.mark.cuda
def test_fifth_slice_kernels_equal_plain_versions(cuda, monkeypatch):
    """K9, K10 and K11 against their plain versions on the card, on
    stress_scene(6000) (chip_smoke.py runs them on the 99,380-triangle
    scene at 1080p); the pair intersector's hits equal K4's; the CPU plain
    versions agree with the card; with the loader broken, each raises."""
    from opencl_path_tracer_tpu_torch.core.types import Rays
    from opencl_path_tracer_tpu_torch.ops.kernels import pair_mxu as pm
    from opencl_path_tracer_tpu_torch.ops.kernels import sorted_intersect as si
    from opencl_path_tracer_tpu_torch.ops.kernels.march_kernel import (
        build_march_scene,
    )
    scene = library.stress_scene(6000, device=cuda)
    _, rest = si.split_by_size(scene.tris)
    ms, rt, c = build_march_scene(rest, 256)
    boxes = torch.cat([ms.boxes_lo, ms.boxes_hi,
                       torch.zeros((c, 2), device=cuda),
                       pm.build_dops(rt, 256, c)], 1)
    boxes_r = torch.zeros((128, 16), device=cuda)
    boxes_r[:c] = boxes
    rays8 = _rays8(20_003, 5, cuda)
    before = dict(_build.launches)
    for l in (2, 6, 48):
        out = si.run_candidates(rays8, boxes_r, l, c)
        assert all(torch.equal(a, b) for a, b in
                   zip(out, si.candidates_plain(rays8, boxes_r, l, c)))
    ids = si.run_candidates(rays8, boxes_r, 2, c)[0]
    keys_s, r8p, _ = pm.sort_pairs([rays8[k] for k in range(6)], ids, c,
                                   1024)
    t, gp = pm.pair_visits(keys_s, r8p, ms.trig, ms.tric, 256, 1024, c)
    tp, gpp = pm.pair_visits_plain(keys_s, r8p, ms.trig, ms.tric, 256, 1024,
                                   c)
    assert torch.equal(t, tp) and torch.equal(gp, gpp)
    g = torch.where(t < k1.BIG, gp // 2, torch.full_like(t, -1.0))
    for a, b in zip(pm.fetch_attrs(g, ms.tric),
                    pm.fetch_attrs_plain(g, ms.tric)):
        assert torch.equal(a, b)
    assert {k: _build.launches[k] - before[k]
            for k in ("pair_cand", "pair_visit", "attr_fetch")} == {
                "pair_cand": 4, "pair_visit": 1, "attr_fetch": 1}
    assert int((t < k1.BIG).sum()) > 0
    head = rays8[:, :3000].contiguous()
    cpu = si.run_candidates(head.cpu(), boxes_r.cpu(), 6, c)
    gpu = si.run_candidates(head, boxes_r, 6, c)
    assert all(torch.equal(a, b.cpu()) for a, b in zip(cpu, gpu))
    isect = si.make_pair_intersect(scene.tris, **si.PAIR_TPU_WINNER)
    rays = Rays(p=tuple(rays8[k].contiguous() for k in range(3)),
                d=tuple(rays8[k].contiguous() for k in range(3, 6)))
    h = isect(rays)
    td = k1.dense(rays8, k1.build_tri_pack(scene.tris))[0]
    assert torch.equal(h.t, torch.where(td < k1.BIG, td, -1.0))

    def broken(name):
        raise RuntimeError("kernel loader disabled by the test")

    monkeypatch.setattr(_build, "library", broken)
    with pytest.raises(RuntimeError, match="disabled"):
        si.run_candidates(rays8, boxes_r, 2, c)
    with pytest.raises(RuntimeError, match="disabled"):
        pm.pair_visits(keys_s, r8p, ms.trig, ms.tric, 256, 1024, c)
    with pytest.raises(RuntimeError, match="disabled"):
        pm.fetch_attrs(g, ms.tric)


@pytest.mark.cuda
def test_sixth_slice_kernels_equal_plain_versions(cuda, monkeypatch):
    """K12, K16 and K17 against their plain versions on the card
    (chip_smoke.py runs them at 1080p): K12 on a pairs round of
    stress_scene(6000) with clusters of 512, K17 on the stress scene with
    clusters of 128 (early exit off and on), K16 on the Cornell box; the
    three intersectors' hits equal K4's; the CPU plain versions agree
    with the card; with the loader broken, each raises."""
    from opencl_path_tracer_tpu_torch.core.types import Rays
    from opencl_path_tracer_tpu_torch.ops.kernels import cluster_kernel as ck
    from opencl_path_tracer_tpu_torch.ops.kernels import pair_mxu as pm
    from opencl_path_tracer_tpu_torch.ops.kernels import sorted_intersect as si
    stress = library.stress_scene(6000, device=cuda)
    cornell = library.cornell_box(with_spheres=True, device=cuda)
    rays8 = _rays8(20_003, 6, cuda)
    before = dict(_build.launches)
    # K12.
    _, rest = si.split_by_size(stress.tris)
    cs, c, k = ck.build_clusters(rest, 512)
    rows = torch.cat([cs.rows(), torch.zeros((k, 24), device=cuda)])
    boxes_r = torch.zeros((128, 8), device=cuda)
    boxes_r[:c] = cs.boxes
    ids = si.run_candidates(rays8, boxes_r, 4, c)[0]
    keys_s, r8p, _ = pm.sort_pairs([rays8[j] for j in range(6)], ids, c,
                                   1024)
    sub = si.pair_sub_boxes(rows, k)
    out = si.run_pairs(keys_s, r8p, rows, k, sub)
    assert all(torch.equal(a, b) for a, b in
               zip(out, si.pairs_plain(keys_s, r8p, rows, k)))
    assert int((out[0] < k1.BIG).sum()) > 0
    cpu = si.run_pairs(keys_s[:4096].cpu(), r8p[:, :4096].cpu().contiguous(),
                       rows.cpu(), k)
    assert all(torch.equal(a, b[:4096].cpu()) for a, b in zip(cpu, out))
    # K17.
    cs17, c17, k17 = ck.build_clusters(stress.tris, 128)
    r8 = ck.pack_rays_rows([rays8[j] for j in range(3)],
                           [rays8[j] for j in range(3, 6)], 20_224)
    ids17, cnt, ent = ck._tile_cluster_lists(r8, cs17.boxes, 256)
    sub17 = ck.cluster_sub_boxes(cs17.rows(), k17)
    for ee in (False, True):
        out17 = ck.run_cluster(r8, cnt, ids17, ent, cs17.rows(), k17, 256, ee,
                               sub17)
        assert all(torch.equal(a, b) for a, b in zip(out17, ck.cluster_plain(
            r8, cnt, ids17, ent, cs17.rows(), k17, 256, ee)))
    # K16.
    cs16, c16, k16 = ck.build_clusters(cornell.tris, 128, split_large=True)
    union = torch.randint(0, 1 << c16, (10,), dtype=torch.int32,
                          device=cuda)
    r16 = ck.pack_rays_rows([rays8[j] for j in range(3)],
                            [rays8[j] for j in range(3, 6)], 20_480)
    sub16 = ck.cluster_sub_boxes(cs16.rows(), k16)
    out16 = si.run_group(union, r16, cs16.rows(), k16, 2048, sub16)
    assert all(torch.equal(a, b) for a, b in zip(out16, si.group_plain(
        union, r16, cs16.rows(), k16, 2048)))
    assert {n: _build.launches[n] - before[n]
            for n in ("pair_vpu", "cluster", "group")} == {
                "pair_vpu": 1, "cluster": 2, "group": 1}
    # The three intersectors against K4: hit or miss equal, t within the
    # JAX tests' rtol 2e-5 (tests/test_sorted_intersect.py::_check).
    rays = Rays(p=tuple(rays8[j].contiguous() for j in range(3)),
                d=tuple(rays8[j].contiguous() for j in range(3, 6)))
    for scene, fn in ((stress, si.make_pair_intersect),
                      (stress, ck.make_cluster_intersect),
                      (cornell, si.make_group_intersect)):
        h = fn(scene.tris)(rays)
        td = k1.dense(rays8, k1.build_tri_pack(scene.tris))[0]
        hit = td < k1.BIG
        assert torch.equal(h.t > 0, hit)
        torch.testing.assert_close(h.t[hit], td[hit], rtol=2e-5, atol=1e-3)

    def broken(name):
        raise RuntimeError("kernel loader disabled by the test")

    monkeypatch.setattr(_build, "library", broken)
    with pytest.raises(RuntimeError, match="disabled"):
        si.run_pairs(keys_s, r8p, rows, k, sub)
    with pytest.raises(RuntimeError, match="disabled"):
        ck.run_cluster(r8, cnt, ids17, ent, cs17.rows(), k17, 256, False,
                       sub17)
    with pytest.raises(RuntimeError, match="disabled"):
        si.run_group(union, r16, cs16.rows(), k16, 2048, sub16)


@pytest.mark.cuda
def test_seventh_slice_kernels_equal_plain_versions(cuda, monkeypatch):
    """K18 (with its K18m copy), K19 and K20 against their plain versions
    on the card, on stress_scene(6000) with clusters of 256 (chip_smoke.py
    runs them on the 99,380-triangle scene at 1080p); the 'march' and
    'flat' hits equal K4's over the reordered triangles; the CPU plain
    versions agree with the card; with the loader broken, each raises."""
    from opencl_path_tracer_tpu_torch.core.types import Rays
    from opencl_path_tracer_tpu_torch.ops.kernels import flat_march as fm
    from opencl_path_tracer_tpu_torch.ops.kernels import lazy_march as lm
    from opencl_path_tracer_tpu_torch.ops.kernels import march_kernel as mk
    from opencl_path_tracer_tpu_torch.ops.kernels.plucker_kernel import (
        plucker_feat,
    )
    scene = library.stress_scene(6000, device=cuda)
    cs, tr, K = 256, 256, 6
    ms, rt, c = mk.build_march_scene(scene.tris, cs)
    n = 20_224   # 79 blocks of 256
    r8 = _rays8(n, 7, cuda)
    order = torch.sort(mk.lane_key(r8[0:3], r8[3:6], ms), stable=True).indices
    r8s = r8[:, order].contiguous()
    feat = plucker_feat(r8s)
    ent, need = mk._slab_entries(r8s, ms, torch.full((n,), k1.BIG,
                                                     device=cuda))
    clist = mk._block_lists(ent, need, tr, K)
    before = dict(_build.launches)
    copies = mk.materialize(clist, r8s, feat)
    for a, b in zip(copies, mk.materialize_plain(clist, r8s, feat)):
        assert torch.equal(a, b)
    out = mk.run_march(clist, r8s, feat, ms, cs, K, tr)
    plain = mk.march_plain(clist, r8s, feat, ms, cs, K, tr)
    assert torch.equal(out, plain)
    assert int((out[0] < k1.BIG).sum()) > 0
    cpu = mk.run_march(clist[:4 * K].cpu(), r8s[:, :4 * tr].cpu(),
                       feat[:, :4 * tr].cpu(), mk.MarchScene(
                           *(x.cpu() for x in (ms.trig, ms.tric, ms.boxes_lo,
                                               ms.boxes_hi, ms.scene_lo,
                                               ms.scene_inv))), cs, K, tr)
    assert torch.equal(cpu, out[:, :4 * tr].cpu())
    # K19 on a list that leaves every fifth block out.
    bu = mk._need(ent, out[0]).view(c, -1, tr).any(dim=2)
    bu[:, ::5] = False
    vb, vc, _, _ = fm._build_visit_list(bu, 4096)
    keep = (vb % 5 != 0) | (vc >= 0)
    vb, vc = vb[keep].contiguous(), vc[keep].contiguous()
    o19 = fm.run_flat(vb, vc, r8s, feat, out, ms, cs, tr)
    assert torch.equal(o19, fm.flat_plain(vb, vc, r8s, feat, out, ms, cs,
                                          tr))
    # K20 from carried rows and a mask with some bits set.
    vis = torch.zeros((-(-c // 32), n), dtype=torch.int32, device=cuda)
    vis[0, ::3] = 5
    o20, v20 = lm.run_lazy_march(clist, r8s, feat, out[:6].contiguous(), vis,
                                 ms, cs, K, tr)
    p20, pv20 = lm.lazy_plain(clist, r8s, feat, out[:6].contiguous(), vis,
                              ms, cs, K, tr)
    assert torch.equal(o20, p20) and torch.equal(v20, pv20)
    assert bool((v20 != vis).any())
    assert {k: _build.launches[k] - before[k]
            for k in ("materialize", "march", "flat_march",
                      "lazy_march")} == {"materialize": 1, "march": 1,
                                         "flat_march": 1, "lazy_march": 1}
    pack = k1.build_tri_pack(rt)
    rays = Rays(p=tuple(r8[k].contiguous() for k in range(3)),
                d=tuple(r8[k].contiguous() for k in range(3, 6)))
    td = k1.dense(r8, pack)[0]
    for isect, _ in (mk.make_march_intersect(scene.tris, cs=cs, tr=tr, K1=3,
                                             K2=6, tail=2048),
                     fm.make_flat_march_intersect(scene.tris, cs=cs, tr=tr,
                                                  K0=2, tail=2048)):
        assert torch.equal(isect(rays).t, torch.where(td < k1.BIG, td, -1.0))

    def broken(name):
        raise RuntimeError("kernel loader disabled by the test")

    monkeypatch.setattr(_build, "library", broken)
    with pytest.raises(RuntimeError, match="disabled"):
        mk.run_march(clist, r8s, feat, ms, cs, K, tr)
    with pytest.raises(RuntimeError, match="disabled"):
        mk.materialize(clist, r8s, feat)
    with pytest.raises(RuntimeError, match="disabled"):
        fm.run_flat(vb, vc, r8s, feat, out, ms, cs, tr)
    with pytest.raises(RuntimeError, match="disabled"):
        lm.run_lazy_march(clist, r8s, feat, out[:6].contiguous(), vis, ms,
                          cs, K, tr)


@pytest.mark.cuda
def test_eighth_slice_kernels_equal_plain_versions(cuda, monkeypatch):
    """K14 against its plain version and against K1 + K2 on the card, K15
    against its plain version on all six outputs, on the Cornell box and
    a ragged ray tail (chip_smoke.py runs them at 1080p); the intersectors
    launch K14 and K15 and not K1, K2 or K4; the CPU plain versions agree
    with the card; with the loader broken, each raises."""
    from opencl_path_tracer_tpu_torch.core.types import Rays
    from opencl_path_tracer_tpu_torch.ops.kernels import cluster_kernel as ck
    scene = library.cornell_box(with_spheres=True, device=cuda)
    rays8 = _rays8(50_001, 8, cuda)
    pack = k1.build_tri_pack(scene.tris)
    sub = ck.sub_boxes(pack, [(0, pack.shape[0])])
    before = dict(_build.launches)
    f = k2.minarg_fused(rays8, pack, sub)
    for a, b, c in zip(f, k2.minarg_fused_plain(rays8, pack),
                       k2.refine1(*k1.minarg(rays8, pack), pack)):
        assert torch.equal(a, b) and torch.equal(a, c)
    o = k1.mxu(rays8, pack, sub)
    for a, b in zip(o, k1.mxu_plain(rays8, pack)):
        assert torch.equal(a, b)
    assert int((o[0] < k1.BIG).sum()) > 0
    assert {k: _build.launches[k] - before[k]
            for k in ("minarg_fused", "mxu")} == {"minarg_fused": 1, "mxu": 1}
    fc = k2.minarg_fused(rays8[:, :3000].cpu(), pack.cpu())
    oc = k1.mxu(rays8[:, :3000].cpu(), pack.cpu())
    assert all(torch.equal(a, b[:3000].cpu()) for a, b in zip(fc, f))
    assert all(torch.equal(a, b[:3000].cpu()) for a, b in zip(oc, o))
    rays = Rays(p=tuple(rays8[k].contiguous() for k in range(3)),
                d=tuple(rays8[k].contiguous() for k in range(3, 6)))
    _build.reset_launches()
    k2.make_minarg_intersect(scene.tris, fuse_fetch=True)(rays)
    k1.make_mxu_intersect(scene.tris)(rays)
    launched = {k for k, v in _build.launches.items() if v}
    assert launched == {"minarg_fused", "mxu"}

    def broken(name):
        raise RuntimeError("kernel loader disabled by the test")

    monkeypatch.setattr(_build, "library", broken)
    with pytest.raises(RuntimeError, match="disabled"):
        k2.minarg_fused(rays8, pack, sub)
    with pytest.raises(RuntimeError, match="disabled"):
        k1.mxu(rays8, pack, sub)


@pytest.mark.cuda
def test_ninth_slice_kernels_equal_plain_versions(cuda, monkeypatch):
    """K4 split across triangle chunks and the vectorised K18m against
    their plain versions on the card (chip_smoke.py runs both at the main
    paths' shapes). K4 at 300 lanes against a pack whose second half
    repeats its first (exact-t ties across chunks), with rays that miss
    everything, in both layouts, read from and written into column
    slices; K18m on an odd L and on views at storage offsets of 4, 12 and
    2 bytes; the CPU plain versions agree with the card; with the loader
    broken, each raises."""
    from opencl_path_tracer_tpu_torch.ops.kernels import march_kernel as mk
    half = k1.build_tri_pack(library.stress_scene(10_000, device=cuda).tris)
    pack = torch.cat([half, half])
    n = 300
    splits, chunk = k1.dense_splits(
        n, pack.shape[0],
        torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert splits > 1 and chunk < half.shape[0]
    rays8 = _rays8(n, 9, cuda)
    rays8[0:3, -12:] = 1e5                 # far outside, pointing away
    rays8[3:6, -12:] = 3 ** -0.5
    rays8[3:6, -2:] = 0.0                  # zero rays, as padding
    wide = torch.zeros((8, n + 40), device=cuda)
    wide[:, 16:16 + n] = rays8
    before = _build.launches["dense"]
    got = k1.dense(wide[:, 16:16 + n], pack)
    want = k1.dense_plain(rays8, pack)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    hit = want[0] < k1.BIG
    assert hit[:-12].all() and not hit[-12:].any()
    assert (want[1][hit] < half.shape[0]).all()     # ties keep the first
    assert (want[1][~hit] == 0).all()
    hk = torch.full((6, n + 50), 7.0, device=cuda)
    hp = hk.clone()
    k1.dense(wide[:, 16:16 + n], pack, out=hk[:, 30:30 + n])
    k1.dense_plain(rays8, pack, out=hp[:, 30:30 + n])
    assert torch.equal(hk, hp)
    assert _build.launches["dense"] - before == 2
    cpu = k1.dense(rays8.cpu(), pack.cpu())
    assert all(torch.equal(a, b.cpu()) for a, b in zip(cpu, got))
    # K18m: several blocks per buffer, an odd L, storage offsets.
    m, L = 20_001, 1_001
    lbuf = torch.arange(L + 1, dtype=torch.int32, device=cuda)
    rbuf = torch.randn(8 * m + 3, device=cuda)
    fbuf = torch.randn(32 * m + 1, device=cuda).to(torch.bfloat16)
    views = (lbuf[1:], rbuf[3:].view(8, m), fbuf[1:].view(32, m))
    before = _build.launches["materialize"]
    for args in (views, tuple(x.clone() for x in views)):
        out = mk.materialize(*args)
        for a, b in zip(out, mk.materialize_plain(*args)):
            assert torch.equal(a, b)
    assert _build.launches["materialize"] - before == 2

    def broken(name):
        raise RuntimeError("kernel loader disabled by the test")

    monkeypatch.setattr(_build, "library", broken)
    with pytest.raises(RuntimeError, match="disabled"):
        k1.dense(rays8, pack)
    with pytest.raises(RuntimeError, match="disabled"):
        mk.materialize(*views)


def _crafted_boxes(c=40, seed=10):
    """(Cp = 128, 16) cluster table: boxes and their 14-DOP intervals,
    rows 20-29 repeating rows 0-9 (equal entries across clusters), rows
    30-34 flat along x."""
    from opencl_path_tracer_tpu_torch.ops.kernels.pair_mxu import DOP_SIGNS
    rs = np.random.default_rng(seed)
    lo = rs.uniform(-50, 50, (c, 3)).astype(np.float32)
    hi = (lo + rs.uniform(1, 20, (c, 3))).astype(np.float32)
    lo[20:30], hi[20:30] = lo[0:10], hi[0:10]
    hi[30:35, 0] = lo[30:35, 0]
    corners = np.stack([np.where(np.array([(m >> k) & 1 for k in range(3)],
                                          bool), hi, lo)
                        for m in range(8)], 1).astype(np.float64)
    table = np.zeros((128, 16), np.float32)
    table[:c, 0:3], table[:c, 3:6] = lo, hi
    for j, s in enumerate(DOP_SIGNS):
        pv = corners @ np.asarray(s)
        table[:c, 8 + j], table[:c, 12 + j] = pv.min(1), pv.max(1)
    return table, lo, hi


def _crafted_rays(lo, hi, seed=11):
    """(8, R) rays against _crafted_boxes: random ones; origins exactly on
    box faces; directions with +0 and -0 components, subnormal ones
    (whose reciprocal overflows: 0 * inf = NaN on a face), and ones
    whose DOP projection is 0; origins inside boxes and on their
    corners (entries of +-0)."""
    rs = np.random.default_rng(seed)
    n = 4096
    p = rs.uniform(-60, 60, (n, 3))
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    k = rs.integers(0, lo.shape[0], n)
    ax = rs.integers(0, 3, n)
    inside = lo[k] + rs.uniform(0, 1, (n, 3)) * (hi[k] - lo[k])
    sel = np.arange(n) % 8
    # 1: origin on a face of box k; 2: inside box k; 3: on its lo corner.
    p[sel == 1] = inside[sel == 1]
    face = sel == 1
    p[face, ax[face]] = lo[k[face], ax[face]]
    p[sel == 2] = inside[sel == 2]
    p[sel == 3] = lo[k[sel == 3]]
    # 4: a zero component (+0 or -0); 5: a subnormal one; 6: on a face
    # with a subnormal component along that axis; 7: dx = dy (DOP 0).
    for s, v in ((4, 0.0), (5, 1e-40), (6, 1e-40)):
        m = sel == s
        d[m, ax[m]] = v * rs.choice([-1.0, 1.0], int(m.sum()))
    m = sel == 6
    p[m] = inside[m]
    p[m, ax[m]] = lo[k[m], ax[m]]
    m = sel == 7
    d[m, 1] = d[m, 0]
    r8 = np.zeros((8, n), np.float32)
    r8[0:3], r8[3:6] = p.T, d.T
    r8[3:6][np.abs(r8[3:6]) == 0] = np.copysign(
        0.0, rs.choice([-1.0, 1.0], int((np.abs(r8[3:6]) == 0).sum())))
    return r8


@pytest.mark.cuda
def test_tenth_slice_candidates_on_crafted_rays(cuda, monkeypatch):
    """K9 as redesigned (per-ray reciprocals, NaN-propagating min and max,
    the top list in registers for capacities 3, 9 and 17, in local memory
    for 49) against its plain version on rays crafted for its edge cases:
    d = +-0, subnormal d whose reciprocal overflows, origins exactly on
    box faces (0 * inf = NaN), entries of +-0, equal entries across
    clusters; every l the paths use and one per capacity boundary, on the
    8- and 16-column tables; the CPU plain version agrees."""
    from opencl_path_tracer_tpu_torch.ops.kernels import sorted_intersect as si
    table, lo, hi = _crafted_boxes()
    r8 = torch.as_tensor(_crafted_rays(lo, hi)).to(cuda)
    assert bool((r8[3:6] == 0).any()) and bool(
        ((r8[3:6].abs() > 0) & (r8[3:6].abs() < 1e-38)).any())
    c = 40
    for boxw in (8, 16):
        boxes = torch.as_tensor(table[:, :boxw].copy()).to(cuda)
        for l in (2, 3, 6, 8, 9, 14, 16, 17, 30, 48):
            before = _build.launches["pair_cand"]
            out = si.run_candidates(r8, boxes, l, c)
            plain = si.candidates_plain(r8, boxes, l, c)
            assert _build.launches["pair_cand"] - before == 1
            for a, b in zip(out, plain):
                assert torch.equal(a, b), (boxw, l)
            ent = out[1]
            assert bool((ent == 0).any()) and bool((ent < k1.BIG).any())
        cpu = si.run_candidates(r8.cpu(), boxes.cpu(), 6, c)
        gpu = si.run_candidates(r8, boxes, 6, c)
        assert all(torch.equal(a, b.cpu()) for a, b in zip(cpu, gpu))
    # Ties: clusters 0-9 and 20-29 hold the same boxes, so a ray whose
    # nearest is one of them has an equal entry at rank 1, lower id first.
    ids, ent, _ = si.run_candidates(
        r8, torch.as_tensor(table).to(cuda), 2, c)
    tie = (ent[0] == ent[1]) & (ent[0] < k1.BIG)
    assert bool(tie.any()) and bool((ids[0][tie] < ids[1][tie]).all())


@pytest.mark.cuda
def test_tenth_slice_march_on_grazing_lanes(cuda):
    """K18 on the tensor cores against its plain version and against its
    first (float32-core) kernel on lanes of stress_scene(1200) aimed at
    triangle vertices, along triangle edges and nearly in a triangle's
    plane, with clusters and blocks of 128; the counting entry's rows are
    the same and at least one edge test takes the float32 chain."""
    from march_lanes import aimed_rays, grazing_rays

    from opencl_path_tracer_tpu_torch.ops.kernels import march_kernel as mk
    from opencl_path_tracer_tpu_torch.ops.kernels.plucker_kernel import (
        plucker_feat,
    )
    scene = library.stress_scene(1200, device=cuda)
    cs, tr, K = 128, 128, 6
    ms, _, c = mk.build_march_scene(scene.tris, cs)
    r8n = np.concatenate([grazing_rays(scene.tris, 6144, 3),
                          aimed_rays(2048, 4, scene.tris)], 1)
    r8 = torch.as_tensor(r8n).to(cuda)
    n = r8.shape[1]
    order = torch.sort(mk.lane_key(r8[0:3], r8[3:6], ms), stable=True).indices
    r8s = r8[:, order].contiguous()
    feat = plucker_feat(r8s)
    ent, need = mk._slab_entries(r8s, ms, torch.full((n,), k1.BIG,
                                                     device=cuda))
    clist = mk._block_lists(ent, need, tr, K)
    before = dict(_build.launches)
    out = mk.run_march(clist, r8s, feat, ms, cs, K, tr)
    assert torch.equal(out, mk.march_plain(clist, r8s, feat, ms, cs, K, tr))
    assert torch.equal(out, mk.run_march_simt(clist, r8s, feat, ms, cs, K,
                                              tr))
    counted, exact = mk.run_march_counted(clist, r8s, feat, ms, cs, K, tr)
    assert torch.equal(counted, out) and exact > 0
    assert int((out[0] < k1.BIG).sum()) > 0
    assert {k: _build.launches[k] - before[k]
            for k in ("march", "march_simt", "march_count")} == {
                "march": 1, "march_simt": 1, "march_count": 1}
    cpu = mk.run_march(clist[:4 * K].cpu(), r8s[:, :4 * tr].cpu(),
                       feat[:, :4 * tr].cpu(), mk.MarchScene(
                           *(x.cpu() for x in (ms.trig, ms.tric, ms.boxes_lo,
                                               ms.boxes_hi, ms.scene_lo,
                                               ms.scene_inv))), cs, K, tr)
    assert torch.equal(cpu, out[:, :4 * tr].cpu())


@pytest.mark.cuda
def test_eleventh_slice_plucker_cand_equals_first_kernel(cuda, monkeypatch):
    """K13a on the tensor cores against its first (float32-core) kernel
    and its plain version on a ragged tail (R = 100,003 random lanes,
    read from a column slice of a wider pack) and tests/minarg_rays.py's
    adversarial batch (zero directions accept t = inf, which moves a
    chunk's fill), with the scan stopped at the live triangle count and
    not; on a pack with whole chunks of padding rows (1,104 triangles in
    2,048 rows); the counting entry's rows equal and at least one edge
    test takes the chain; only the launched entries count; with the
    loader broken, each raises."""
    import dataclasses

    from minarg_rays import adversarial_rays
    scene = library.cornell_box(with_spheres=True, device=cuda)
    tris = scene.tris
    more = type(tris)(**{f.name: torch.cat([getattr(tris, f.name),
                                            getattr(tris, f.name)[:300]])
                         for f in dataclasses.fields(tris)})
    n = 100_003
    wide = torch.zeros((8, n + 64), device=cuda)
    wide[:, 32:32 + n] = _rays8(n, 13, cuda)
    for t in (tris, more):
        trig, tric, tpad = k2.build_plucker_packs(t)
        adv = torch.as_tensor(adversarial_rays(t, 20_000, 14)).to(cuda)
        for rays8 in (wide[:, 32:32 + n], adv):
            plain = k2.candidates_plain(rays8, trig, tric)
            first = k2.run_candidates_simt(rays8, trig, tric)
            before = dict(_build.launches)
            for live in (t.count, tpad):
                assert torch.equal(k2.candidates(rays8, trig, tric,
                                                 live=live), plain)
            assert torch.equal(first, plain)
            counted, chain = k2.candidates_counted(rays8, trig, tric,
                                                   live=t.count)
            assert torch.equal(counted, plain)
            assert {k: _build.launches[k] - before[k] for k in (
                "plucker_cand", "plucker_cand_simt", "plucker_cand_count")} \
                == {"plucker_cand": 2, "plucker_cand_simt": 0,
                    "plucker_cand_count": 1}
        assert int((plain[0] < k1.BIG).sum()) > 0
    assert tpad - more.count > 3 * 256
    # Grazing lanes put some edge tests in the margin.
    from march_lanes import grazing_rays
    g8 = torch.as_tensor(grazing_rays(tris, 4096, 15)).to(cuda)
    trig, tric, _ = k2.build_plucker_packs(tris)
    out, chain = k2.candidates_counted(g8, trig, tric, live=tris.count)
    assert torch.equal(out, k2.candidates_plain(g8, trig, tric))
    assert chain > 0

    def broken(name):
        raise RuntimeError("kernel loader disabled by the test")

    monkeypatch.setattr(_build, "library", broken)
    for fn in (lambda: k2.candidates(g8, trig, tric, live=tris.count),
               lambda: k2.run_candidates_simt(g8, trig, tric),
               lambda: k2.candidates_counted(g8, trig, tric,
                                             live=tris.count)):
        with pytest.raises(RuntimeError, match="disabled"):
            fn()


@pytest.mark.cuda
def test_eleventh_slice_plucker_cand_padding_after_t_above_big(cuda):
    """K13a where the live count ends a chunk and whole chunks of
    padding follow (1,280 and 1,792 triangles in 2,048 rows), on lanes
    that accept t above BIG on every live row (tests/minarg_rays.py's
    planes and lanes): the first padding chunk's fill, which the scan
    merges after it stops, wins as in the plain version; equal to the
    first kernel and the plain version."""
    from minarg_rays import adversarial_rays, planes, t_above_big_rays
    for count in (1280, 1792):
        tris = planes(count).to(cuda)
        trig, tric, _ = k2.build_plucker_packs(tris)
        rays8 = torch.cat([t_above_big_rays(4096), torch.as_tensor(
            adversarial_rays(tris, 4096, 18))], 1).to(cuda)
        out = k2.candidates(rays8, trig, tric, live=count)
        plain = k2.candidates_plain(rays8, trig, tric)
        assert torch.equal(out, plain)
        assert torch.equal(out, k2.run_candidates_simt(rays8, trig, tric))
        assert bool((out[1, :4096] == count).all())


@pytest.mark.cuda
def test_eleventh_slice_minarg_equals_first_kernel(cuda, monkeypatch):
    """K1 culled before the divide against its first kernel and its plain
    version on a ragged tail (R = 100,003 random rays) and
    tests/minarg_rays.py's adversarial batch (zero, NaN and infinite
    directions, origins on a plane, rays parallel to one, subnormal
    components), on the Cornell box and on a pack whose rows repeat
    (exact t ties), and on 1080p camera rays (coherent warps, which keep
    the cull; the random and adversarial rays' warps take the joint
    loop); the counting entry's outputs equal and its counts in range;
    with the loader broken, each raises."""
    from minarg_rays import adversarial_rays, tie_pack
    from opencl_path_tracer_tpu_torch.ops import raygen, rng
    scene = library.cornell_box(with_spheres=True, device=cuda)
    pack = k1.build_tri_pack(scene.tris)
    cam = library.cornell_camera(1920, 1080, device=cuda)
    ids = raygen.pixel_ids(1920, 1080, cuda)[:100_003]
    s1, r1 = rng.lehmer_step(rng.seed_pixel_streams(ids.numel(), 1,
                                                    device=cuda))
    _, r2 = rng.lehmer_step(s1)
    crays = raygen.camera_rays(cam, ids, r1, r2)
    cases = [_rays8(100_003, 16, cuda),
             torch.as_tensor(adversarial_rays(scene.tris, 100_003,
                                              17)).to(cuda),
             k1.pack_rays(crays.p, crays.d).contiguous()]
    joint = []
    for rays8 in cases:
        for p in (pack, tie_pack(pack)):
            got = k1.minarg(rays8, p)
            for a, b, c in zip(got, k1.minarg_simt(rays8, p),
                               k1.minarg_plain(rays8, p)):
                assert torch.equal(a, b) and torch.equal(a, c)
            out, divides, edges, warps = k1.minarg_counted(rays8, p)
            assert all(torch.equal(a, b) for a, b in zip(out, got))
            pairs = rays8.shape[1] * p.shape[0]
            assert 0 < edges <= divides <= pairs
            assert 0 <= warps <= -(-rays8.shape[1] // 512) * 8
        assert int((got[0] < k1.BIG).sum()) > 0
        joint.append(warps / (-(-rays8.shape[1] // 512) * 8))
    assert joint[0] > 0.9 and joint[1] > 0.9 and joint[2] < 0.1

    def broken(name):
        raise RuntimeError("kernel loader disabled by the test")

    monkeypatch.setattr(_build, "library", broken)
    for fn in (k1.minarg, k1.minarg_simt, k1.minarg_counted):
        with pytest.raises(RuntimeError, match="disabled"):
            fn(cases[0], pack)


def _sorted_march_lanes(scene, ms, n, seed, device):
    """n lanes of tests/march_lanes.py (half grazing, half aimed) in lane
    sort order, with their features."""
    from march_lanes import aimed_rays, grazing_rays

    from opencl_path_tracer_tpu_torch.ops.kernels import march_kernel as mk
    from opencl_path_tracer_tpu_torch.ops.kernels.plucker_kernel import (
        plucker_feat,
    )
    r8 = torch.as_tensor(np.concatenate(
        [grazing_rays(scene.tris, n // 2, seed),
         aimed_rays(n - n // 2, seed + 1, scene.tris)], 1)).to(device)
    order = torch.sort(mk.lane_key(r8[0:3], r8[3:6], ms), stable=True).indices
    r8s = r8[:, order].contiguous()
    return r8s, plucker_feat(r8s)


def _tie_rows(rows0, out, marks=(0.5, -0.25, 0.125, 9.0)):
    """rows0 with the lanes that `out` moved carrying out's own (t, g)
    and the attributes `marks`: a visit that found that hit only ties."""
    moved = (out[0] != rows0[0]) | (out[5] != rows0[5])
    tied = rows0.clone()
    tied[0] = torch.where(moved, out[0], rows0[0])
    tied[5] = torch.where(moved, out[5], rows0[5])
    for j, mark in zip(range(1, 5), marks):
        tied[j] = torch.where(moved, mark, rows0[j])
    return tied, moved


@pytest.mark.cuda
def test_twelfth_slice_flat_equals_first_kernel(cuda, monkeypatch):
    """K19 on the tensor-core visit over chunks against its first
    (float32-core, one block per segment) kernel and its plain version on
    a crafted list: tr-block 3 of 8 visits every one of the 68 clusters
    of 64, the others only their dummies, on grazing and aimed lanes
    (blocks of 256 lanes, two CUDA blocks each); at chunk sizes 1, 5, 32
    and one chunk per block, in block order too; with start rows whose
    (t, g) a visit only ties (nothing refetched); the CPU plain version
    agrees; only the launched entries count; with the loader broken,
    each raises."""
    from opencl_path_tracer_tpu_torch.ops.kernels import flat_march as fm
    from opencl_path_tracer_tpu_torch.ops.kernels import march_kernel as mk
    scene = library.stress_scene(5000, device=cuda)
    cs, tr, nb = 64, 256, 8
    ms, _, c = mk.build_march_scene(scene.tris, cs)
    assert c == 68
    r8s, feat = _sorted_march_lanes(scene, ms, nb * tr, 21, cuda)
    ent, need = mk._slab_entries(r8s, ms, torch.full((nb * tr,), k1.BIG,
                                                     device=cuda))
    clist0 = mk._block_lists(ent, need, tr, 1)
    rows0 = mk.run_march(clist0, r8s, feat, ms, cs, 1, tr)
    bu = torch.zeros((c, nb), dtype=torch.bool, device=cuda)
    bu[:, 3] = True
    vb, vc, _, ovf = fm._build_visit_list(bu, 4096)
    assert int((vc >= 0).sum()) == c and not bool(ovf.any())
    before = dict(_build.launches)
    out = fm.run_flat(vb, vc, r8s, feat, rows0, ms, cs, tr)
    assert torch.equal(out, fm.run_flat_simt(vb, vc, r8s, feat, rows0, ms,
                                             cs, tr))
    assert torch.equal(out, fm.flat_plain(vb, vc, r8s, feat, rows0, ms, cs,
                                          tr))
    chains = []
    for chunk in (1, 5, 32, 1 << 30):
        counted, chain = fm.run_flat_counted(vb, vc, r8s, feat, rows0, ms,
                                             cs, tr, chunk)
        assert torch.equal(counted, out), chunk
        chains.append(chain)
    assert chains[0] > 0 and len(set(chains)) == 1
    assert torch.equal(out, fm._launch_chunks(
        "flat_march", vb, vc, r8s, feat, rows0, ms, cs, tr, 1 << 30,
        longest_first=False))
    assert {k: _build.launches[k] - before[k] for k in (
        "flat_march", "flat_march_simt", "flat_march_count")} == {
            "flat_march": 2, "flat_march_simt": 1, "flat_march_count": 4}
    lanes = slice(3 * tr, 4 * tr)
    assert bool((out[0, lanes] < rows0[0, lanes]).any())
    assert torch.equal(out[:, :3 * tr], rows0[:, :3 * tr])
    tied, moved = _tie_rows(rows0, out)
    assert int(moved.sum()) > 10
    got = fm.run_flat(vb, vc, r8s, feat, tied, ms, cs, tr)
    assert torch.equal(got, fm.run_flat_simt(vb, vc, r8s, feat, tied, ms,
                                             cs, tr))
    assert torch.equal(got, fm.flat_plain(vb, vc, r8s, feat, tied, ms, cs,
                                          tr))
    assert torch.equal(got[:6, moved], tied[:6, moved])
    cpu = mk.MarchScene(**{k: v.cpu() for k, v in vars(ms).items()})
    assert torch.equal(fm.run_flat(vb.cpu(), vc.cpu(), r8s.cpu(), feat.cpu(),
                                   rows0.cpu(), cpu, cs, tr), out.cpu())

    def broken(name):
        raise RuntimeError("kernel loader disabled by the test")

    monkeypatch.setattr(_build, "library", broken)
    for fn in (fm.run_flat, fm.run_flat_simt, fm.run_flat_counted):
        with pytest.raises(RuntimeError, match="disabled"):
            fn(vb, vc, r8s, feat, rows0, ms, cs, tr)


@pytest.mark.cuda
def test_twelfth_slice_lazy_equals_first_kernel(cuda, monkeypatch):
    """K20 on the tensor-core visit against its first (float32-core)
    kernel and its plain version with every mask word in use (1,013
    clusters of 64, cw = 32, random visited bits; each block visits its
    four nearest needed clusters and one of the last word's) on grazing
    and aimed lanes; then from carried rows that a visit only ties: the lanes that
    moved carry their own (t, g) with other attributes, and every third
    lane g = 0 as the dense net writes it; the counting entry's outputs
    equal; only the launched entries count; with the loader broken, each
    raises."""
    from opencl_path_tracer_tpu_torch.ops.kernels import lazy_march as lm
    from opencl_path_tracer_tpu_torch.ops.kernels import march_kernel as mk
    scene = library.stress_scene(65000, device=cuda)
    cs, tr, K, n = 64, 256, 5, 4096
    ms, _, c = mk.build_march_scene(scene.tris, cs)
    cw = -(-c // 32)
    assert cw == 32
    r8s, feat = _sorted_march_lanes(scene, ms, n, 23, cuda)
    ent, need = mk._slab_entries(r8s, ms, torch.full((n,), k1.BIG,
                                                     device=cuda))
    rs = np.random.default_rng(24)
    vis_u = (rs.integers(0, 1 << 32, (cw, n), dtype=np.uint64)
             & rs.integers(0, 1 << 32, (cw, n), dtype=np.uint64)
             ).astype(np.uint32)
    vis = torch.as_tensor(vis_u.view(np.int32)).to(cuda)
    # The four nearest needed clusters of each block, then one of the last
    # mask word's (992-1012), so that every word can gain a bit.
    near = mk._block_lists(ent, need & lm.unvisited_mask(vis, c), tr, K - 1)
    far = 992 + torch.arange(n // tr, dtype=torch.int32, device=cuda) % 21
    clist = torch.cat([near.view(-1, K - 1), far[:, None]], 1).reshape(-1)
    rows = mk.miss_rows(n, cuda)[:6].contiguous()
    before = dict(_build.launches)
    runs = []
    for start in ("miss", "tied"):
        got = lm.run_lazy_march(clist, r8s, feat, rows, vis, ms, cs, K, tr)
        for want in (lm.run_lazy_march_simt(clist, r8s, feat, rows, vis, ms,
                                            cs, K, tr),
                     lm.lazy_plain(clist, r8s, feat, rows, vis, ms, cs, K,
                                   tr),
                     lm.run_lazy_march_counted(clist, r8s, feat, rows, vis,
                                               ms, cs, K, tr)[:2]):
            assert torch.equal(got[0], want[0]) and torch.equal(
                got[1], want[1]), start
        assert bool((got[1] != vis).any()) and bool(
            (got[1][31] != vis[31]).any())
        runs.append(got)
        if start == "miss":
            start7 = torch.cat([rows, torch.zeros_like(rows[:1])])
            tied, moved = _tie_rows(start7, got[0])
            tied[5, ::3] = torch.where(moved[::3], 0.0, tied[5, ::3])
            assert int(moved.sum()) > 100
            rows = tied[:6].contiguous()
    out = runs[1][0]
    assert torch.equal(out[:6, moved], rows[:, moved])
    assert {k: _build.launches[k] - before[k] for k in (
        "lazy_march", "lazy_march_simt", "lazy_march_count")} == {
            "lazy_march": 2, "lazy_march_simt": 2, "lazy_march_count": 2}

    def broken(name):
        raise RuntimeError("kernel loader disabled by the test")

    monkeypatch.setattr(_build, "library", broken)
    for fn in (lm.run_lazy_march, lm.run_lazy_march_simt,
               lm.run_lazy_march_counted):
        with pytest.raises(RuntimeError, match="disabled"):
            fn(clist, r8s, feat, rows, vis, ms, cs, K, tr)


def _pair_rays(scene, device):
    """Grazing and aimed rays of stress_scene(1200) (tests/march_lanes.py)
    with a few special ones: D = 0 and a subnormal direction
    component."""
    from march_lanes import aimed_rays, grazing_rays
    r8 = np.concatenate([grazing_rays(scene.tris, 6144, 13),
                         aimed_rays(2048, 14, scene.tris)], 1)
    r8[3:6, 0:8] = 0.0
    r8[4, 8:16] = 1e-42
    return torch.as_tensor(r8).to(device)


def _tile_shapes(keys, c, block, tile):
    """(a tile holds two runs or more, a block mixes real and dummy
    pairs, a block is all dummies) for cluster-sorted keys."""
    k = keys.cpu().numpy()
    t = k.reshape(-1, tile)
    b = k.reshape(-1, block)
    runs = (np.diff(t, axis=1) != 0).sum(1) + 1
    dummy = b == c
    return ((runs >= 2).any(), (dummy.any(1) & ~dummy.all(1)).any(),
            dummy.all(1).any())


@pytest.mark.cuda
def test_thirteenth_slice_pair_visit_equals_first_kernel(cuda):
    """K10 on K18's tensor-core visit, the features computed in the
    kernel, against its first (float32-core) kernel and its plain version
    on the pairs of grazing and aimed lanes of stress_scene(1200) (K9's
    two nearest clusters of 128, tiles of 256 pairs): tiles that span two
    runs or more, blocks that mix real and dummy pairs and blocks of
    dummies only; the counting entry's outputs equal and some edge tests
    take the chain; only the launched entries count; a CPU prefix takes
    the plain version."""
    from opencl_path_tracer_tpu_torch.ops.kernels import pair_mxu as pm
    from opencl_path_tracer_tpu_torch.ops.kernels import sorted_intersect as si
    from opencl_path_tracer_tpu_torch.ops.kernels.march_kernel import (
        build_march_scene,
    )
    scene = library.stress_scene(1200, device=cuda)
    cs, trp = 128, 256
    ms, rt, c = build_march_scene(scene.tris, cs)
    boxes = torch.cat([ms.boxes_lo, ms.boxes_hi,
                       torch.zeros((c, 2), device=cuda),
                       pm.build_dops(rt, cs, c)], 1)
    boxes_r = torch.zeros((-(-c // 128) * 128, 16), device=cuda)
    boxes_r[:c] = boxes
    r8 = _pair_rays(scene, cuda)
    ids = si.run_candidates(r8, boxes_r, 2, c)
    keys_s, r8p, _ = pm.sort_pairs([r8[j] for j in range(6)], ids[0], c, trp)
    # One more tile of dummy pairs (zero rays), as the padding makes them.
    keys_s = torch.cat([keys_s, torch.full((trp,), c, dtype=torch.int32,
                                           device=cuda)])
    r8p = torch.cat([r8p, torch.zeros((8, trp), device=cuda)], 1)
    assert all(_tile_shapes(keys_s, c, 128, trp))
    args = (keys_s, r8p, ms.trig, ms.tric, cs, trp, c)
    before = dict(_build.launches)
    t, gp = pm.pair_visits(*args)
    first = pm.pair_visits_simt(*args)
    plain = pm.pair_visits_plain(*args)
    assert torch.equal(t, first[0]) and torch.equal(gp, first[1])
    assert torch.equal(t, plain[0]) and torch.equal(gp, plain[1])
    (ct, cgp), chain = pm.pair_visits_counted(*args)
    assert torch.equal(ct, t) and torch.equal(cgp, gp) and chain > 0
    assert int((t < k1.BIG).sum()) > 1000
    assert {k: _build.launches[k] - before[k]
            for k in ("pair_visit", "pair_visit_simt",
                      "pair_visit_count")} == {
                "pair_visit": 1, "pair_visit_simt": 1, "pair_visit_count": 1}
    n = 2 * trp
    cpu = pm.pair_visits(keys_s[:n].cpu(), r8p[:, :n].cpu().contiguous(),
                         ms.trig.cpu(), ms.tric.cpu(), cs, trp, c)
    assert torch.equal(cpu[0], t[:n].cpu()) and torch.equal(cpu[1],
                                                            gp[:n].cpu())


@pytest.mark.cuda
def test_thirteenth_slice_pair_vpu_equals_first_kernel(cuda, monkeypatch):
    """K12 with its sub-block skip rule against its first kernel and its
    plain version on the pairs of grazing, aimed and special lanes of
    stress_scene(1200) (K9's eight nearest clusters of 128, sorted in
    tiles of 256): tiles that span runs and blocks with dummy pairs; with
    every sub-block run lane by lane, all by the whole warp and the
    default mix; clusters of 1,024 (staged in two tiles of rows); the
    counting entry's outputs equal, fewer tests reach the divide than the
    first kernel runs, at most three edge tests each, the same counts
    whichever way the warp runs a sub-block."""
    from opencl_path_tracer_tpu_torch.ops.kernels import cluster_kernel as ck
    from opencl_path_tracer_tpu_torch.ops.kernels import pair_mxu as pm
    from opencl_path_tracer_tpu_torch.ops.kernels import sorted_intersect as si
    scene = library.stress_scene(1200, device=cuda)
    r8 = _pair_rays(scene, cuda)
    for cs in (128, 1024):
        cscene, c, k = ck.build_clusters(scene.tris, cs)
        rows = torch.cat([cscene.rows(), torch.zeros((k, 24), device=cuda)])
        sub = si.pair_sub_boxes(rows, k)
        boxes_r = torch.zeros((-(-c // 128) * 128, 8), device=cuda)
        boxes_r[:c] = cscene.boxes
        ids = si.run_candidates(r8, boxes_r, min(8, c), c)
        keys_s, r8p, _ = pm.sort_pairs([r8[j] for j in range(6)], ids[0], c,
                                       256)
        shapes = _tile_shapes(keys_s, c, 256, 256)
        assert shapes[0] and shapes[1]
        first = si.run_pairs_simt(keys_s, r8p, rows, k)
        plain = si.pairs_plain(keys_s, r8p, rows, k)
        assert all(torch.equal(a, b) for a, b in zip(first, plain))
        counts = {}
        for coop in (0, 12, 32):
            monkeypatch.setattr(si, "PAIR_COOP", coop)
            out = si.run_pairs(keys_s, r8p, rows, k, sub)
            assert all(torch.equal(a, b) for a, b in zip(out, first)), (
                cs, coop)
            counted, counts[coop] = si.run_pairs_counted(keys_s, r8p, rows,
                                                         k, sub)
            assert all(torch.equal(a, b) for a, b in zip(counted, first))
        n_div, n_box, n_coop, n_edge = counts[12]
        real = int((keys_s < c).sum())
        assert 0 < n_div < real * k and n_coop <= n_box
        assert 0 < n_edge <= 3 * n_div
        assert counts[0][3] == counts[32][3] == n_edge
        assert counts[0][:2] == counts[32][:2] == (n_div, n_box)
        assert counts[0][2] == 0 and counts[32][2] == n_box
        assert int((first[0] < k1.BIG).sum()) > 1000


@pytest.mark.cuda
def test_fourteenth_slice_cluster_equals_first_kernel(cuda, monkeypatch):
    """K17 with the sub-block skip rule against its first kernel and its
    plain version on stress_scene(1200)'s clusters of 128, tiles of 256
    (and of 96, three warps), on grazing and aimed rays with D = 0 and a
    subnormal direction component, with the early exit off and on; with
    every sub-block run lane by lane, all by the whole warp and the
    default mix; the counting entry's outputs equal, fewer tests reach
    the divide than the first kernel runs, at most three edge tests each,
    the same counts whichever way the warp runs a sub-block; with the
    loader broken, the three entries raise."""
    from opencl_path_tracer_tpu_torch.ops.kernels import cluster_kernel as ck
    scene = library.stress_scene(1200, device=cuda)
    cscene, c, k = ck.build_clusters(scene.tris, 128)
    rows = cscene.rows()
    sub = ck.cluster_sub_boxes(rows, k)
    r8 = _pair_rays(scene, cuda)
    for tr in (256, 96):
        rpad = -(-r8.shape[1] // tr) * tr
        rr8 = ck.pack_rays_rows([r8[j] for j in range(3)],
                                [r8[j] for j in range(3, 6)], rpad)
        ids, cnt, ent = ck._tile_cluster_lists(rr8, cscene.boxes, tr)
        args = (rr8, cnt, ids, ent, rows, k, tr)
        for ee in (False, True):
            first = ck.run_cluster_simt(*args, ee)
            plain = ck.cluster_plain(*args, ee)
            assert all(torch.equal(a, b) for a, b in zip(first, plain))
            counts = {}
            for coop in (-1, 12, 32):
                monkeypatch.setattr(ck, "CLUSTER_COOP", coop)
                out = ck.run_cluster(*args, ee, sub)
                assert all(torch.equal(a, b) for a, b in zip(out, first)), (
                    tr, ee, coop)
                counted, counts[coop] = ck.run_cluster_counted(*args, ee, sub)
                assert all(torch.equal(a, b) for a, b in zip(counted, first))
            n_div, n_box, n_coop, n_edge, n_made = counts[12]
            assert 0 < n_div < int(cnt.sum()) * tr * k and n_coop <= n_box
            assert 0 < n_edge <= 3 * n_div and n_box < n_made
            assert counts[-1][1:2] == counts[32][1:2] == (n_box,)
            assert counts[-1][2] == 0 and counts[32][2] == n_box
            assert counts[-1][3] == counts[32][3] == n_edge
            assert int((first[0] < k1.BIG).sum()) > 1000

    def broken(name):
        raise RuntimeError("kernel loader disabled by the test")

    monkeypatch.setattr(_build, "library", broken)
    for fn in (lambda: ck.run_cluster(*args, False, sub),
               lambda: ck.run_cluster_simt(*args),
               lambda: ck.run_cluster_counted(*args, False, sub)):
        with pytest.raises(RuntimeError, match="disabled"):
            fn()


@pytest.mark.cuda
def test_fourteenth_slice_anyhit_equals_first_kernel(cuda, monkeypatch):
    """K7 with the sub-block skip rule against its first kernel and its
    plain version on the Cornell box and the reference scene (its
    zero-area triangles), on random rays and on rays aimed at triangles,
    with rmax 0, -0, negative, NaN, infinite, subnormal, BIG and random,
    a batch that ends inside a warp; every sub-block lane by lane, all by
    the whole warp and the default mix; the counting entry's flags equal;
    with the loader broken, the three entries raise."""
    import pathlib
    from march_lanes import aimed_rays
    from opencl_path_tracer_tpu_torch.ops.kernels import tilecull_kernel as tk
    models = pathlib.Path(__file__).resolve().parent / "assets" / "models"
    scenes = (library.cornell_box(with_spheres=True, device=cuda),
              library.reference_scene(str(models), smooth=True, device=cuda))
    special = torch.tensor([0.0, -0.0, -5.0, float("nan"), float("inf"),
                            1e-42, 3.0e38], device=cuda)
    for scene in scenes:
        pack, groups, _ = tk.grouped_pack(scene.tris, 128)
        sub = tk.anyhit_sub_boxes(pack, groups)
        rays8 = torch.cat([_rays8(30_001, 7, cuda), torch.as_tensor(
            aimed_rays(20_000, 8, scene.tris)).to(cuda)], 1)
        rmax = torch.rand(rays8.shape[1], device=cuda,
                          generator=torch.Generator(cuda).manual_seed(1))
        rmax = rmax * 1500.0
        rmax[::11] = special.repeat(-(-rmax[::11].shape[0] // 7))[
            :rmax[::11].shape[0]]
        first = tk.anyhit_simt(rays8, rmax, pack, groups)
        assert torch.equal(first, tk.anyhit_plain(rays8, rmax, pack, groups))
        assert 100 < int(first.sum()) < rays8.shape[1] - 100
        counts = {}
        for coop in (-1, 12, 32):
            monkeypatch.setattr(tk, "ANYHIT_COOP", coop)
            assert torch.equal(tk.anyhit(rays8, rmax, pack, groups, sub),
                               first)
            occ, counts[coop] = tk.anyhit_counted(rays8, rmax, pack, groups,
                                                  sub)
            assert torch.equal(occ, first)
        n_div, n_box, n_coop, n_edge, n_made = counts[12]
        assert 0 < n_div and n_coop <= n_box < n_made
        assert 0 < n_edge <= 3 * n_div
        assert counts[-1][2] == 0 and counts[32][2] == counts[32][1]

    def broken(name):
        raise RuntimeError("kernel loader disabled by the test")

    monkeypatch.setattr(_build, "library", broken)
    for fn in (lambda: tk.anyhit(rays8, rmax, pack, groups, sub),
               lambda: tk.anyhit_simt(rays8, rmax, pack, groups),
               lambda: tk.anyhit_counted(rays8, rmax, pack, groups, sub)):
        with pytest.raises(RuntimeError, match="disabled"):
            fn()


@pytest.mark.cuda
def test_fourteenth_slice_megakernel_nee_skips_the_last_shadow_batch(
        cuda, monkeypatch):
    """The megakernel with NEE through K7 at 64x64, 5 bounces, 2 spp:
    K7 launches 4 times a sample, and the image is the same bits as when
    the last bounce's shadow rays go through K7 too (5 launches)."""
    from opencl_path_tracer_tpu_torch.models import megakernel
    from opencl_path_tracer_tpu_torch.ops import nee, rng
    from opencl_path_tracer_tpu_torch.ops.kernels import tilecull_kernel as tk
    from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
    scene = library.cornell_box(with_spheres=True, device=cuda)
    cam = library.cornell_camera(64, 64, device=cuda)
    table = nee.build_emitter_table(scene.tris, scene.mats, scene.spheres)
    occ = tk.make_scene_occluded(scene)
    isect = make_intersect_fn(scene, "auto")

    def render():
        before = _build.launches["anyhit"]
        st = megakernel.init_state(64 * 64, 1, device=cuda)
        for _ in range(2):
            st = megakernel.trace_sample(
                cam, scene.mats, st, intersect_fn=isect, iterations=5,
                mode="fast", key=rng.key(1), nee=table, occluded_fn=occ)
        torch.cuda.synchronize()
        return megakernel.colors_array(st), _build.launches["anyhit"] - before

    colors, n = render()
    assert n == 2 * 4
    monkeypatch.setattr(megakernel, "_unoccluded", occ)
    colors_all, n_all = render()
    assert n_all == 2 * 5
    assert torch.equal(colors, colors_all)


@pytest.mark.cuda
def test_fifteenth_slice_tilecull_equals_first_kernel(cuda, monkeypatch):
    """K6 with the sub-block skip rule against its first kernel, its
    plain version and its counting entry on the Cornell box and the
    reference scene (its zero-area triangles), groups front to back from
    the camera's eye, on random rays, rays aimed at triangles and rays
    with zero, subnormal and huge components, a batch that ends inside a
    warp; every sub-block lane by lane, all by the whole warp and the
    default mix; t equal to K1's; with the loader broken, the three
    entries raise."""
    import pathlib
    from march_lanes import aimed_rays
    from opencl_path_tracer_tpu_torch.ops.kernels import tilecull_kernel as tk
    models = pathlib.Path(__file__).resolve().parent / "assets" / "models"
    for scene, cam in (
            (library.cornell_box(with_spheres=True, device=cuda),
             library.cornell_camera(16, 16, device=cuda)),
            (library.reference_scene(str(models), smooth=True, device=cuda),
             library.reference_camera(16, 16, device=cuda))):
        eye = tuple(float(v) for v in cam.eye.cpu())
        pack, groups, _ = tk.grouped_pack(scene.tris, 128, origin=eye)
        sub = tk.anyhit_sub_boxes(pack, groups)
        rays8 = torch.cat([_rays8(30_001, 7, cuda), torch.as_tensor(
            aimed_rays(20_000, 8, scene.tris)).to(cuda)], 1)
        sel = rays8[:, ::13]
        for n, (row, v) in enumerate([(3, 0.0), (4, -0.0), (3, 1e-42),
                                      (5, -3e-39), (4, 1e30), (0, 3e20),
                                      (3, 2e12)]):
            sel[row, n::7] = v
        sel[3:6, 7::14] = 0.0
        rays8[:, ::13] = sel
        first = tk.tilecull_simt(rays8, pack, groups)
        plain = tk.tilecull_plain(rays8, pack, groups)
        assert all(torch.equal(a, b) for a, b in zip(first, plain))
        t1 = k1.minarg(rays8, k1.build_tri_pack(scene.tris))[0]
        assert torch.equal(first[0], t1)
        counts = {}
        for coop in (-1, 12, 32):
            monkeypatch.setattr(tk, "TILECULL_COOP", coop)
            out = tk.tilecull(rays8, pack, groups, sub)
            assert all(torch.equal(a, b) for a, b in zip(out, first)), coop
            counted, counts[coop] = tk.tilecull_counted(rays8, pack, groups,
                                                        sub)
            assert all(torch.equal(a, b) for a, b in zip(counted, first))
        n_div, n_box, n_coop, n_edge, n_made = counts[12]
        assert 0 < n_div and n_coop <= n_box < n_made
        assert 0 < n_edge <= 3 * n_div
        assert counts[-1][:2] == counts[32][:2] == (n_div, n_box)
        assert counts[-1][2] == 0 and counts[32][2] == n_box
        assert counts[-1][3] == counts[32][3] == n_edge
        assert int((first[0] < k1.BIG).sum()) > 1000

    def broken(name):
        raise RuntimeError("kernel loader disabled by the test")

    monkeypatch.setattr(_build, "library", broken)
    for fn in (lambda: tk.tilecull(rays8, pack, groups, sub),
               lambda: tk.tilecull_simt(rays8, pack, groups),
               lambda: tk.tilecull_counted(rays8, pack, groups, sub)):
        with pytest.raises(RuntimeError, match="disabled"):
            fn()


@pytest.mark.cuda
def test_fifteenth_slice_group_equals_first_kernel(cuda, monkeypatch):
    """K16 with the sub-block skip rule against its first kernel, its
    plain version and its counting entry on the Cornell box's and the
    reference scene's clusters, on camera and first-bounce rays (64 x 64)
    mask-sorted by `group_inputs` in blocks of 2,048 and of 96 (blocks
    that straddle warps), and on random rays under random unions (bits
    of clusters a ray's own mask lacks); every sub-block lane by lane,
    all by the whole warp and the default mix; the 'group' accel's hits
    equal K4's; with the loader broken, the three entries raise."""
    import pathlib
    from opencl_path_tracer_tpu_torch.core.types import Rays
    from opencl_path_tracer_tpu_torch.ops.kernels import cluster_kernel as ck
    from opencl_path_tracer_tpu_torch.ops.kernels import sorted_intersect as si
    from opencl_path_tracer_tpu_torch.runtime.cull_ab import _bounce
    from opencl_path_tracer_tpu_torch.ops import raygen, rng
    models = pathlib.Path(__file__).resolve().parent / "assets" / "models"
    gen = torch.Generator(cuda).manual_seed(2)
    for scene, cam in (
            (library.cornell_box(with_spheres=True, device=cuda),
             library.cornell_camera(64, 64, device=cuda)),
            (library.reference_scene(str(models), smooth=True, device=cuda),
             library.reference_camera(64, 64, device=cuda))):
        cscene, c, k = ck.build_clusters(scene.tris, 128, split_large=True)
        rows = cscene.rows()
        sub = ck.cluster_sub_boxes(rows, k)
        s1, u1 = rng.lehmer_step(rng.seed_pixel_streams(64 * 64, 1,
                                                        device=cuda))
        _, u2 = rng.lehmer_step(s1)
        rays = raygen.camera_rays(cam, raygen.pixel_ids(64, 64, cuda), u1,
                                  u2)
        r8 = _rays8(10_240, 9, cuda)
        batches = []
        for block in (2048, 96):
            for rs in (rays, _bounce(scene, cam, rays)):
                _, union, rr8 = si.group_inputs(rs, cscene.boxes, block)
                batches.append((union, rr8, block, True))
        union = torch.randint(0, 1 << c, (5,), dtype=torch.int32,
                              device=cuda, generator=gen)
        batches.append((union, ck.pack_rays_rows(
            [r8[j] for j in range(3)], [r8[j] for j in range(3, 6)],
            10_240), 2048, False))
        for union, rr8, block, aimed in batches:
            args = (union, rr8, rows, k, block)
            first = si.run_group_simt(*args)
            plain = si.group_plain(*args)
            assert all(torch.equal(a, b) for a, b in zip(first, plain))
            counts = {}
            for coop in (-1, 12, 32):
                monkeypatch.setattr(si, "GROUP_COOP", coop)
                out = si.run_group(*args, sub)
                assert all(torch.equal(a, b) for a, b in zip(out, first)), (
                    block, coop)
                counted, counts[coop] = si.run_group_counted(*args, sub)
                assert all(torch.equal(a, b) for a, b in zip(counted, first))
            n_div, n_box, n_coop, n_edge, n_made = counts[12]
            bits = sum(int(((union >> b) & 1).sum()) for b in range(c))
            assert n_div < bits * block * k and n_coop <= n_box < n_made
            assert n_edge <= 3 * n_div and (n_edge > 0 or not aimed)
            assert counts[-1][:2] == counts[32][:2] == (n_div, n_box)
            assert counts[-1][2] == 0 and counts[32][2] == n_box
            assert counts[-1][3] == counts[32][3] == n_edge
        monkeypatch.setattr(si, "GROUP_COOP", 16)
        both = Rays(p=tuple(r8[j].contiguous() for j in range(3)),
                    d=tuple(r8[j].contiguous() for j in range(3, 6)))
        h = si.make_group_intersect(scene.tris)(both)
        td = k1.dense(r8, k1.build_tri_pack(scene.tris))[0]
        hit = td < k1.BIG
        assert torch.equal(h.t > 0, hit)
        torch.testing.assert_close(h.t[hit], td[hit], rtol=2e-5, atol=1e-3)

    def broken(name):
        raise RuntimeError("kernel loader disabled by the test")

    monkeypatch.setattr(_build, "library", broken)
    for fn in (lambda: si.run_group(*args, sub),
               lambda: si.run_group_simt(*args),
               lambda: si.run_group_counted(*args, sub)):
        with pytest.raises(RuntimeError, match="disabled"):
            fn()


def _bits_equal(a, b):
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


@pytest.mark.cuda
def test_sixteenth_slice_dense_equals_first_kernel(cuda, monkeypatch):
    """K14 and K15 with the sub-block skip rule against their first
    kernels, their plain versions and their counting entries on the
    Cornell box and the reference scene (its zero-area triangles), on
    random rays, rays aimed at triangles and rays with zero, subnormal and
    huge components, a batch that ends inside a warp; every sub-block lane
    by lane, all by the whole warp and the default mix; K14 equal to K1 +
    K2; without the table, and with the loader broken, they raise."""
    import pathlib
    from march_lanes import aimed_rays
    from opencl_path_tracer_tpu_torch.ops.kernels import cluster_kernel as ck
    models = pathlib.Path(__file__).resolve().parent / "assets" / "models"
    entries = {"minarg_fused": (k2, "MINARG_FUSED_COOP", k2.minarg_fused,
                                k2.minarg_fused_simt, k2.minarg_fused_counted,
                                k2.minarg_fused_plain),
               "mxu": (k1, "MXU_COOP", k1.mxu, k1.mxu_simt, k1.mxu_counted,
                       k1.mxu_plain)}
    for scene in (library.cornell_box(with_spheres=True, device=cuda),
                  library.reference_scene(str(models), smooth=True,
                                          device=cuda)):
        pack = k1.build_tri_pack(scene.tris)
        sub = ck.sub_boxes(pack, [(0, pack.shape[0])])
        rays8 = torch.cat([_rays8(30_001, 7, cuda), torch.as_tensor(
            aimed_rays(20_000, 8, scene.tris)).to(cuda)], 1).contiguous()
        sel = rays8[:, ::13]
        for n, (row, v) in enumerate([(3, 0.0), (4, -0.0), (3, 1e-42),
                                      (5, -3e-39), (4, 1e30), (0, 3e20),
                                      (3, 2e12)]):
            sel[row, n::7] = v
        sel[3:6, 7::14] = 0.0
        rays8[:, ::13] = sel
        k12 = k2.refine1(*k1.minarg(rays8, pack), pack)
        for name, (mod, coop_name, fn, simt, counted, plain) in (
                entries.items()):
            first = simt(rays8, pack)
            assert _bits_equal(first, plain(rays8, pack)), name
            if name == "minarg_fused":
                assert _bits_equal(first, k12)
            counts = {}
            for coop in (-1, 12, 32):
                monkeypatch.setattr(mod, coop_name, coop)
                assert _bits_equal(fn(rays8, pack, sub), first), (name, coop)
                out, counts[coop] = counted(rays8, pack, sub)
                assert _bits_equal(out, first), (name, coop)
            n_div, n_box, n_coop, n_edge, n_made = counts[12]
            assert 0 < n_div < 0.5 * rays8.shape[1] * pack.shape[0]
            assert n_coop <= n_box < n_made
            assert 0 < n_edge <= 3 * n_div
            assert counts[-1][:2] == counts[32][:2] == (n_div, n_box)
            assert counts[-1][2] == 0 and counts[32][2] == n_box
            assert counts[-1][3] == counts[32][3] == n_edge
            with pytest.raises(ValueError, match="needs sub"):
                fn(rays8, pack)

    def broken(name):
        raise RuntimeError("kernel loader disabled by the test")

    monkeypatch.setattr(_build, "library", broken)
    for _, _, fn, simt, counted, _ in entries.values():
        for call in (lambda: fn(rays8, pack, sub), lambda: simt(rays8, pack),
                     lambda: counted(rays8, pack, sub)):
            with pytest.raises(RuntimeError, match="disabled"):
                call()


@pytest.mark.cuda
def test_sixteenth_slice_dense_on_crafted_batches(cuda):
    """K14 and K15 on tests/sub_cull_mirror.py's crafted batches (exact-t
    ties across sub-blocks, rows accepted above BIG for K15, -0.0 normals,
    D = 0 rays, T = 1, 31, 33 and 804): equal to their plain versions and
    first kernels, K14 to K1 + K2; on K14's batches with rows accepted
    above BIG, K14 equal to its plain version, its first kernel and K1 +
    K2 (the reference's start, csrc/argmin_start.cuh)."""
    from sub_cull_mirror import ABOVE_BIG_CASES, CRAFTED_CASES, crafted_dense
    from opencl_path_tracer_tpu_torch.ops.kernels import cluster_kernel as ck
    tris = library.cornell_box(with_spheres=True).tris
    entries = {"minarg_fused": (k2.minarg_fused, k2.minarg_fused_simt,
                                k2.minarg_fused_plain),
               "mxu": (k1.mxu, k1.mxu_simt, k1.mxu_plain)}
    for name, n_rows, n_deg in CRAFTED_CASES:
        fn, simt, plain = entries[name]
        pack, r8 = crafted_dense(tris, n_rows, n_deg)
        pack, r8 = pack.to(cuda), torch.as_tensor(r8).to(cuda)
        sub = ck.sub_boxes(pack, [(0, n_rows)])
        out = fn(r8, pack, sub)
        assert _bits_equal(out, plain(r8, pack)), (name, n_rows)
        assert _bits_equal(out, simt(r8, pack)), (name, n_rows)
        if name == "minarg_fused":
            assert _bits_equal(out, k2.refine1(*k1.minarg(r8, pack), pack))
    for n_rows, n_deg in ABOVE_BIG_CASES:
        pack, r8 = crafted_dense(tris, n_rows, n_deg)
        pack, r8 = pack.to(cuda), torch.as_tensor(r8).to(cuda)
        sub = ck.sub_boxes(pack, [(0, n_rows)])
        out = k2.minarg_fused(r8, pack, sub)
        assert _bits_equal(out, k2.minarg_fused_simt(r8, pack))
        assert _bits_equal(out, k2.refine1(*k1.minarg(r8, pack), pack))
        assert _bits_equal(out, k2.minarg_fused_plain(r8, pack))


@pytest.mark.cuda
def test_seventeenth_slice_start_above_big(cuda):
    """K1 (its kernel, first kernel and counting entry) and K14 (its
    kernel, first kernel and counting entry) on tests/sub_cull_mirror.py's
    batches whose rays accept row 0 above BIG: equal to minarg_plain and
    minarg_fused_plain, the reference's argmin (a miss there carries row
    n_deg, the first row that does not accept)."""
    from sub_cull_mirror import ABOVE_BIG_CASES, crafted_dense
    from opencl_path_tracer_tpu_torch.ops.kernels import cluster_kernel as ck
    tris = library.cornell_box(with_spheres=True).tris
    for n_rows, n_deg in ABOVE_BIG_CASES:
        pack, r8 = crafted_dense(tris, n_rows, n_deg)
        pack, r8 = pack.to(cuda), torch.as_tensor(r8).to(cuda)
        sub = ck.sub_boxes(pack, [(0, n_rows)])
        want = k1.minarg_plain(r8, pack)
        for got in (k1.minarg(r8, pack), k1.minarg_simt(r8, pack),
                    k1.minarg_counted(r8, pack)[0]):
            assert _bits_equal(got, want), n_rows
        t, ok = k1.exact_test(pack, r8)
        above = ok[0] & (t[0] > k1.BIG) & (want[0] == k1.BIG)
        assert int(above.sum()) > 10 and (want[1][above] == n_deg).all()
        want = k2.minarg_fused_plain(r8, pack)
        for got in (k2.minarg_fused(r8, pack, sub),
                    k2.minarg_fused_simt(r8, pack),
                    k2.minarg_fused_counted(r8, pack, sub)[0]):
            assert _bits_equal(got, want), n_rows


@pytest.mark.cuda
def test_seventeenth_slice_sphere_table_equals_first_kernel(cuda,
                                                            monkeypatch):
    """K3b over its groups against its first kernel, its plain version and
    its counting entry: the many-light scene
    (66 spheres) and the analytic stress scene (138) on random rays, the
    Cornell camera's rays and tests/sphere_cull_mirror.py's crafted batch
    (grazing rays, tangents on box faces, origins inside spheres, exact-t
    ties across groups, radii 1e-3 to 1e4), 300 random spheres (38
    groups), a table with dead rows and one with none live; without the
    groups, and with the loader broken, it raises."""
    from sphere_cull_mirror import (
        KINDS, crafted_rays, crafted_spheres, mirrored_sphere_table)
    from opencl_path_tracer_tpu_torch.core.spheres import SpheresSoA
    from opencl_path_tracer_tpu_torch.ops import raygen, rng
    cam = library.cornell_camera(96, 54, device=cuda)
    s1, u1 = rng.lehmer_step(rng.seed_pixel_streams(96 * 54, 1, device=cuda))
    _, u2 = rng.lehmer_step(s1)
    cray = raygen.camera_rays(cam, raygen.pixel_ids(96, 54, cuda), u1, u2)
    cam8 = k1.pack_rays(cray.p, cray.d).contiguous()
    c, r, m = crafted_spheres()
    rs = np.random.default_rng(5)
    n = 300
    tables = {
        "many-lights": k3.build_sphere_table(
            library.many_light_scene(64, device=cuda).spheres),
        "stress-analytic": k3.build_sphere_table(
            library.stress_scene(analytic=True, device=cuda).spheres),
        "crafted": k3.build_sphere_table(
            SpheresSoA.build(c, r, m, device=cuda)),
        "random 300": k3.build_sphere_table(SpheresSoA.build(
            np.float32(rs.uniform(-200, 1200, (n, 3))),
            np.float32(rs.uniform(2, 40, n)),
            np.int32(np.arange(n) % 9), device=cuda)),
    }
    dead = tables["many-lights"].clone()
    dead[::3, 7] = 0.0
    tables["dead rows"] = dead
    none = dead.clone()
    none[:, 7] = -1.0
    tables["none live"] = none
    crafted = torch.as_tensor(crafted_rays(c, r, 200 * KINDS)).to(cuda)
    for name, table in tables.items():
        groups = k3.sphere_groups(table)
        if name in ("random 300", "none live"):
            assert groups.data.shape[0] == (38 if name == "random 300" else 0)
        for rays8 in (_rays8(30_001, 9, cuda), cam8, crafted):
            want = k3.sphere_table_plain(rays8, table)
            assert _bits_equal(k3.sphere_table_simt(rays8, table), want)
            before = _build.launches["sphere_table"]
            got = k3.sphere_table(rays8, table, groups)
            assert _bits_equal(got, want), name
            out, counts = k3.sphere_table_counted(rays8, table, groups)
            assert _bits_equal(out, want), name
            made, passed, n_disc, n_sqrt, n_warp = counts
            assert made == rays8.shape[1] * groups.data.shape[0]
            assert passed <= made and n_sqrt <= n_disc
            assert n_disc <= passed * k3.SPHERE_GROUP
            assert passed / 32 <= n_warp <= passed
            assert _bits_equal(k3.sphere_table(rays8.cpu(), table.cpu()),
                               [x.cpu() for x in want])
            assert _build.launches["sphere_table"] == before + 1
        if name == "crafted":
            got, mc = mirrored_sphere_table(crafted.cpu().numpy(),
                                            table.cpu(), groups)
            assert _bits_equal([x.to(cuda) for x in got], want)
            assert mc == k3.sphere_table_counted(crafted, table, groups)[1]
    table = tables["many-lights"]
    with pytest.raises(ValueError, match="needs groups"):
        k3.sphere_table(cam8, table)
    with pytest.raises(ValueError, match="of 66 spheres, not 300"):
        k3.sphere_table(cam8, tables["random 300"], k3.sphere_groups(table))

    def broken(name):
        raise RuntimeError("kernel loader disabled by the test")

    groups = k3.sphere_groups(table)
    monkeypatch.setattr(_build, "library", broken)
    for call in (lambda: k3.sphere_table(cam8, table, groups),
                 lambda: k3.sphere_table_simt(cam8, table),
                 lambda: k3.sphere_table_counted(cam8, table, groups)):
        with pytest.raises(RuntimeError, match="disabled"):
            call()


@pytest.mark.cuda
def test_twenty_first_slice_auto_pick_repick_and_presort(cuda):
    """The engine's 'auto' on the card is the predictor's pick at
    AUTO_TILECULL_THRESHOLD, re-picked and cached per depth; presorted
    K6 gives presort='none''s Hits and ids."""
    from opencl_path_tracer_tpu_torch.config import CameraConfig, RenderConfig
    from opencl_path_tracer_tpu_torch.ops import raygen
    from opencl_path_tracer_tpu_torch.ops.kernels import tilecull_kernel as tk
    from opencl_path_tracer_tpu_torch.runtime import engine
    scene = library.cornell_box(with_spheres=True, device=cuda)
    eng = engine.RenderEngine(scene, RenderConfig(
        width=64, height=48, iterations=5, spp=1, camera=CameraConfig(
            fov=60.0, yaw=0.0, pitch=0.0, shift=(0.0, 0.0, 0.0))),
        device=cuda)
    cam = eng.camera
    assert eng._accel_auto
    assert eng.intersect_fn.accel == tk.auto_small_accel(
        scene.tris, cam, iterations=5,
        threshold=engine.AUTO_TILECULL_THRESHOLD)
    first = eng.intersect_fn
    for _ in range(4):
        eng.controller.key_down("-")
    eng.frame()
    one = eng.intersect_fn
    assert one.accel == tk.auto_small_accel(
        scene.tris, cam, iterations=1,
        threshold=engine.AUTO_TILECULL_THRESHOLD)
    for _ in range(4):
        eng.controller.key_down("+")
    eng.frame()
    assert eng.intersect_fn is first and eng._accel_by_iters[1] is one
    assert np.isfinite(eng.image()).all()
    origin = tuple(float(v) for v in cam.eye.cpu())
    ids = raygen.pixel_ids(64, 48, cuda)
    half = torch.full(ids.shape, 0.5, device=cuda)
    rays = raygen.camera_rays(cam, ids, half, half)
    ref, rid = tk.make_tilecull_intersect(scene.tris, with_ids=True,
                                          origin=origin)(rays)
    for presort in ("octant", "morton"):
        h, i = tk.make_tilecull_intersect(scene.tris, with_ids=True,
                                          origin=origin,
                                          presort=presort)(rays)
        assert torch.equal(h.t, ref.t) and torch.equal(i, rid)
        assert torch.equal(h.mati, ref.mati)


@pytest.mark.cuda
def test_twenty_first_slice_flat_bands_are_the_wavefront_render(cuda):
    """Three bands without dispersion on the card: the plain wavefront
    render, bit for bit (K1, K2, K3 and K7 on every band)."""
    from opencl_path_tracer_tpu_torch.models import spectral, wavefront
    from opencl_path_tracer_tpu_torch.ops.kernels.tilecull_kernel import (
        make_scene_occluded)
    from opencl_path_tracer_tpu_torch.ops.nee import build_emitter_table
    from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
    scene = library.cornell_box(with_spheres=True, analytic_spheres=True,
                                device=cuda)
    cam = library.cornell_camera(64, 48, device=cuda)
    kw = dict(intersect_fn=make_intersect_fn(scene, cam=cam),
              num_pixels=64 * 48, iterations=5, min_spp=2, mode="fast",
              nee=build_emitter_table(scene.tris, scene.mats, scene.spheres),
              occluded_fn=make_scene_occluded(scene))
    before = dict(_build.launches)
    flat = spectral.render_dispersive(cam, scene.mats, bands=3, v_d=None,
                                      **kw)
    assert all(_build.launches[k] > before[k]
               for k in ("minarg", "refine1", "spheres", "anyhit"))
    st = wavefront.render_wavefront(cam, scene.mats, exact_spp=True,
                                    device=cuda, **kw)
    assert torch.equal(flat, wavefront.colors_by_pixel(st, 64 * 48))
    disp = spectral.render_dispersive(cam, scene.mats, bands=3, v_d=30.0,
                                      **kw)
    assert disp.is_cuda and bool(torch.isfinite(disp).all())


@pytest.mark.cuda
@pytest.mark.parametrize("infeat", [False, True])
def test_twenty_second_slice_pair_visit_full_equals_plain(cuda, infeat):
    """K10's full form (five streams) and, with infeat, its thin form on
    the fused features, against their plain versions on the pairs of
    grazing and aimed lanes of stress_scene(1200) (clusters of 128, tiles
    of 256, one tile of dummies); the full form's t and pend equal the
    thin form's, its attributes K11's fetch of the thin form's winner;
    only the launched entries count."""
    from opencl_path_tracer_tpu_torch.ops.kernels import pair_mxu as pm
    from opencl_path_tracer_tpu_torch.ops.kernels import sorted_intersect as si
    from opencl_path_tracer_tpu_torch.ops.kernels.march_kernel import (
        build_march_scene,
    )
    scene = library.stress_scene(1200, device=cuda)
    cs, trp = 128, 256
    ms, rt, c = build_march_scene(scene.tris, cs)
    boxes = torch.cat([ms.boxes_lo, ms.boxes_hi,
                       torch.zeros((c, 2), device=cuda)], 1)
    boxes_r = torch.zeros((-(-c // 128) * 128, 8), device=cuda)
    boxes_r[:c] = boxes
    r8 = _pair_rays(scene, cuda)
    ids = si.run_candidates(r8, boxes_r, 4, c)
    keys_s, r8p, _ = pm.sort_pairs([r8[j] for j in range(6)], ids[0], c, trp)
    keys_s = torch.cat([keys_s, torch.full((trp,), c, dtype=torch.int32,
                                           device=cuda)])
    r8p = torch.cat([r8p, torch.zeros((8, trp), device=cuda)], 1)
    args = (keys_s, r8p, ms.trig, ms.tric, cs, trp, c)
    before = dict(_build.launches)
    full = pm.pair_visits_full(*args, infeat=infeat)
    thin = pm.pair_visits(*args, infeat=infeat)
    assert {k: _build.launches[k] - before[k]
            for k in ("pair_visit", "pair_visit_full")} == {
                "pair_visit": 1, "pair_visit_full": 1}
    for a, b in zip(full, pm.pair_visits_full_plain(*args, infeat=infeat)):
        assert torch.equal(a, b)
    for a, b in zip(thin, pm.pair_visits_plain(*args, infeat=infeat)):
        assert torch.equal(a, b)
    t, gp = thin
    g = torch.floor(gp / 2.0)
    pend = gp - 2.0 * g
    fetched = pm.fetch_attrs(torch.where(t < k1.BIG, g, -1.0), ms.tric)
    assert torch.equal(full[0], t)
    assert torch.equal(full[4] - 2.0 * torch.floor(full[4] / 2.0), pend)
    for a, b in zip(full[1:4], fetched[:3]):
        assert torch.equal(a, b)
    assert torch.equal(torch.floor(full[4] / 2.0), fetched[3])
    assert int((t < k1.BIG).sum()) > 1000 and bool((pend > 0).any())


def _front_end_engine(cuda, size=(96, 64), **kw):
    from opencl_path_tracer_tpu_torch.config import CameraConfig, RenderConfig
    from opencl_path_tracer_tpu_torch.runtime import engine
    cfg = RenderConfig(width=size[0], height=size[1], iterations=5,
                       mode="fast", camera=CameraConfig(
                           fov=60.0, yaw=0.0, pitch=0.0,
                           shift=(0.0, 0.0, 0.0)), **kw)
    scene = library.cornell_box(with_spheres=True, device=cuda)
    return engine.RenderEngine(scene, cfg, device=cuda), scene, cfg


@pytest.mark.cuda
def test_twenty_third_slice_render_animation_equals_fresh_engines(cuda):
    """A turntable on the card ('auto', NEE: the predictor's pick, K2, K7)
    resets to the same draws as a fresh engine at each pose (fast mode),
    through the same intersector (its tilecull groups are ordered from
    the eye it was built at)."""
    import dataclasses
    from opencl_path_tracer_tpu_torch.config import CameraConfig
    from opencl_path_tracer_tpu_torch.runtime import anim, engine
    eng, scene, cfg = _front_end_engine(cuda, nee=True)
    poses = anim.turntable_poses(frames=2, center=(500.0, 500.0, 500.0),
                                 radius=1799.037842, pitch=0.0,
                                 start_yaw=-15.0, sweep=30.0)
    before = dict(_build.launches)
    frames = anim.render_animation(eng, poses, spp=2, progress=False)
    grown = {k for k in _build.launches if _build.launches[k] > before[k]}
    assert {"refine1", "anyhit"} <= grown and grown & {"minarg", "tilecull"}
    for (yaw, pitch, shift), f in zip(poses, frames):
        fresh = engine.RenderEngine(scene, dataclasses.replace(
            cfg, camera=CameraConfig(fov=60.0, yaw=yaw, pitch=pitch,
                                     shift=tuple(float(v) for v in shift))),
            intersect_fn=eng.intersect_fn, device=cuda)
        fresh.render(2, progress=False)
        np.testing.assert_array_equal(f, fresh.display_u8())
    assert not np.array_equal(frames[0], frames[1])


@pytest.mark.cuda
def test_twenty_third_slice_anim_cli_writes_the_raw_gif(cuda, tmp_path,
                                                        monkeypatch):
    """`ptx-torch anim` on the card with PIL set aside: PNG frames and a
    GIF in the raw writer's layout, plain and dispersive."""
    from opencl_path_tracer_tpu_torch import cli
    from opencl_path_tracer_tpu_torch.io import image
    from opencl_path_tracer_tpu_torch.runtime import anim
    monkeypatch.setattr(anim, "_PIL", None)
    monkeypatch.setattr(image, "_PIL", None)
    orbit = ["--size", "64x48", "--frames", "2", "--spp", "2", "--center",
             "500", "500", "500", "--radius", "1799", "--pitch", "0",
             "--sweep", "15"]
    for tag, extra in (("plain", ["--scene", "cornell"]),
                       ("disp", ["--scene", "cornell-analytic",
                                 "--dispersion", "30", "--nee"])):
        gif = str(tmp_path / f"{tag}.gif")
        assert cli.main(["anim", *orbit, *extra, "--out-dir",
                         str(tmp_path / tag), "--gif", gif]) == 0
        for i in range(2):
            img = image.read_png(str(tmp_path / tag / f"frame_{i:04d}.png"))
            assert img.shape == (48, 64, 3) and img.mean() > 1
        data = open(gif, "rb").read()
        assert data[:6] == b"GIF89a" and b"NETSCAPE2.0" in data
        assert data[10] == 0x70 and data.count(b"\x2c\x00\x00\x00\x00") >= 2


@pytest.mark.cuda
def test_twenty_third_slice_viewer_on_the_card(cuda):
    """The viewer's double-buffered fetch on the card: pinned host memory
    behind an event, the frame equal to display_u8(); over HTTP the
    frames come, '+' re-picks, 'n' denoises, ESC stops."""
    import json
    import time
    import urllib.request
    from opencl_path_tracer_tpu_torch.runtime.viewer import ViewerServer
    eng, _, _ = _front_end_engine(cuda)
    v = ViewerServer(eng, port=0)
    eng.frame(sync=False)
    fetch = v._fetch(eng.display_u8_device())
    assert fetch[1].is_pinned() and fetch[2] is not None
    np.testing.assert_array_equal(v._finish(fetch), eng.display_u8())
    httpd = v.serve(block=False)
    base = f"http://127.0.0.1:{v.port}"

    def stats():
        return json.loads(urllib.request.urlopen(base + "/stats",
                                                 timeout=60).read())

    def key(k):
        urllib.request.urlopen(urllib.request.Request(
            base + "/input", method="POST",
            data=json.dumps({"ev": "keydown", "key": k}).encode()),
            timeout=60).read()

    def until(cond):
        deadline = time.time() + 60
        while time.time() < deadline and not cond():
            time.sleep(0.02)
        assert cond()

    try:
        until(lambda: v._seq > 2)
        assert urllib.request.urlopen(base + "/frame.png", timeout=60).read(
            ).startswith(b"\x89PNG")
        key("+")
        until(lambda: eng._accel_iters == 6)
        assert eng.intersect_fn is eng._accel_by_iters[6]
        key("n")
        seq = v._seq
        until(lambda: v._seq > seq + 2)
        assert stats()["denoise"] is True and stats()["error"] is None
        key("Escape")
        until(lambda: v._stop.is_set() and not v._render_thread.is_alive())
    finally:
        v.shutdown()
    assert v.last_error is None


@pytest.mark.cuda
@pytest.mark.parametrize("scene_name", ["cornell", "stress",
                                        "textured-grid"])
def test_bounce_kernel_path_equals_plain_path(cuda, scene_name, tmp_path):
    """K21 (`csrc/bounce.cu`): 4 samples at 1920x1080 and 5 bounces
    through the bounce kernel (`megakernel.trace_sample` on a CUDA state
    in fast mode) against the plain path (`trace_sample_plain`), the
    scene through 'auto' (the textured grid through its (Hits, kd_scale)
    intersector): the rays traced equal, the image within 1e-5 relative
    mean absolute error (a path that branches differently on a rounding
    moves its sample by a whole path's radiance), one raygen a sample and
    one bounce launch a bounce."""
    from opencl_path_tracer_tpu_torch.models import megakernel
    from opencl_path_tracer_tpu_torch.ops import rng
    from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
    w, h, spp, iters = 1920, 1080, 4, 5
    textured = scene_name == "textured-grid"
    if scene_name == "cornell":
        scene = library.cornell_box(with_spheres=True, device=cuda)
    elif scene_name == "stress":
        scene = library.stress_scene(device=cuda)
    else:
        scene = library.textured_room(str(tmp_path), grid=True, device=cuda)
    cam = library.cornell_camera(w, h, device=cuda)
    isect = make_intersect_fn(scene, "auto", cam=cam, iterations=iters,
                              textured=textured)
    key = rng.key(3_100_000_041)

    def render(trace):
        st = megakernel.init_state(w * h, 1, device=cuda)
        rays = 0.0
        for _ in range(spp):
            st, r = trace(cam, scene.mats, st, intersect_fn=isect,
                          iterations=iters, mode="fast", key=key,
                          with_stats=True)
            rays += float(r)
        return torch.stack(st.colors, dim=1), rays

    before = dict(_build.launches)
    img_k, rays_k = render(megakernel.trace_sample)
    assert _build.launches["bounce"] - before["bounce"] == spp * iters
    assert (_build.launches["bounce_raygen"] - before["bounce_raygen"]
            == spp)
    img_p, rays_p = render(megakernel.trace_sample_plain)
    assert rays_k == rays_p
    assert bool(torch.isfinite(img_k).all())
    mae = float((img_k - img_p).abs().sum() / img_p.abs().sum())
    assert mae <= 1e-5, mae
