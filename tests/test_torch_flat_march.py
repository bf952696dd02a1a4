"""K19 (the flat visit list) and the 'flat' intersector in the port against
the JAX package on the CPU: `_build_visit_list` equals JAX's, with and
without overflow (a starved capacity drops visits and blocks' dummies);
K19's plain version equals interpret-mode `_run_flat` on the blocks the
JAX kernel flushes (a block with no visit under the capacity is never
written there; the port keeps its round-0 rows); the flat intersector's
hits equal JAX's and K4's over the reordered triangles, presorted or
not, and with vcap_frac=0.01. K19's work list (`flat_chunks`) covers
each real visit once in chunks, longest segments first, and an
emulation of the kernel's chunked merge on the plain visits equals
flat_plain and interpret-mode `_run_flat`, also where a visit only ties
the start rows; run_flat checks its list."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.ops.pallas import flat_march as jfm
from opencl_path_tracer_tpu.ops.pallas import march_kernel as jmk
from opencl_path_tracer_tpu.ops.pallas.plucker_kernel import (
    plucker_feat as jfeat,
)
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch.ops.kernels import flat_march as fm
from opencl_path_tracer_tpu_torch.ops.kernels import march_kernel as mk
from opencl_path_tracer_tpu_torch.ops.kernels.intersect_kernel import (
    BIG, make_pallas_intersect,
)
from opencl_path_tracer_tpu_torch.ops.kernels.plucker_kernel import (
    plucker_feat,
)
from opencl_path_tracer_tpu_torch.scene import library
from test_torch_march_kernel import aimed_rays, bits, to_rays

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

CS = TR = 128


@pytest.mark.parametrize("vcap", [4096, 40, 23])
def test_visit_list_equals_jax(vcap):
    rs = np.random.default_rng(vcap)
    bu = rs.random((9, 14)) < 0.4
    bu[:, 3] = False                      # a block with only its dummy
    jl = jfm._build_visit_list(jnp.asarray(bu), vcap)
    pl = fm._build_visit_list(torch.as_tensor(bu), vcap)
    for k, (a, b) in enumerate(zip(pl, jl)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"output {k}")
    assert bool(pl[3].any()) == (vcap < 4096)
    vb = pl[0].numpy()
    assert (np.diff(vb) >= 0).all()


def test_k19_equals_interpret_mode_on_flushed_blocks():
    jsc, _, c = jmk.build_march_scene(jlib.stress_scene(1200).tris, CS)
    psc, _, _ = mk.build_march_scene(library.stress_scene(1200).tris, CS)
    r8 = aimed_rays(768, 3, jlib.stress_scene(1200).tris)
    pr8 = torch.as_tensor(r8)
    feat = plucker_feat(pr8)
    ent, need = mk._slab_entries(pr8, psc, torch.full((768,), BIG))
    cl = mk._block_lists(ent, need, TR, 1)
    rows0 = mk.run_march(cl, pr8, feat, psc, CS, 1, TR)
    bu = mk._need(ent, rows0[0]).view(c, -1, TR).any(dim=2) & ~mk._visited_from(
        cl, c, 1)
    vb, vc, _, ovf = fm._build_visit_list(bu, 12)   # overflows
    assert bool(ovf.any()) and not bool(ovf.all())
    got = fm.run_flat(vb, vc, pr8, feat, rows0, psc, CS, TR)
    want = jfm._run_flat(jnp.asarray(vb.numpy()), jnp.asarray(vc.numpy()),
                         jnp.asarray(r8), jfeat(jnp.asarray(r8)),
                         tuple(jnp.asarray(rows0[k:k + 1].numpy())
                               for k in range(7)), CS, TR, True, scene=jsc)
    flushed = torch.isin(torch.arange(768 // TR), vb.long()).repeat_interleave(
        TR).numpy()
    for k in range(7):
        np.testing.assert_array_equal(bits(got[k])[flushed],
                                      bits(want[k][0])[flushed],
                                      err_msg=f"row {k}")
    # Unflushed blocks keep their round-0 rows; round 1 improved others.
    assert torch.equal(got[:, ~torch.as_tensor(flushed)],
                       rows0[:, ~torch.as_tensor(flushed)])
    assert bool((got[0] < rows0[0]).any())


@pytest.mark.parametrize("kw", [dict(K0=2), dict(K0=1, presorted=True),
                                dict(K0=1, vcap_frac=0.01)])
def test_flat_intersect_equals_jax_and_k4(kw):
    js, ps = jlib.stress_scene(1200), library.stress_scene(1200)
    r8 = aimed_rays(300, 8, js.tris)
    jr, pr = to_rays(r8)
    ji, _ = jfm.make_flat_march_intersect(js.tris, cs=CS, tr=TR, tail=128,
                                          interpret=True, **kw)
    pi, prt = fm.make_flat_march_intersect(ps.tris, cs=CS, tr=TR, tail=128,
                                           **kw)
    jh, ph = ji(jr), pi(pr)
    np.testing.assert_array_equal(bits(ph.t), bits(jh.t))
    np.testing.assert_array_equal(ph.mati.numpy(), np.asarray(jh.mati))
    for k in range(3):
        np.testing.assert_array_equal(bits(ph.n[k]), bits(jh.n[k]))
    ref = make_pallas_intersect(prt)(pr)
    hit = ref.t > 0
    assert torch.equal(ph.t, ref.t) and torch.equal(ph.mati, ref.mati)
    for k in range(3):
        assert torch.equal(ph.n[k][hit], ref.n[k][hit])
    assert int(hit.sum()) > 250


def _segments(shape):
    """(vb, vc, nb) of a K19 list: 'empty' (no visit), 'dummy' (one dummy
    per block), 'one' (block 2 of 6 visits all 40 clusters, the others
    only their dummies) and 'cut' (a list cut at Vcap: blocks past it get
    no visit)."""
    if shape == "empty":
        e = torch.zeros(0, dtype=torch.int32)
        return e, e, 5
    if shape == "dummy":
        return (torch.arange(7, dtype=torch.int32),
                torch.full((7,), -1, dtype=torch.int32), 7)
    bu = np.zeros((40, 6), bool)
    if shape == "one":
        bu[:, 2] = True
        vcap = 4096
    else:
        bu = np.random.default_rng(5).random((40, 9)) < 0.5
        bu[:, 4] = True
        vcap = 96
    vb, vc, _, _ = fm._build_visit_list(torch.as_tensor(bu), vcap)
    return vb, vc, bu.shape[1]


@pytest.mark.parametrize("shape", ["empty", "dummy", "one", "cut"])
@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_flat_chunks_cover_each_real_visit_once(shape, chunk):
    vb, vc, nb = _segments(shape)
    items, vcr, counts = fm.flat_chunks(vb, vc, nb, chunk)
    v = vc.numel()
    assert items.dtype == vcr.dtype == torch.int32
    assert items.shape == (3, -(-v // chunk) + nb) and vcr.shape == (v,)
    live = (vc >= 0).numpy()
    vbn, vcn = vb.numpy(), vc.numpy()
    total = int(live.sum())
    np.testing.assert_array_equal(vcr[:total].numpy(), vcn[live])
    assert bool((vcr[total:] == -1).all())
    want_counts = np.bincount(vbn[live], minlength=nb)
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    blk, first, end = items.numpy()
    real = blk >= 0
    nreal = int(real.sum())
    # Real items first, then surplus items; every real item holds 1 to
    # `chunk` real visits of its own block, and together they cover each
    # real visit exactly once.
    assert real[:nreal].all() and not real[nreal:].any()
    assert nreal == int(sum(-(-c // chunk) for c in want_counts))
    seen = np.zeros(total, int)
    for b, f, e in zip(blk[:nreal], first[:nreal], end[:nreal]):
        assert 1 <= e - f <= chunk
        seen[f:e] += 1
        np.testing.assert_array_equal(vcr[f:e].numpy(),
                                      vcn[live & (vbn == b)][
                                          f - want_counts[:b].sum():
                                          e - want_counts[:b].sum()])
    assert (seen == 1).all()
    # Longest segments first: blocks in order of falling counts (ties in
    # block order), each block's chunks together.
    order = [int(b) for k, b in enumerate(blk[:nreal])
             if k == 0 or b != blk[k - 1]]
    assert len(order) == len(set(order))
    assert order == sorted(order, key=lambda b: (-want_counts[b], b))
    assert order == [b for b in np.argsort(-want_counts, kind="stable")
                     if want_counts[b]]


def _chunked_flat(vb, vc, r8, feat, rows0, scene, chunk):
    """An emulation of K19's schedule on the plain visits: each chunk of
    `flat_chunks` run by flat_plain from rows0 (pend 0), the chunks that
    beat a lane's (t, g) merged by the minimum of (bits(t) << 32) |
    bits(g), pend by OR; then each lane's rows: where the merged (t, g)
    moved, it and tric's row g + 0.0, else rows0's; pend 1 where a chunk
    left the lane pending, else rows0's."""
    n = r8.shape[1]
    items, vcr, _ = fm.flat_chunks(vb, vc, n // TR, chunk)
    start = rows0.clone()
    start[6] = 0.0
    never = torch.iinfo(torch.int64).max
    best = torch.full((n,), never, dtype=torch.int64)
    pend = torch.zeros(n, dtype=torch.bool)
    for b, f, e in items.T.tolist():
        if b < 0:
            continue
        part = fm.flat_plain(torch.full((e - f,), b, dtype=torch.int32),
                             vcr[f:e], r8, feat, start, scene, CS, TR)
        lanes = slice(b * TR, (b + 1) * TR)
        got = (part[0, lanes] != rows0[0, lanes]) | (
            part[5, lanes] != rows0[5, lanes])
        key = (part[0, lanes].view(torch.int32).to(torch.int64) << 32) | (
            part[5, lanes].view(torch.int32).to(torch.int64))
        best[lanes] = torch.minimum(best[lanes],
                                    torch.where(got, key, never))
        pend[lanes] |= part[6, lanes] > 0
    moved = best != never
    t = (best >> 32).to(torch.int32).view(torch.float32)
    g = (best & 0xFFFFFFFF).to(torch.int32).view(torch.float32)
    out = rows0.clone()
    out[0] = torch.where(moved, t, rows0[0])
    out[5] = torch.where(moved, g, rows0[5])
    rows = scene.tric[torch.where(moved, g, 0.0).long()]
    for j, col in ((1, 0), (2, 1), (3, 2), (4, 16)):
        out[j] = torch.where(moved, rows[:, col] + 0.0, rows0[j])
    out[6] = torch.where(pend, 1.0, rows0[6])
    return out


@pytest.mark.parametrize("chunk", [1, 3])
@pytest.mark.parametrize("tie", [False, True])
def test_chunked_k19_equals_flat_plain_and_interpret_mode(chunk, tie):
    """K19's chunked schedule, emulated on the plain visits, equals
    flat_plain bit for bit and interpret-mode `_run_flat` on the blocks
    the JAX kernel flushes; with tie=True the start rows of the lanes
    round 1 improves carry round 1's own (t, g) with other attributes,
    so a visit only ties them and nothing may be refetched."""
    jsc, _, c = jmk.build_march_scene(jlib.stress_scene(1200).tris, CS)
    psc, _, _ = mk.build_march_scene(library.stress_scene(1200).tris, CS)
    r8 = aimed_rays(768, 3, jlib.stress_scene(1200).tris)
    pr8 = torch.as_tensor(r8)
    feat = plucker_feat(pr8)
    ent, need = mk._slab_entries(pr8, psc, torch.full((768,), BIG))
    cl = mk._block_lists(ent, need, TR, 1)
    rows0 = mk.run_march(cl, pr8, feat, psc, CS, 1, TR)
    bu = mk._need(ent, rows0[0]).view(c, -1, TR).any(dim=2) & ~mk._visited_from(
        cl, c, 1)
    vb, vc, _, _ = fm._build_visit_list(bu, 4096)
    assert int((vc >= 0).sum()) > 3 * chunk
    if tie:
        first = fm.flat_plain(vb, vc, pr8, feat, rows0, psc, CS, TR)
        moved = (first[0] != rows0[0]) | (first[5] != rows0[5])
        assert int(moved.sum()) > 10
        rows0 = rows0.clone()
        rows0[0] = torch.where(moved, first[0], rows0[0])
        rows0[5] = torch.where(moved, first[5], rows0[5])
        for j, mark in zip(range(1, 5), (0.5, -0.25, 0.125, 9.0)):
            rows0[j] = torch.where(moved, mark, rows0[j])
    got = _chunked_flat(vb, vc, pr8, feat, rows0, psc, chunk)
    want = fm.flat_plain(vb, vc, pr8, feat, rows0, psc, CS, TR)
    np.testing.assert_array_equal(bits(got), bits(want))
    if tie:
        assert torch.equal(got[1:6, moved], rows0[1:6, moved])
    else:
        assert bool((got[0] < rows0[0]).any())
    jw = jfm._run_flat(jnp.asarray(vb.numpy()), jnp.asarray(vc.numpy()),
                       jnp.asarray(r8), jfeat(jnp.asarray(r8)),
                       tuple(jnp.asarray(rows0[k:k + 1].numpy())
                             for k in range(7)), CS, TR, True, scene=jsc)
    flushed = torch.isin(torch.arange(768 // TR), vb.long()).repeat_interleave(
        TR).numpy()
    for k in range(7):
        np.testing.assert_array_equal(bits(got[k])[flushed],
                                      bits(jw[k][0])[flushed],
                                      err_msg=f"row {k}")


def test_run_flat_checks_its_list_and_keeps_check_entries_off_the_cpu():
    """run_flat raises on a list its kernel does not take (block ids not
    non-decreasing or past the lanes' blocks, clusters past C), on either
    device; its first kernel and its counting entry run on CUDA tensors
    only."""
    psc, _, c = mk.build_march_scene(library.stress_scene(1200).tris, CS)
    pr8 = torch.as_tensor(aimed_rays(256, 4, jlib.stress_scene(1200).tris))
    feat = plucker_feat(pr8)
    rows0 = mk.miss_rows(256, "cpu")
    i32 = torch.int32
    good = (torch.tensor([0, 0, 1], dtype=i32), torch.tensor([1, -1, -1],
                                                            dtype=i32))
    fm.run_flat(*good, pr8, feat, rows0, psc, CS, TR)
    for vb, vc in ((torch.tensor([1, 0], dtype=i32), good[1][:2]),
                   (torch.tensor([0, 2], dtype=i32), good[1][:2]),
                   (good[0], torch.tensor([c, -1, -1], dtype=i32))):
        with pytest.raises(ValueError, match="non-decreasing"):
            fm.run_flat(vb, vc, pr8, feat, rows0, psc, CS, TR)
    for fn in (fm.run_flat_simt, fm.run_flat_counted):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            fn(*good, pr8, feat, rows0, psc, CS, TR)
