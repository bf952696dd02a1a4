"""K13a's tensor-core kernel (csrc/plucker_cand.cu), its rules on the CPU.

The kernel takes the edge values E_k from the tensor cores and decides
with them only outside K18's certified margin delta_k = 2^-14 S_k + d0
(S_k = sum_q |w_kq| F_q, F_q the largest |feature q| over a CUDA block of
128 lanes, d0 = 2^-110 + 2^-126 sum_q F_q, all rounded up). K13a's
eps_k is per triangle, so its filter needs no sign: with
T_k = RU(eps_k + delta_k), a position with some E_k > T_k and some
E_j < -T_j (all three finite) fails whatever the sign of vn; the rest
take the exact pass, where each edge is decided from u = s E_k + eps_k
outside [-delta_k, delta_k] or by the float32 chain. These tests check,
on the Plucker packs of the Cornell box, the reference scene and a small
stress scene, with grazing lanes and lanes of extreme features:

* the chain lies within a quarter of delta_k of the exact sum;
* the filter and the band rule, fed the chain's E perturbed by anything
  up to delta_k / 2, never contradict the chain's decisions;
* an emulation of the kernel's top two (per thread, its positions in
  ascending index with the strict <, then the quad merged in (t, index)
  order, the fill fixed where a t above BIG was accepted, then chunks
  merged in order) equals candidates_plain's per-chunk pair and output,
  the (BIG, first index of the chunk) fill included, also on a pack with
  repeated triangles (exact t ties) and on tests/minarg_rays.py's
  adversarial batch (zero directions accept t = inf);
* the padding rows never accept, a chunk made only of them leaves the
  running pair as it is where the last live chunk holds padding too, and the kernel's scan, which
  stops at the live triangle count, gives candidates_plain's output on
  the full pack; also where the live count ends a chunk, whole chunks of
  padding follow and every live row accepts t above BIG, so that the
  first padding chunk's (BIG, first index) fill wins the merge.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from march_lanes import grazing_rays
from minarg_rays import adversarial_rays, planes, t_above_big_rays
from opencl_path_tracer_tpu_torch.ops.kernels import plucker_kernel as k2
from opencl_path_tracer_tpu_torch.ops.kernels.intersect_kernel import (
    BIG, _dot3,
)
from opencl_path_tracer_tpu_torch.scene import library
from test_torch_march_margin import FLT_MAX, W, band, chain, margin, up32

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

MODELS = str(pathlib.Path(__file__).resolve().parent / "assets" / "models")
LANES = 128     # lanes per CUDA block of the kernel
CHUNK = 256


def _tris(name):
    if name == "cornell":
        return library.cornell_box(with_spheres=True).tris
    if name == "reference":
        return library.reference_scene(MODELS, smooth=True).tris
    return library.stress_scene(1200).tris


def _lanes(tris, kind, seed, n=512):
    """(8, n) rays: grazing (tests/march_lanes.py), or extreme: origins up
    to 1e5 away, unnormalised directions from 1e-6 to 1e3 with some zero
    and some tiny components (so some features are subnormal)."""
    if kind == "grazing":
        return torch.as_tensor(grazing_rays(tris, n, seed))
    rs = np.random.default_rng(seed)
    p = rs.uniform(-1, 1, (3, n)) * 10.0 ** rs.uniform(0, 5, (1, n))
    d = rs.normal(size=(3, n)) * 10.0 ** rs.uniform(-6, 3, (1, n))
    d[rs.random((3, n)) < 0.1] = 0.0
    d[:, :LANES:17] *= 1e-33      # the first block's margin is infinite
    r8 = np.zeros((8, n), np.float32)
    r8[0:3], r8[3:6] = p, d
    return torch.as_tensor(r8)


def _weights(trig, tpad):
    """The (tpad, 18) float32 weight rows of each edge."""
    j = torch.arange(tpad)
    base = (j // CHUNK) * (3 * CHUNK) + j % CHUNK
    return [trig[base + k * CHUNK, :W].float() for k in range(3)]


def _block_fq(f):
    """F_q of a block's features f (L, 18): the largest |f_q|, infinite
    where a feature is subnormal or not finite (the kernel's atomicMax)."""
    a = f.abs()
    outside = ~torch.isfinite(f) | ((a > 0) & (a < 2.0 ** -126))
    return torch.where(outside.any(0), float("inf"), a.amax(0))


@pytest.mark.parametrize("name", ["cornell", "reference", "stress"])
@pytest.mark.parametrize("kind", ["grazing", "extreme"])
def test_chain_within_a_quarter_of_the_margin(name, kind):
    tris = _tris(name)
    trig, tric, tpad = k2.build_plucker_packs(tris)
    w = [x[:tris.count].numpy() for x in _weights(trig, tpad)]
    rays = _lanes(tris, kind, 3)
    f = k2.plucker_feat(rays)[:W].float().T                  # (L, 18)
    if kind == "extreme":
        assert bool(torch.isinf(_block_fq(f[:LANES])).any())
    for b in range(0, f.shape[0], LANES):
        fb = f[b:b + LANES]
        fq = _block_fq(fb).numpy()
        for k in range(3):
            with np.errstate(invalid="ignore"):   # 0 x inf: no margin
                delta = margin(w[k], fq[None, :]).astype(np.float64)[:, None]
            exact = w[k].astype(np.float64) @ fb.numpy().astype(
                np.float64).T                                # (T, L)
            for fused in (True, False):
                e = chain(torch.as_tensor(w[k])[:, None, :], fb[None],
                          fused).numpy().astype(np.float64)
                fin = np.isfinite(delta) & np.ones_like(exact, bool)
                err = np.abs(e - exact)
                assert (err[fin] <= delta[np.nonzero(fin)[0], 0] / 4).all()


def _rules(e, eps, delta, pos):
    """The kernel's decisions from edge values e (3 of (T, L)): per edge
    (certain pass, certain fail) by the band rule, and the filter's
    certain fail of the position."""
    per_edge = [band(e[k], eps[k], delta[k], pos) for k in range(3)]
    thr = [torch.as_tensor(up32(eps[k].double().numpy()
                                + delta[k].double().numpy()))
           for k in range(3)]
    above = (e[0] > thr[0]) | (e[1] > thr[1]) | (e[2] > thr[2])
    below = (e[0] < -thr[0]) | (e[1] < -thr[1]) | (e[2] < -thr[2])
    fin = torch.maximum(torch.maximum(e[0].abs(), e[1].abs()),
                        e[2].abs()) <= FLT_MAX
    return per_edge, above & below & fin


@pytest.mark.parametrize("name", ["cornell", "reference", "stress"])
@pytest.mark.parametrize("kind", ["grazing", "extreme"])
def test_filter_and_band_reproduce_the_chain(name, kind):
    tris = _tris(name)
    trig, tric, tpad = k2.build_plucker_packs(tris)
    t = tris.count
    w = [x[:t] for x in _weights(trig, tpad)]
    eps = [tric[:t, 4 + k, None] for k in range(3)]
    nrm = tuple(tric[:t, k, None] for k in range(3))
    rays = _lanes(tris, kind, 4)
    f = k2.plucker_feat(rays)[:W].float().T
    rs = np.random.default_rng(9)
    tests = uncertain = kept = 0
    for b in range(0, f.shape[0], LANES):
        fb = f[b:b + LANES]
        d = tuple(rays[k, b:b + LANES][None, :] for k in range(3, 6))
        pos = _dot3(nrm, d) > 0.0
        fq = _block_fq(fb).numpy()
        e = [chain(w[k][:, None, :], fb[None]) for k in range(3)]
        acc = [torch.where(pos, e[k] >= -eps[k], e[k] <= eps[k])
               for k in range(3)]
        valid = acc[0] & acc[1] & acc[2]
        with np.errstate(invalid="ignore"):       # 0 x inf: no margin
            delta = [torch.as_tensor(margin(w[k].numpy(), fq[None, :]))[
                :, None] for k in range(3)]
        for xi in (-1.0, 1.0, None):
            e2 = [(e[k].double() + (torch.as_tensor(rs.uniform(
                -1, 1, e[k].shape)) if xi is None else xi)
                * torch.where(torch.isfinite(delta[k]), delta[k], 0.0
                              ).double() / 2).float() for k in range(3)]
            per_edge, fail = _rules(e2, eps, delta, pos)
            for k, (ok, bad) in enumerate(per_edge):
                assert not (ok & ~acc[k]).any() and not (bad & acc[k]).any()
            assert not (fail & valid).any()
        per_edge, fail = _rules(e, eps, delta, pos)
        for ok, bad in per_edge:
            uncertain += int((~ok & ~bad).sum())
        kept += int((~fail).sum())
        tests += e[0].numel()
    assert tests > 0 and kept < tests
    if kind == "grazing":
        assert uncertain > 0 and uncertain < 3 * tests * 0.05


def tm_plain(rays8, trig, tric):
    """candidates_plain's accepted t per (triangle, lane), BIG where a
    test fails: (tpad, R)."""
    tpad = tric.shape[0]
    w = _weights(trig, tpad)
    col = [tric[:, k:k + 1] for k in range(8)]
    feat = k2.plucker_feat(rays8)[:W].float()
    e = []
    for k in range(3):
        acc = [w[k][:, 0:1] * feat[0], w[k][:, 1:2] * feat[1]]
        for q in range(2, W):
            acc[q % 2] = acc[q % 2] + w[k][:, q:q + 1] * feat[q]
        e.append(acc[0] + acc[1])
    p = (rays8[0:1], rays8[1:2], rays8[2:3])
    d = (rays8[3:4], rays8[4:5], rays8[5:6])
    nrm = (col[0], col[1], col[2])
    vn = _dot3(nrm, d)
    t = (col[3] - _dot3(nrm, p)) / vn
    pos = vn > 0.0
    va = (e[0] >= -col[4]) & (e[1] >= -col[5]) & (e[2] >= -col[6])
    vb = (e[0] <= col[4]) & (e[1] <= col[5]) & (e[2] <= col[6])
    valid = ((pos & va) | (~pos & vb)) & (t > 0.0)
    return torch.where(valid, t, torch.full_like(t, BIG))


def _lex_less(t, a, s, b):
    return (t < s) | ((t == s) & (a < b))


def _merge_top2(x, o):
    """march_mma.cuh's merge_top2: x's list merged with o's, (t, index)
    order; lists are (m1, a1, m2, a2) of (R,) tensors."""
    m1, a1, m2, a2 = x
    o1, b1, o2, b2 = o
    first = _lex_less(o1, b1, m1, a1)
    keep1 = _lex_less(m1, a1, o2, b2)
    sec = _lex_less(o1, b1, m2, a2)
    n2 = torch.where(first, torch.where(keep1, m1, o2),
                     torch.where(sec, o1, m2))
    na2 = torch.where(first, torch.where(keep1, a1, b2),
                      torch.where(sec, b1, a2))
    return (torch.where(first, o1, m1), torch.where(first, b1, a1), n2, na2)


def kernel_pairs(tm, live):
    """The kernel's schedule over tm (tpad, R): per chunk below `live`,
    the four threads of a quad scan their positions 8 nt + 2 tig + cc (n
    tiles up to the one holding row live - 1) in ascending index with the
    strict <, keeping the two least t below BIG, the first position not
    accepted beyond BIG and the least (t, index) beyond it; the quad
    merges them, the fill is fixed (fix_fill), and chunks merge in order;
    where `live` ends a chunk below tpad, the first padding chunk's pair
    (BIG, live) twice is merged last. Returns the per-chunk pairs and the
    (4, R) output."""
    r = tm.shape[1]
    big = torch.full((r,), BIG)
    none = torch.full((r,), float(2 ** 31))
    pairs, run = [], (big, torch.zeros(r), big, torch.zeros(r))
    for cbase in range(0, live, CHUNK):
        cend = min(cbase + CHUNK, live)
        ntiles = -(-(cend - cbase) // 8)
        send = cbase + 8 * ntiles
        quad, fns, cms = [], [], []
        for tig in range(4):
            c = torch.full((r,), float(cbase))
            m1, a1, m2, a2 = big.clone(), c.clone(), big.clone(), c.clone()
            fn, cm, cg = none.clone(), none.clone(), none.clone()
            for nt in range(ntiles):
                for cc in range(2):
                    j = cbase + 8 * nt + 2 * tig + cc
                    t = tm[j]
                    beyond = t > BIG
                    lt1, lt2 = (t < m1) & ~beyond, (t < m2) & ~beyond
                    m2 = torch.where(lt1, m1, torch.where(lt2, t, m2))
                    a2 = torch.where(lt1, a1, torch.where(lt2, float(j), a2))
                    m1 = torch.where(lt1, t, m1)
                    a1 = torch.where(lt1, float(j), a1)
                    fn = torch.where((fn == none) & ~beyond, float(j), fn)
                    lower = beyond & ((cg == none) | (t < cm))
                    cm = torch.where(lower, t, cm)
                    cg = torch.where(lower, float(j), cg)
            quad.append((m1, a1, m2, a2))
            fns.append(fn)
            cms.append((cm, cg))
        quad = [_merge_top2(quad[i], quad[i ^ 1]) for i in range(4)]
        quad = [_merge_top2(quad[i], quad[i ^ 2]) for i in range(4)]
        for x in quad[1:]:
            assert all(torch.equal(u, v) for u, v in zip(quad[0], x))
        m1, a1, m2, a2 = quad[0]
        f = torch.minimum(torch.minimum(fns[0], fns[1]),
                          torch.minimum(fns[2], fns[3]))
        if send < cbase + CHUNK:
            f = torch.minimum(f, torch.full((r,), float(send)))
        cm, cg = cms[0]
        for x, y in cms[1:]:
            lower = _lex_less(x, y, cm, cg)
            cm, cg = torch.where(lower, x, cm), torch.where(lower, y, cg)
        has = f < none
        loc = (torch.where(has, m1, cm),
               torch.where(has, torch.where(m1 >= BIG, f, a1), cg),
               torch.where(has, m2, big),
               torch.where(has, torch.where(m2 >= BIG, f, a2), cg))
        pairs.append(loc)
        run = loc if cbase == 0 else k2._merge_top2(run, loc)
    if live % CHUNK == 0 and live < tm.shape[0]:
        fill = torch.full((r,), float(live))
        run = k2._merge_top2(run, (big, fill, big, fill))
    return pairs, torch.stack(run)


def plain_pairs(tm):
    """candidates_plain's per-chunk pairs, from tm."""
    nch = tm.shape[0] // CHUNK
    v = tm.view(nch, CHUNK, -1)
    m1, i1 = torch.min(v, dim=1)
    m2, i2 = torch.min(v.scatter(1, i1[:, None], BIG), dim=1)
    c = (torch.arange(nch) * CHUNK)[:, None]
    return [(m1[k], (c[k] + i1[k]).float(), m2[k], (c[k] + i2[k]).float())
            for k in range(nch)]


def _repeated(tris, k=200):
    """The triangles followed by their first k again (exact t ties)."""
    return type(tris)(**{f.name: torch.cat([getattr(tris, f.name),
                                            getattr(tris, f.name)[:k]])
                         for f in dataclasses.fields(tris)})


@pytest.mark.parametrize("name", ["cornell", "cornell-repeated", "stress"])
def test_top_two_schedule_equals_candidates_plain(name):
    tris = _tris(name.split("-")[0])
    if name.endswith("repeated"):
        tris = _repeated(tris)
    trig, tric, tpad = k2.build_plucker_packs(tris)
    rays = torch.cat([_lanes(tris, "grazing", 5, 384),
                      _lanes(tris, "extreme", 6, 128),
                      torch.as_tensor(adversarial_rays(tris, 256, 6))], 1)
    tm = tm_plain(rays, trig, tric)
    # Accepted t above BIG (zero directions: t = inf) change the fill.
    assert bool((tm[:, 384:] > BIG).any())
    plain = k2.candidates_plain(rays, trig, tric)
    pp = plain_pairs(tm)
    # The emulation over every row, then stopping at the live count.
    for live in (tpad, tris.count):
        pairs, out = kernel_pairs(tm, live)
        assert torch.equal(out, plain)
        for a, b in zip(pairs, pp):
            assert all(torch.equal(u, v) for u, v in zip(a, b))
    accepts = (tm < BIG).sum(0)
    assert bool((accepts == 0).any()) and bool((accepts == 1).any())
    assert bool((accepts >= 2).any())
    # A chunk with fewer than two accepts fills (BIG, its first index),
    # unless it accepted a t above BIG.
    moved = 0
    for k, (m1, a1, m2, a2) in enumerate(pp):
        above = (tm[k * CHUNK:(k + 1) * CHUNK] > BIG).any(0)
        few = m2 >= BIG
        assert bool((a2[few & ~above] == k * CHUNK).all())
        moved += int((a2[few & above] != k * CHUNK).sum())
    assert moved > 0
    if name.endswith("repeated"):
        ties = (plain[0] == plain[2]) & (plain[0] < BIG)
        assert bool(ties.any())
        assert bool((plain[1][ties] < plain[3][ties]).all())


@pytest.mark.parametrize("name", ["cornell", "cornell-1104"])
def test_padding_rows_never_accept(name):
    """cornell: 804 triangles in 1,024 rows; cornell-1104 (its first 300
    repeated): 1,104 in 2,048, so the last three chunks are padding."""
    tris = _tris("cornell")
    if name == "cornell-1104":
        tris = _repeated(tris, 300)
    trig, tric, tpad = k2.build_plucker_packs(tris)
    t = tris.count
    assert tpad > t
    rays = torch.cat([_lanes(tris, "grazing", 7, 256),
                      _lanes(tris, "extreme", 8, 128)], 1)
    tm = tm_plain(rays, trig, tric)
    assert bool((tm[t:] == BIG).all())
    assert bool((tric[t:, :4] == 0).all()) and bool(
        (trig.view(tpad // CHUNK, 3, CHUNK, 32)
         .float().permute(0, 2, 1, 3).reshape(tpad, 3, 32)[t:] == 0).all())
    # A chunk of padding rows alone leaves the running pair reached so far
    # as it is where the last live chunk holds padding rows too (as here):
    # that chunk's fill already carries a lower index, so the padding
    # chunk's BIG entries never enter the pair, even on lanes that accept
    # t above BIG. test_padding_chunk_after_t_above_big covers the case
    # where the live count ends a chunk.
    assert t % CHUNK != 0 and bool((tm > BIG).any())
    pp = plain_pairs(tm)
    run = pp[0]
    for k in range(1, len(pp)):
        if k * CHUNK >= t:
            r = tm.shape[1]
            fill = (torch.full((r,), BIG), torch.full((r,), float(k * CHUNK)),
                    torch.full((r,), BIG), torch.full((r,), float(k * CHUNK)))
            assert all(torch.equal(a, b) for a, b in zip(pp[k], fill))
            assert all(torch.equal(a, b) for a, b in
                       zip(k2._merge_top2(run, pp[k]), run))
        run = k2._merge_top2(run, pp[k])
    if name == "cornell-1104":
        assert tpad - t > 3 * CHUNK      # whole chunks of padding
    out = kernel_pairs(tm, t)[1]
    assert torch.equal(out, k2.candidates_plain(rays, trig, tric))


@pytest.mark.parametrize("count", [1280, 1792])
def test_padding_chunk_after_t_above_big(count):
    """1,280 (or 1,792) triangles fill whole chunks and are padded to
    2,048 rows. On lanes that accept t above BIG on every live row the
    live chunks give (inf, i) pairs, and candidates_plain's first chunk
    of padding, (BIG, count) twice, wins the merge; the kernel's scan
    stops at the count and merges that fill once after it."""
    tris = planes(count)
    trig, tric, tpad = k2.build_plucker_packs(tris)
    assert count % CHUNK == 0 and tpad - count >= CHUNK
    rays = torch.cat([t_above_big_rays(96), _lanes(tris, "extreme", 13, 160),
                      torch.as_tensor(adversarial_rays(tris, 128, 14))], 1)
    tm = tm_plain(rays, trig, tric)
    assert bool((tm[:count, :96] > BIG).all())
    assert bool((tm[count:] == BIG).all())
    plain = k2.candidates_plain(rays, trig, tric)
    fill = torch.tensor([BIG, float(count), BIG, float(count)])[:, None]
    assert torch.equal(plain[:, :96], fill.expand(4, 96))
    assert bool((plain[0, 96:] < BIG).any())
    pairs, out = kernel_pairs(tm, count)
    assert torch.equal(out, plain)
    # Without the fill merged after the scan the lanes would keep (inf, 0).
    run = pairs[0]
    for x in pairs[1:]:
        run = k2._merge_top2(run, x)
    assert bool((run[0][:96] > BIG).all())
