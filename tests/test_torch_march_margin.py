"""The certified margin of K18's tensor-core edge tests, on the CPU
(`csrc/march_mma.cuh`).

K18 computes the edge values E_k on the tensor cores and decides an edge
test from them only when u = s E_mma + ep_k (s = +1 when vn > 0, else -1)
lies outside [-delta_k, delta_k], delta_k = 2^-14 S_k + d0 with
S_k = sum_q |w_kq| F_q (F_q the largest |f_q| over the CUDA block's
lanes) and d0 = 2^-110 + 2^-126 sum_q F_q, all rounded up; inside, it
recomputes E_k with the float32 chain (two accumulators, even and odd
terms) and compares as the chain does.
These tests check the two facts that make that exact:

* the chain is within a quarter of delta_k of the exact sum, for bf16
  weights and features over a wide exponent range (subnormal products
  included), in the kernel's order (fused multiply-adds) and in the plain
  version's (`pair_mxu._visit`: products, then adds);
* on stress_scene(1200) lanes (aimed at triangle corners, and grazing
  ones: at vertices, along edges, nearly in a triangle's plane) against
  the clusters their blocks visit, the band rule (this file's mirror of
  the kernel's) fed the chain's E perturbed by anything up to delta_k / 2
  reproduces the chain's per-edge accept flags, computed as
  `pair_mxu._visit` computes them; the grazing lanes put some tests in
  the band, so the chain's branch is exercised.
"""

import numpy as np
import pytest
import torch

from march_lanes import aimed_rays, grazing_rays
from opencl_path_tracer_tpu_torch.core import fp
from opencl_path_tracer_tpu_torch.ops.kernels import march_kernel as mk
from opencl_path_tracer_tpu_torch.ops.kernels.intersect_kernel import (
    BIG, _dot3, pack_rays,
)
from opencl_path_tracer_tpu_torch.ops.kernels.plucker_kernel import (
    _bf16_np, plucker_feat,
)
from opencl_path_tracer_tpu_torch.scene import library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

TINY = 2.0 ** -110
FLT_MAX = float(np.finfo(np.float32).max)
CS = TR = 128
K = 4
W = 18      # used weight and feature columns


def up32(x):
    """The least float32 >= x (float64 array)."""
    f = x.astype(np.float32)
    return np.where(f.astype(np.float64) < x,
                    np.nextafter(f, np.float32(np.inf)), f)


def margin(w, fq):
    """delta_k for weights w (..., 18) against column bounds fq (..., 18),
    rounded up as the kernel rounds it."""
    fq = fq.astype(np.float64)
    s = up32((np.abs(w.astype(np.float64)) * fq).sum(-1))
    d0 = up32(fq.sum(-1) * 2.0 ** -126 + TINY)
    return up32(s.astype(np.float64) * 2.0 ** -14 + d0)


def chain(w, f, fused=True):
    """The two-accumulator float32 chain over the last axis: the kernel's
    fused multiply-adds, or products then adds (the plain version)."""
    w, f = torch.as_tensor(w), torch.as_tensor(f)
    acc = [w[..., 0] * f[..., 0], w[..., 1] * f[..., 1]]
    for q in range(2, W):
        acc[q % 2] = (fp.fma(w[..., q], f[..., q], acc[q % 2]) if fused
                      else acc[q % 2] + w[..., q] * f[..., q])
    return acc[0] + acc[1]


def band(e, ep, delta, pos):
    """The kernel's rule: (certified pass, certified fail) per edge."""
    sg = torch.where(pos, 1.0, -1.0)
    u = fp.fma(sg, e, ep)
    fin = e.abs() <= FLT_MAX
    return fin & (u > delta), fin & (u < -delta)


def bf16_values(rs, shape, lo, hi):
    """Random bf16 values (as float32) of either sign with exponents in
    [lo, hi], a tenth of them zero."""
    m = rs.uniform(1.0, 2.0, shape) * rs.choice([-1.0, 1.0], shape)
    x = _bf16_np((m * 2.0 ** rs.integers(lo, hi + 1, shape)).astype(
        np.float32))
    x[rs.random(shape) < 0.1] = 0.0
    return x


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_chain_within_a_quarter_of_the_margin(seed):
    rs = np.random.default_rng(seed)
    n = 20_000
    w = bf16_values(rs, (n, W), -75, 50)
    f = bf16_values(rs, (n, W), -75, 50)
    exact = (w.astype(np.float64) * f.astype(np.float64)).sum(1)
    prods = np.abs(w.astype(np.float64) * f.astype(np.float64))
    assert (prods[prods > 0] < 2.0 ** -126).any()     # subnormal products
    delta = margin(w, np.abs(f)).astype(np.float64)
    for fused in (True, False):
        err = np.abs(chain(w, f, fused).numpy().astype(np.float64) - exact)
        assert (err <= delta / 4).all(), float((err / delta).max())


def lanes(kind, seed, tris):
    rays = (grazing_rays(tris, 1536, seed) if kind == "grazing"
            else aimed_rays(1536, seed, tris))
    return torch.as_tensor(rays)


@pytest.mark.parametrize("kind,seed", [("aimed", 0), ("aimed", 1),
                                       ("grazing", 0), ("grazing", 1)])
def test_band_rule_reproduces_the_chain(kind, seed):
    scene = library.stress_scene(1200)
    ms, _, _ = mk.build_march_scene(scene.tris, CS)
    rays = lanes(kind, seed, scene.tris)
    r8 = pack_rays(tuple(rays[k] for k in range(3)),
                   tuple(rays[k] for k in range(3, 6)), 1536)
    order = torch.sort(mk.lane_key(r8[0:3], r8[3:6], ms), stable=True).indices
    r8s = r8[:, order].contiguous()
    feat = plucker_feat(r8s)[:W].float()                      # (18, N)
    ent, need = mk._slab_entries(r8s, ms, torch.full((r8s.shape[1],), BIG))
    clist = mk._block_lists(ent, need, TR, K).view(-1, K)
    rs = np.random.default_rng(100 + seed)
    tests = uncertain = 0
    for b in range(clist.shape[0]):
        sl = slice(b * TR, (b + 1) * TR)
        p = tuple(r8s[k, sl][None, :] for k in range(3))      # (1, TR)
        d = tuple(r8s[k, sl][None, :] for k in range(3, 6))
        f = feat[:, sl].T[None, :, :]                         # (1, TR, 18)
        fq = f.abs().amax(1)                                  # (1, 18)
        ml = torch.maximum(torch.maximum(
            fp.fma(p[1], d[2], -(p[2] * d[1])).abs(),
            fp.fma(p[2], d[0], -(p[0] * d[2])).abs()),
            fp.fma(p[0], d[1], -(p[1] * d[0])).abs())
        for cid in clist[b].tolist():
            if cid < 0:
                continue
            tc = ms.tric[cid * CS:(cid + 1) * CS]                 # (CS, 24)
            nrm = tuple(tc[:, k, None] for k in range(3))
            pos = _dot3(nrm, d) > 0.0                             # (CS, TR)
            for k in range(3):
                rows = slice((3 * cid + k) * CS, (3 * cid + k + 1) * CS)
                w = ms.trig[rows, :W].float()[:, None, :]         # (CS, 1, 18)
                e = chain(w, f)                                   # (CS, TR)
                assert torch.equal(e, chain(w, f, fused=False))
                ep = fp.fma(tc[:, 17 + k, None], ml, tc[:, 20 + k, None])
                acc = torch.where(pos, e >= -ep, e <= ep)
                delta = torch.as_tensor(margin(w[:, 0].numpy(),
                                               fq.numpy()))[:, None]
                for xi in (-1.0, 1.0, None):
                    x = (torch.as_tensor(rs.uniform(-1, 1, e.shape))
                         if xi is None else xi)
                    e2 = (e.double() + x * delta.double() / 2).float()
                    ok, bad = band(e2, ep, delta, pos)
                    assert not (ok & ~acc).any() and not (bad & acc).any()
                ok, bad = band(e, ep, delta, pos)
                uncertain += int((~ok & ~bad).sum())
                tests += e.numel()
    assert tests > 0
    if kind == "grazing":
        assert uncertain > 0
    assert uncertain < tests * 0.05
