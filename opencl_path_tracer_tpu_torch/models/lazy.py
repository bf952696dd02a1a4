"""Lazy-certification wavefront: the nearest-hit search of each lane
spread over steps (the large-scene model).

Port of `opencl_path_tracer_tpu/models/lazy.py`: `LazyState`,
`init_lazy`, `_sort_lanes` and `make_lazy_pipeline`.

The estimator is the wavefront model's, the schedule differs. Every lane
carries, besides its path state, its search: the best hit rows so far
(mt, mnx, mny, mnz, mm, mg; mt = BIG before any) and a visited-cluster
bitmask. Each step sorts the lanes by (direction octant, origin Morton
cell), stably, every per-lane field with them; each block of tr lanes
visits its K nearest clusters some lane still needs (K20,
`ops/kernels/lazy_march.py`); lanes a visit left pending get K4 over the
reordered triangles, `tail` lanes per iteration with one host read each,
and their mask filled. A lane is certified when no unvisited cluster's
box entry is below its best t; certified lanes (below max_samples) shade,
bounce, fold and start a new search; the rest stall, drawing nothing, so
in parity mode each pixel's colors at equal sample counts are the eager
wavefront's bit for bit. `completions` counts the certified segments, a
device counter (uint32 in the JAX package).

The port holds the mask as one (CW, N) int32 tensor of uint32 bits (the
JAX package: a tuple of CW (N,) uint32 arrays; `interop` converts) and
the step counter on the host, as `WavefrontState` does. The material
fetch is `MaterialsSoA.take` (the JAX package's `take_select` is a
where-chain of the same values, a TPU speed choice).
"""

from __future__ import annotations

import dataclasses

import torch

from opencl_path_tracer_tpu_torch.core.camera import Camera
from opencl_path_tracer_tpu_torch.core.geometry import TrianglesSoA
from opencl_path_tracer_tpu_torch.core.materials import MaterialsSoA
from opencl_path_tracer_tpu_torch.core.types import Hits, Rays, V3, vadd, vwhere
from opencl_path_tracer_tpu_torch.models import wavefront
from opencl_path_tracer_tpu_torch.models.megakernel import (
    _draws_parity, apply_factors, shade,
)
from opencl_path_tracer_tpu_torch.ops import raygen, rng
from opencl_path_tracer_tpu_torch.ops.kernels import march_kernel as mk
from opencl_path_tracer_tpu_torch.ops.kernels.intersect_kernel import (
    BIG, make_pallas_intersect,
)
from opencl_path_tracer_tpu_torch.ops.kernels.lazy_march import (
    run_lazy_march, unvisited_mask,
)
from opencl_path_tracer_tpu_torch.ops.kernels.plucker_kernel import (
    plucker_feat,
)
from opencl_path_tracer_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class LazyState:
    """WavefrontState's fields of the JAX LazyState plus the carried
    search. V3 fields are tuples of (N,) float32 tensors."""

    colors: V3
    samples: torch.Tensor      # (N,) int32
    pixel: torch.Tensor        # (N,) int32
    rng_state: torch.Tensor    # (N,) int64 Lehmer states (parity)
    ray_p: V3
    ray_d: V3
    f_l: V3
    f_b: V3
    f_s: V3
    f_r: V3
    cur_color: V3
    inside: torch.Tensor       # (N,) bool
    bounce: torch.Tensor       # (N,) int32
    step: int                  # global step counter (fast draws)
    mt: torch.Tensor           # (N,) float32 best t so far (BIG: none)
    mnx: torch.Tensor
    mny: torch.Tensor
    mnz: torch.Tensor
    mm: torch.Tensor           # mati as float32
    mg: torch.Tensor           # cluster-ordered triangle id (tie-break)
    vis: torch.Tensor          # (CW, N) int32 visited bits
    completions: torch.Tensor  # () int64 certified segments

    def replace(self, **kw) -> "LazyState":
        return dataclasses.replace(self, **kw)


def init_lazy(cam: Camera, num_pixels: int, C: int, *, seed: int = 1,
              mode: str = "parity", key=None,
              ids: torch.Tensor | None = None) -> LazyState:
    """A fresh state on the camera's device for a scene of C clusters."""
    wf = wavefront.init_wavefront(cam, num_pixels, seed=seed, mode=mode,
                                  key=key, ids=ids)
    n = num_pixels
    dev = cam.eye.device
    z = torch.zeros(n, dtype=torch.float32, device=dev)
    return LazyState(
        colors=wf.colors, samples=wf.samples, pixel=wf.pixel,
        rng_state=wf.rng_state, ray_p=wf.ray_p, ray_d=wf.ray_d, f_l=wf.f_l,
        f_b=wf.f_b, f_s=wf.f_s, f_r=wf.f_r, cur_color=wf.cur_color,
        inside=wf.inside, bounce=wf.bounce, step=wf.step,
        mt=torch.full((n,), BIG, dtype=torch.float32, device=dev),
        mnx=z, mny=z.clone(), mnz=z.clone(), mm=z.clone(), mg=z.clone(),
        vis=torch.zeros((-(-C // 32), n), dtype=torch.int32, device=dev),
        completions=torch.zeros((), dtype=torch.int64, device=dev),
    )


def _sort_lanes(st: LazyState, scene: mk.MarchScene) -> LazyState:
    """Every per-lane field in (direction octant, origin Morton) order,
    stable by key (the JAX package's (key, iota) sort)."""
    order = torch.sort(mk.lane_key(st.ray_p, st.ray_d, scene),
                       stable=True).indices
    kw = {}
    for f in dataclasses.fields(LazyState):
        v = getattr(st, f.name)
        if isinstance(v, tuple):
            kw[f.name] = tuple(c[order] for c in v)
        elif f.name == "vis":
            kw[f.name] = v[:, order]
        elif isinstance(v, torch.Tensor) and v.dim() == 1:
            kw[f.name] = v[order]
    return st.replace(**kw)


def make_lazy_pipeline(tris: TrianglesSoA, *, cs: int = 512, tr: int = 256,
                       K: int = 4, tail: int = 4096, device=None):
    """(step, init, reordered triangles) for a scene on `device` (CUDA
    unless "cpu" is asked for; raises without a GPU).

    step(cam, mats, st, *, iterations, mode='fast', key=None,
    max_samples=None) -> st'; init(cam, num_pixels, **kw) -> st. Hits
    folded into samples equal K4's over the reordered triangles."""
    dev = resolve_device(device)
    scene, rt, c = mk.build_march_scene(tris.to(dev), cs)
    tail_isect = make_pallas_intersect(rt)

    def step(cam: Camera, mats: MaterialsSoA, st: LazyState, *,
             iterations: int, mode: str = "fast", key=None,
             max_samples: int | None = None) -> LazyState:
        n = st.samples.shape[0]
        if n % tr:
            raise ValueError(f"the lazy pipeline needs lanes in whole "
                             f"blocks of {tr}; got {n}")
        st = _sort_lanes(st, scene)
        rays8 = torch.stack([*st.ray_p, *st.ray_d,
                             torch.zeros_like(st.mt), torch.zeros_like(st.mt)])
        feat = plucker_feat(rays8)

        # March the K block-nearest clusters still needed (K20).
        ent, _ = mk._slab_entries(rays8, scene, torch.full_like(st.mt, BIG))
        need1 = (ent < BIG) & mk._need(ent, st.mt) & unvisited_mask(st.vis, c)
        clist = mk._block_lists(ent, need1, tr, K)
        del need1
        rows_in = torch.stack([st.mt, st.mnx, st.mny, st.mnz, st.mm, st.mg])
        outs, vis = run_lazy_march(clist, rays8, feat, rows_in, st.vis, scene,
                                   cs, K, tr)
        rows = list(outs[:6])
        pend = outs[6] > 0.0

        # The dense net: pending lanes get K4 now (a re-visit would pend
        # again), and every cluster counts as visited for them.
        u4 = min(tail, n)
        while bool(pend.any()):
            idx = torch.argsort((~pend).to(torch.int32), stable=True)[:u4]
            ht = tail_isect(Rays(p=tuple(rays8[k][idx] for k in range(3)),
                                 d=tuple(rays8[k][idx] for k in range(3, 6))))
            newt = torch.where(ht.valid, ht.t, torch.full_like(ht.t, BIG))
            news = (newt, ht.n[0], ht.n[1], ht.n[2],
                    ht.mati.to(torch.float32), torch.zeros_like(newt))
            for r_, s_ in zip(rows, news):
                r_[idx] = s_
            vis[:, idx] = -1
            pend[idx] = False
        mt, mnx, mny, mnz, mm, mg = rows

        # The certificate: no unvisited cluster can beat mt.
        certified = ~((ent < BIG) & mk._need(ent, mt)
                      & unvisited_mask(vis, c)).any(dim=0)
        del ent
        active = (certified if max_samples is None
                  else certified & (st.samples < max_samples))

        # Shade, bounce and fold the active lanes (the eager wavefront's
        # body, gated by `active`).
        has_hit = active & (mt < BIG)
        found = mt < BIG
        safe_t = torch.where(found, mt, torch.zeros_like(mt))
        hit = Hits(
            t=torch.where(found, mt, torch.full_like(mt, -1.0)),
            p=tuple(st.ray_p[k] + st.ray_d[k] * safe_t for k in range(3)),
            n=(mnx, mny, mnz),
            mati=torch.where(found, mm, torch.zeros_like(mm)).to(torch.int32),
        )
        rng_state = st.rng_state
        mat = mats.take(hit.mati)
        mtype = mat.type
        is_d_or_e = has_hit & ((mtype == 0) | (mtype == 3))
        if mode == "parity":
            need_d = is_d_or_e | (has_hit & (mtype == 2))
            rng_state, r1, r2 = _draws_parity(rng_state, need_d, is_d_or_e)
        elif mode == "fast":
            u = rng.fast_uniforms(key, st.step, 0, n, 2, device=dev)
            r1, r2 = u[0], u[1]
        else:
            raise ValueError(f"unknown mode {mode!r}")
        s = shade(cam, mat, hit, st.ray_p, st.ray_d, st.inside, r1, r2,
                  has_hit)
        cur_color = st.cur_color
        if iterations == 1:  # preview (prog.cl:323-325)
            cur_color = vwhere(has_hit, vadd(s["mat"].kd, s["mat"].emission),
                               cur_color)
        f_l, f_b, f_s, f_r, inside, cur_color = apply_factors(
            s, st.f_l, st.f_b, st.f_s, st.f_r, st.inside, cur_color)

        bounce = torch.where(active, st.bounce + 1, st.bounce)
        terminated = active & (~found | (bounce >= iterations))
        s_f = st.samples.to(torch.float32)
        inv = 1.0 / (s_f + 1.0)
        colors = tuple(torch.where(terminated,
                                   (st.colors[k] * s_f + cur_color[k]) * inv,
                                   st.colors[k]) for k in range(3))
        samples = torch.where(terminated, st.samples + 1, st.samples)
        if mode == "parity":
            rng_state, g1, g2 = _draws_parity(rng_state, terminated,
                                              terminated)
        else:
            u = rng.fast_uniforms(key, st.step, 1, n, 2, device=dev)
            g1, g2 = u[0], u[1]
        fresh = raygen.camera_rays(cam, st.pixel, g1, g2)

        ones = tuple(torch.ones_like(s_f) for _ in range(3))
        zeros = tuple(torch.zeros_like(s_f) for _ in range(3))
        adv = active   # lanes that advanced a segment this step
        zf = torch.zeros_like(mt)
        return LazyState(
            colors=colors,
            samples=samples,
            pixel=st.pixel,
            rng_state=rng_state,
            ray_p=vwhere(terminated, fresh.p, vwhere(adv, s["new_p"],
                                                     st.ray_p)),
            ray_d=vwhere(terminated, fresh.d, vwhere(adv, s["new_d"],
                                                     st.ray_d)),
            f_l=vwhere(terminated, ones, vwhere(adv, f_l, st.f_l)),
            f_b=vwhere(terminated, ones, vwhere(adv, f_b, st.f_b)),
            f_s=vwhere(terminated, ones, vwhere(adv, f_s, st.f_s)),
            f_r=vwhere(terminated, ones, vwhere(adv, f_r, st.f_r)),
            cur_color=vwhere(terminated, zeros,
                             vwhere(adv, cur_color, st.cur_color)),
            inside=torch.where(terminated, False,
                               torch.where(adv, inside, st.inside)),
            bounce=torch.where(terminated, 0, torch.where(adv, bounce,
                                                          st.bounce)),
            step=st.step + 1,
            mt=torch.where(adv, torch.full_like(mt, BIG), mt),
            mnx=torch.where(adv, zf, mnx),
            mny=torch.where(adv, zf, mny),
            mnz=torch.where(adv, zf, mnz),
            mm=torch.where(adv, zf, mm),
            mg=torch.where(adv, zf, mg),
            vis=torch.where(adv[None, :], torch.zeros_like(vis), vis),
            completions=st.completions + adv.sum(),
        )

    def init(cam: Camera, num_pixels: int, **kw) -> LazyState:
        return init_lazy(cam, num_pixels, c, **kw)

    return step, init, rt
