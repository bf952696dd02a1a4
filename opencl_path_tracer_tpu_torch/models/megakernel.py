"""Megakernel-style progressive path tracer (reference-parity model).

Port of `opencl_path_tracer_tpu/models/megakernel.py`: the trace_ray
megakernel (prog.cl:292-381) with gen_ray (prog.cl:384-389) over the
whole pixel batch. Every lane runs the bounce loop in lockstep with

  * an `alive` mask instead of break (a miss kills the lane,
    prog.cl:367-376),
  * a select over the four material branches (prog.cl:329-366),
  * conditional Lehmer steps, so that each lane's stream advances by
    exactly the reference's number of draws (2 for diffuse and emitter,
    1 for refractive, 0 for specular and miss).

The intersector is injected (`intersect_fn`); a Python loop runs the
samples and bounces. Next-event estimation (`nee`, an
`ops.nee.EmitterTable`) gathers direct light at every diffuse vertex
through one shadow ray (`occluded_fn`, the any-hit test, or the
intersector) and MIS-weights the next bounce's emitter pickup. `env` is
the reference's dormant sky light (`EnvLight`) or an environment map
(`ops.envmap.EnvMap`, whose gather traces an escape ray through the same
any-hit test at rmax 3.0e38); `dof` = (aperture, focus) makes thin-lens
camera rays. A textured intersector returns (Hits, kd): `fetch_material`
multiplies the fetched kd by it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from opencl_path_tracer_tpu_torch.core.camera import Camera
from opencl_path_tracer_tpu_torch.core.materials import MaterialsSoA
from opencl_path_tracer_tpu_torch.core.types import (
    Hits, Rays, V3, vadd, vdot, vmul, vneg, vnormalize, vscale, vwhere,
)
from opencl_path_tracer_tpu_torch.ops import bsdf, raygen, rng
from opencl_path_tracer_tpu_torch.ops import envmap as envmap_ops
from opencl_path_tracer_tpu_torch.ops import nee as nee_ops
from opencl_path_tracer_tpu_torch.utils import profiling
from opencl_path_tracer_tpu_torch.utils.device import resolve_device

IntersectFn = Callable[[Rays], Hits]
_INV_PI = float(np.float32(1.0 / np.pi))


def _unoccluded(rays, rmax):
    """A shadow-ray visibility that traces nothing: every ray visible."""
    return torch.zeros_like(rmax, dtype=torch.bool)


@dataclasses.dataclass(frozen=True)
class EnvLight:
    """The reference's dormant miss shading (prog.cl:367-376), an opt-in:
    a primary miss shows `sky` (prog.cl:369); a miss on a path with no
    diffuse bounce yet (cntr <= 0, prog.cl:370) tints `sky` by the path
    throughput (f_l + f_b) f_s f_r; a miss after a diffuse bounce adds
    `deep` (white in the dormant code, prog.cl:372) times the throughput.
    `scale` multiplies `sky` (the literal `*1` at prog.cl:369). env=None
    keeps the shipped kernel's plain break."""

    sky: tuple = (0.0, 0.75, 2.0)   # prog.cl:369,371
    deep: tuple = (1.0, 1.0, 1.0)   # prog.cl:373
    scale: float = 1.0              # prog.cl:369


def env_miss_update(env: EnvLight, miss_now, is_primary, had_diffuse,
                    f_l: V3, f_b: V3, f_s: V3, f_r: V3, color: V3) -> V3:
    """Fold the dormant code's miss contribution into `color` on the lanes
    whose live path missed this bounce (they die right after). is_primary:
    a bool (the megakernel's bounce 0) or a per-lane mask (the
    wavefront's); had_diffuse: the per-lane cntr > 0."""
    # float32 sky * scale, as the JAX package folds it.
    sky = tuple(float(np.float32(c) * np.float32(env.scale))
                for c in env.sky)
    deep = tuple(float(np.float32(c)) for c in env.deep)
    ref = f_l[0]
    tint = tuple(torch.where(had_diffuse, torch.full_like(ref, deep[k]),
                             torch.full_like(ref, sky[k]))
                 for k in range(3))
    # Left to right, as the reference's tint*(f_L+f_B)*f_S*f_R
    # (prog.cl:371,373).
    tinted = vmul(vmul(vmul(tint, vadd(f_l, f_b)), f_s), f_r)
    sky_v = tuple(torch.full_like(ref, sky[k]) for k in range(3))
    if isinstance(is_primary, bool):
        contrib = sky_v if is_primary else tinted
    else:
        contrib = vwhere(is_primary, sky_v, tinted)
    return vwhere(miss_now, vadd(color, contrib), color)


def _env_kind(env):
    """'map', 'light' or None for an env argument; raises for others."""
    if env is None:
        return None
    if isinstance(env, envmap_ops.EnvMap):
        return "map"
    if isinstance(env, EnvLight):
        return "light"
    raise TypeError(f"env must be an EnvLight or an ops.envmap.EnvMap, not "
                    f"{type(env).__name__}")


@dataclasses.dataclass
class TraceState:
    """Progressive state: the running average (colors, prog.cl:379), the
    per-pixel Lehmer states (int64 values < 2^31, main.cpp:522-527) and
    the sample counter (a host int)."""

    colors: V3
    rng_state: torch.Tensor
    sample: int


def init_state(num_pixels: int, seed: int = 1, device="cpu") -> TraceState:
    z = torch.zeros(num_pixels, dtype=torch.float32, device=device)
    return TraceState(
        colors=(z, z.clone(), z.clone()),
        rng_state=rng.seed_pixel_streams(num_pixels, seed, device=device),
        sample=0,
    )


def fetch_material(mats: MaterialsSoA, intersect_fn: IntersectFn,
                   rays: Rays):
    """Intersect + per-lane material fetch, shared by both models. An
    intersect_fn returns Hits, or (Hits, kd_scale) with kd_scale a V3 of
    per-lane diffuse multipliers (the textured intersector,
    `runtime.engine.make_intersect_fn(textured=True)`), by which the
    fetched kd is multiplied lane by lane."""
    with profiling.span("isect"):
        res = intersect_fn(rays)
    if isinstance(res, tuple):
        hit, kd_mod = res
        mat = mats.take(hit.mati)
        return hit, dataclasses.replace(mat, kd=vmul(mat.kd, kd_mod))
    return res, mats.take(res.mati)


def _draws_parity(state, need1, need2):
    """Advance each lane's Lehmer stream by 0, 1 or 2 steps."""
    s1, u1 = rng.lehmer_step(state)
    state1 = torch.where(need1, s1, state)
    s2, u2 = rng.lehmer_step(state1)
    return torch.where(need2, s2, state1), u1, u2


def shade(cam: Camera, mat: MaterialsSoA, hit: Hits, ray_p: V3, ray_d: V3,
          inside, r1, r2, has_hit) -> dict:
    """One bounce of the reference dispatch (prog.cl:326-366), every
    branch computed and selected."""
    mtype = mat.type
    # Flip the normal toward the incoming ray (prog.cl:326-328).
    n_vec = vwhere(vdot(ray_d, hit.n) > 0.0, vneg(hit.n), hit.n)
    is_diff = has_hit & (mtype == 0)
    is_spec = has_hit & (mtype == 1)
    is_refr = has_hit & (mtype == 2)
    is_emit = has_hit & (mtype == 3)

    diff_p, diff_d = bsdf.diffuse_ray(hit.p, n_vec, r1, r2)
    spec_p, spec_d = bsdf.specular_ray(hit.p, n_vec, ray_d)
    refr_p, refr_d, new_inside, refr_fac = bsdf.refractive_ray(
        hit.p, n_vec, ray_d, mat.n, mat.f0, inside, r1)

    # Lambert + Blinn with the camera view direction (prog.cl:79-81, :335).
    intens_d = torch.clamp_min(vdot(diff_d, n_vec), 0.0)
    eye_dir = vnormalize(tuple(cam.eye[k] - hit.p[k] for k in range(3)))
    halfway = vnormalize(vadd(eye_dir, diff_d))
    intens_s = torch.pow(torch.clamp_min(vdot(n_vec, halfway), 0.0),
                         mat.shininess)
    fres = bsdf.fresnel(mat.f0, n_vec, ray_d)
    emit_cos = torch.clamp_min(vdot(vneg(ray_d), n_vec), 0.0)

    use_diff = is_diff | is_emit
    new_p = vwhere(use_diff, diff_p, vwhere(is_refr, refr_p, spec_p))
    new_d = vwhere(use_diff, diff_d, vwhere(is_refr, refr_d, spec_d))
    return dict(
        mat=mat, n_vec=n_vec, is_diff=is_diff, is_spec=is_spec,
        is_refr=is_refr, is_emit=is_emit, intens_d=intens_d,
        intens_s=intens_s, fres=fres, refr_fac=refr_fac,
        new_inside=new_inside, emit_cos=emit_cos,
        new_p=vwhere(has_hit, new_p, ray_p),
        new_d=vwhere(has_hit, new_d, ray_d),
    )


def apply_factors(s: dict, f_l: V3, f_b: V3, f_s: V3, f_r: V3, inside,
                  color: V3, emit_scale=None):
    """Factor updates and the emitter contribution (prog.cl:329-366).
    emit_scale: an optional per-lane pickup weight (NEE's MIS weight,
    `ops.nee.pickup_mis_weight`); None keeps the reference's full
    pickup."""
    mat = s["mat"]
    f_l = vwhere(s["is_diff"], vmul(f_l, vscale(mat.kd, s["intens_d"])), f_l)
    f_b = vwhere(s["is_diff"], vmul(f_b, vscale(mat.ks, s["intens_s"])), f_b)
    f_s = vwhere(s["is_spec"], vmul(f_s, s["fres"]), f_s)
    f_r = vwhere(s["is_refr"], vmul(f_r, s["refr_fac"]), f_r)
    inside = torch.where(s["is_refr"], s["new_inside"], inside)
    contrib = vscale(
        vmul(mat.emission, vmul(vadd(f_l, f_b), vmul(f_s, f_r))),
        s["emit_cos"])
    if emit_scale is not None:
        contrib = vscale(contrib, emit_scale)
    color = vwhere(s["is_emit"], vadd(color, contrib), color)
    return f_l, f_b, f_s, f_r, inside, color


def trace_sample(cam: Camera, mats: MaterialsSoA, state: TraceState, *,
                 intersect_fn: IntersectFn, iterations: int,
                 mode: str = "parity", key: tuple[int, int] | None = None,
                 qmc: bool = False, with_stats: bool = False, nee=None,
                 occluded_fn=None, env=None, dof=None, ids: int | None = None,
                 sample_index: int | None = None):
    """Render one progressive sample for every pixel (lane j is pixel
    ids + j) and fold it into the running average (prog.cl:379).
    `iterations` is the bounce depth.

    ids: for a call that renders a contiguous tile of a larger frame
    (`parallel.shard.make_tiled_step`), the tile's first global pixel id
    o, a host int, so that lane j is pixel o + j (the JAX package takes
    the ids array and keys on ids[0]); None is 0, the whole frame.
    sample_index: overrides state.sample in the fast-mode and QMC draws
    (sample sharding, `parallel.shard.make_sample_sharded_render`); the
    running average still weighs by state.sample.
    Fast mode draws from the murmur3 hash keyed by fold_in(key, ids) (the
    tile's first pixel id), or the R2 sequence with qmc=True.
    nee: an `ops.nee.EmitterTable`; its draws come from the hash keyed by
    fold_in(key, ids) (key(1791) when key is None, as in parity mode),
    salt 10,000 + bounce, so parity mode's Lehmer streams stay the
    reference's.
    env: an `EnvLight` (the dormant sky, prog.cl:367-376) or an
    `ops.envmap.EnvMap`; with env.nee a map's gather draws from
    fold_in(key or key(3791), ids), salt 30,000 + bounce, and its
    escape rays go through occluded_fn at rmax 3.0e38.
    dof: (aperture, focus): thin-lens camera rays whose lens draws come
    from fold_in(key or key(401), ids), salt 20,000.
    occluded_fn: the any-hit shadow-ray test (`make_scene_occluded`);
    None sends the shadow rays through intersect_fn. Neither traces the
    last bounce's shadow rays, whose contribution is zero.
    with_stats=True also returns the number of rays traced (live lanes at
    each bounce, once more for each shadow batch, NEE's and the
    environment's, traced or not) as a 0-dim tensor."""
    with profiling.span("step", sample=state.sample):
        with profiling.span("step.raygen"):
            rng_state = state.rng_state
            n = rng_state.shape[0]
            dev = rng_state.device
            first_id = ids or 0
            ids = raygen.pixel_ids_like(n, device=dev) + first_id
            s_idx = state.sample if sample_index is None else int(
                sample_index)
            env_kind = _env_kind(env)
            env_gather = env_kind == "map" and env.nee
            if nee is not None:
                nee_key = rng.fold_in(
                    key if key is not None else rng.key(1791), first_id)
            if env_gather:
                env_key = rng.fold_in(
                    key if key is not None else rng.key(3791), first_id)
            if mode == "parity":
                ones = torch.ones(n, dtype=torch.bool, device=dev)
                rng_state, r1, r2 = _draws_parity(rng_state, ones, ones)
            elif mode == "fast":
                if key is None:
                    raise ValueError("fast mode needs a key (rng.key(seed))")
                tile_key = rng.fold_in(key, first_id)
                if qmc:
                    r1, r2 = rng.r2_jitter(key, ids, s_idx)
                else:
                    u = rng.fast_uniforms(tile_key, s_idx, 0, n, 2,
                                          device=dev)
                    r1, r2 = u[0], u[1]
            else:
                raise ValueError(f"unknown mode {mode!r}")
            if dof is not None:
                # The lens draws ride the counter hash (salt 20,000: the
                # bounce draws use 1..50 and NEE 10,000 + b), so parity
                # mode's Lehmer streams stay the reference's.
                dof_key = rng.fold_in(
                    key if key is not None else rng.key(401), first_id)
                lu = rng.fast_uniforms(dof_key, s_idx, 20_000, n, 2,
                                       device=dev)
                rays = raygen.camera_rays_dof(cam, ids, r1, r2, lu[0], lu[1],
                                              dof[0], dof[1])
            else:
                rays = raygen.camera_rays(cam, ids, r1, r2)

            ray_p, ray_d = rays.p, rays.d
            f_l = f_b = f_s = f_r = tuple(
                torch.ones(n, dtype=torch.float32, device=dev)
                for _ in range(3))
            color = tuple(torch.zeros(n, dtype=torch.float32, device=dev)
                          for _ in range(3))
            alive = torch.ones(n, dtype=torch.bool, device=dev)
            inside = torch.zeros(n, dtype=torch.bool, device=dev)
            had_diffuse = torch.zeros(n, dtype=torch.bool, device=dev)
            prev_pdf = torch.zeros(n, dtype=torch.float32, device=dev)
            rays_traced = torch.zeros((), dtype=torch.float32, device=dev)

        for b in range(iterations):
            with profiling.span("step.bounce"):
                # The environment pickup weighs against the previous
                # bounce's pdf.
                prev_pdf_prev = prev_pdf
                if with_stats:
                    rays_traced = rays_traced + alive.sum()
                hit, mat = fetch_material(mats, intersect_fn,
                                          Rays(p=ray_p, d=ray_d))
                has_hit = hit.valid & alive
                with profiling.span("step.rng"):
                    # Draws: diffuse/emitter take 2, refractive 1
                    # (prog.cl:330,349,361).
                    mtype = mat.type
                    is_d_or_e = has_hit & ((mtype == 0) | (mtype == 3))
                    if mode == "parity":
                        need1 = is_d_or_e | (has_hit & (mtype == 2))
                        rng_state, r1, r2 = _draws_parity(rng_state, need1,
                                                          is_d_or_e)
                    else:
                        u = rng.fast_uniforms(tile_key, s_idx, b + 1, n, 2,
                                              device=dev)
                        r1, r2 = u[0], u[1]
                with profiling.span("step.shade"):
                    s = shade(cam, mat, hit, ray_p, ray_d, inside, r1, r2,
                              has_hit)
                    if iterations == 1:
                        # Preview mode (prog.cl:323-325): flat kd +
                        # emission.
                        color = vwhere(has_hit, vadd(mat.kd, mat.emission),
                                       color)
                last = b == iterations - 1
                # The last bounce's gathers are masked to zero (is_diff is
                # false on every lane), so their shadow rays are traced by
                # nobody; they still count in rays_traced.
                gather = s["is_diff"] & (not last)
                shadow_fn = _unoccluded if last else occluded_fn
                emit_scale = None
                if nee is not None:
                    # Gather where the path survives to the next
                    # intersect, so truncation matches the base
                    # estimator; the next bounce's pickup takes the MIS
                    # complement through prev_pdf.
                    with profiling.span("step.rng"):
                        u = rng.fast_uniforms(nee_key, s_idx, 10_000 + b, n,
                                              3, device=dev)
                    color = vadd(color, nee_ops.direct_light(
                        nee, intersect_fn=intersect_fn, cam_eye=cam.eye,
                        hit_p=hit.p, n_vec=s["n_vec"], mat=mat, f_l=f_l,
                        f_b=f_b, f_s=f_s, f_r=f_r, is_diff=gather, u1=u[0],
                        u2=u[1], u3=u[2], occluded_fn=shadow_fn))
                    if with_stats:
                        # the shadow batch
                        rays_traced = rays_traced + alive.sum()
                    emit_scale = nee_ops.pickup_mis_weight(
                        nee, prev_pdf, s["emit_cos"], hit.t, mat.emission,
                        mati=hit.mati, hit_p=hit.p, ray_p=ray_p)
                if nee is not None or env_gather:
                    prev_pdf = torch.where(s["is_diff"],
                                           s["intens_d"] * _INV_PI,
                                           torch.zeros_like(prev_pdf))
                if env_gather:
                    # The environment gather: the same survival gating and
                    # MIS split in solid angle (salt 30,000 + b).
                    with profiling.span("step.rng"):
                        u = rng.fast_uniforms(env_key, s_idx, 30_000 + b, n,
                                              3, device=dev)
                    color = vadd(color, envmap_ops.direct_light_env(
                        env, intersect_fn=intersect_fn, cam_eye=cam.eye,
                        hit_p=hit.p, n_vec=s["n_vec"], mat=mat, f_l=f_l,
                        f_b=f_b, f_s=f_s, f_r=f_r, is_diff=gather, u1=u[0],
                        u2=u[1], u3=u[2], occluded_fn=shadow_fn))
                    if with_stats:
                        # the escape batch
                        rays_traced = rays_traced + alive.sum()
                with profiling.span("step.shade"):
                    f_l, f_b, f_s, f_r, inside, color = apply_factors(
                        s, f_l, f_b, f_s, f_r, inside, color, emit_scale)
                    # Miss -> break (prog.cl:367-376); with an environment
                    # the dying lane first collects its contribution.
                    if env_kind == "map":
                        color = envmap_ops.envmap_miss_update(
                            env, alive & ~hit.valid, b == 0, prev_pdf_prev,
                            f_l, f_b, f_s, f_r, ray_d, color)
                    elif env_kind == "light":
                        color = env_miss_update(
                            env, alive & ~hit.valid, b == 0, had_diffuse,
                            f_l, f_b, f_s, f_r, color)
                        had_diffuse = had_diffuse | s["is_diff"]
                alive = has_hit
                ray_p, ray_d = s["new_p"], s["new_d"]

        with profiling.span("step.fold"):
            # Progressive average (prog.cl:379), in float32 like the
            # reference.
            s_f = np.float32(state.sample)
            inv = float(np.float32(1.0) / (s_f + np.float32(1.0)))
            colors = tuple((state.colors[k] * float(s_f) + color[k]) * inv
                           for k in range(3))
            new_state = TraceState(colors=colors, rng_state=rng_state,
                                   sample=state.sample + 1)
    if with_stats:
        return new_state, rays_traced
    return new_state

def render(cam: Camera, mats: MaterialsSoA, *, intersect_fn: IntersectFn,
           num_pixels: int, iterations: int, spp: int, mode: str = "parity",
           seed: int = 1, key: tuple[int, int] | None = None,
           state: TraceState | None = None, qmc: bool = False, nee=None,
           env=None, dof=None, occluded_fn=None,
           device=None) -> TraceState:
    """Accumulate `spp` progressive samples (the onIdle loop,
    main.cpp:1171-1241). Runs on `device` (CUDA unless "cpu" is asked
    for); cam and mats must already live there."""
    dev = resolve_device(device)
    if cam.eye.device.type != dev.type or mats.n.device.type != dev.type:
        raise ValueError(f"cam and mats must be on {dev}")
    if state is None:
        state = init_state(num_pixels, seed, device=dev)
    if mode == "fast" and key is None:
        key = rng.key(seed)
    for _ in range(spp):
        state = trace_sample(cam, mats, state, intersect_fn=intersect_fn,
                             iterations=iterations, mode=mode, key=key,
                             qmc=qmc, nee=nee, env=env, dof=dof,
                             occluded_fn=occluded_fn)
    return state


def colors_array(state: TraceState) -> torch.Tensor:
    """(N, 3) color tensor."""
    return torch.stack(state.colors, dim=-1)
