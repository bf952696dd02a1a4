"""Wavefront path tracer with path regeneration (the throughput model).

Port of `opencl_path_tracer_tpu/models/wavefront.py`: `WavefrontState`,
`init_wavefront`, `wavefront_step`, `sort_state`, `morton3_components`,
`render_wavefront`, `colors_by_pixel` and adaptive sampling
(`converged_mask`, `sort_open_first`, `state_split`, `state_concat`,
`render_adaptive`).

One lane per pixel (or per pixel id in `ids`). The moment a lane's path
terminates (a miss, the bounce budget, or Russian roulette) it folds the
finished sample into that pixel's running average and starts the next
sample of the same pixel in the same step, so every intersection batch
is all live rays. Parity mode keeps each pixel's reference Lehmer draw
order (gen_ray's two draws, then the per-bounce draws), so a pixel with
s samples has the megakernel's bit-identical color at s samples.

Shading is the megakernel's (`shade`, `apply_factors`,
`fetch_material`); this module owns the regeneration scheduling. The
step counter is a host int, like `TraceState.sample`: the fast draws are
keyed by it, and keeping it on the host costs no device read.

Next-event estimation (`nee`, `occluded_fn`) is the megakernel's gather
and MIS pickup, with the draws keyed by the step counter and the
previous bounce's direction pdf carried per lane in `prev_pdf`. `env`
(the dormant sky `EnvLight`, with `had_diffuse` per lane, or an
`ops.envmap.EnvMap` and its escape-ray gather, salt 5) and `dof` (thin
lens, salt 4) are the megakernel's too, keyed by the step counter.

Adaptive sampling (`variance_tol`) keeps a Welford M2 of each pixel's
completed-sample luminance in `lum_m2` and idles a lane once
`converged_mask` holds. Its arithmetic rounds as the JAX package's does
op by op, as the rest of this step does: inside a jitted step XLA's CPU
backend contracts `_luminance` to fma(c, z, fma(a, x, b * y)) and the
fold's `colors * s + cur` to an FMA too, so the port equals JAX's
adaptive renders bit for bit where JAX runs them under
`jax.disable_jit()`, and its jitted ones to the goldens' tolerance.
Compaction (`render_adaptive`) permutes, splits and concatenates lanes:
parity mode gives the same bits with it on or off, but the fast draws
and NEE's draws are keyed by lane position, so they change with it, in
JAX as here.
"""

from __future__ import annotations

import dataclasses

import torch

from opencl_path_tracer_tpu_torch.core.camera import Camera
from opencl_path_tracer_tpu_torch.core.materials import MaterialsSoA
from opencl_path_tracer_tpu_torch.core.types import (
    Rays, V3, vadd, vscale, vwhere,
)
from opencl_path_tracer_tpu_torch.models.megakernel import (
    _INV_PI, _draws_parity, _env_kind, apply_factors, env_miss_update,
    fetch_material, shade,
)
from opencl_path_tracer_tpu_torch.ops import envmap as envmap_ops
from opencl_path_tracer_tpu_torch.ops import nee as nee_ops
from opencl_path_tracer_tpu_torch.ops import raygen, rng
from opencl_path_tracer_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class WavefrontState:
    """Accumulation and in-flight path state, one lane per pixel id.
    V3 fields are tuples of (N,) float32 tensors."""

    colors: V3                # running per-pixel average
    samples: torch.Tensor     # (N,) int32 completed samples
    pixel: torch.Tensor       # (N,) int32 pixel id this lane serves
    rng_state: torch.Tensor   # (N,) int64 Lehmer states < 2^31 (parity)
    ray_p: V3                 # current path ray
    ray_d: V3
    f_l: V3                   # throughput factors (prog.cl:307-310)
    f_b: V3
    f_s: V3
    f_r: V3
    cur_color: V3             # current sample's accumulated color
    inside: torch.Tensor      # (N,) bool refraction state
    bounce: torch.Tensor      # (N,) int32 bounces done on this path
    had_diffuse: torch.Tensor  # (N,) bool; read only by EnvLight
    prev_pdf: torch.Tensor    # (N,) float32; read only by NEE
    lum_m2: torch.Tensor      # (N,) float32; read only by adaptive sampling
    step: int                 # global step counter (fast draws)

    @property
    def lanes(self) -> int:
        return int(self.samples.shape[0])

    def replace(self, **kw) -> "WavefrontState":
        return dataclasses.replace(self, **kw)


def init_wavefront(cam: Camera, num_pixels: int, *, seed: int = 1,
                   mode: str = "parity", key=None,
                   ids: torch.Tensor | None = None, qmc: bool = False,
                   dof=None) -> WavefrontState:
    """Fresh state on the camera's device. ids: optional lane -> pixel
    id map (e.g. `raygen.tile_major_ids`); lane j serves pixel ids[j].
    dof: (aperture, focus) for thin-lens rays (lens draws keyed by key,
    or key(401), step 0, salt 4)."""
    n = num_pixels
    dev = cam.eye.device
    if ids is None:
        ids = raygen.pixel_ids_like(n, device=dev)
    ids = ids.to(device=dev, dtype=torch.int32)
    # Lane j serves pixel ids[j]: permute the per-pixel streams so parity
    # mode keeps each pixel's reference Lehmer sequence.
    rng_state = rng.seed_pixel_streams(n, seed, device=dev)[ids.long()]
    if mode == "parity":
        ones = torch.ones(n, dtype=torch.bool, device=dev)
        rng_state, r1, r2 = _draws_parity(rng_state, ones, ones)
    elif mode == "fast":
        if key is None:
            raise ValueError("fast mode needs a key (rng.key(seed))")
        if qmc:
            r1, r2 = rng.r2_jitter(key, ids, 0)
        else:
            u = rng.fast_uniforms(key, 0, 0, n, 2, device=dev)
            r1, r2 = u[0], u[1]
    else:
        raise ValueError(f"unknown mode {mode!r}")
    if dof is not None:
        lu = rng.fast_uniforms(key if key is not None else rng.key(401), 0,
                               4, n, 2, device=dev)
        rays = raygen.camera_rays_dof(cam, ids, r1, r2, lu[0], lu[1],
                                      dof[0], dof[1])
    else:
        rays = raygen.camera_rays(cam, ids, r1, r2)

    def f32(v):
        return torch.full((n,), v, dtype=torch.float32, device=dev)

    def v3(v):
        return (f32(v), f32(v), f32(v))

    return WavefrontState(
        colors=v3(0.0),
        samples=torch.zeros(n, dtype=torch.int32, device=dev),
        pixel=ids,
        rng_state=rng_state,
        ray_p=tuple(c.contiguous() for c in rays.p), ray_d=rays.d,
        f_l=v3(1.0), f_b=v3(1.0), f_s=v3(1.0), f_r=v3(1.0),
        cur_color=v3(0.0),
        inside=torch.zeros(n, dtype=torch.bool, device=dev),
        bounce=torch.zeros(n, dtype=torch.int32, device=dev),
        had_diffuse=torch.zeros(n, dtype=torch.bool, device=dev),
        prev_pdf=f32(0.0),
        lum_m2=f32(0.0),
        step=1,
    )


_LANE_FIELDS = tuple(f.name for f in dataclasses.fields(WavefrontState)
                     if f.name != "step")


def _lanes(st: WavefrontState, fn) -> WavefrontState:
    """st with fn applied to every lane array (each V3 component); `step`
    rides along."""
    return st.replace(**{
        f: (tuple(fn(c) for c in getattr(st, f))
            if isinstance(getattr(st, f), tuple) else fn(getattr(st, f)))
        for f in _LANE_FIELDS})


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v so they occupy every 3rd bit."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    return (v * 0x00000005) & 0x49249249


def morton3_components(q: V3) -> torch.Tensor:
    """30-bit Morton codes (int64) from a V3 of coordinates in [0, 1]."""
    def scale(c):
        return torch.clamp(c * 1024.0, 0.0, 1023.0).to(torch.int64)

    return ((_expand_bits(scale(q[0])) << 2)
            | (_expand_bits(scale(q[1])) << 1)
            | _expand_bits(scale(q[2])))


def sort_state(st: WavefrontState, scene_lo, scene_inv_extent
               ) -> WavefrontState:
    """Reorder lanes by (direction octant, origin Morton cell), stable,
    so that ray tiles stay spatially coherent. Any lane order is correct:
    every lane carries its pixel binding and its own accumulators."""
    q = tuple(torch.clamp((st.ray_p[k] - float(scene_lo[k]))
                          * float(scene_inv_extent[k]), 0.0, 1.0)
              for k in range(3))
    cell = morton3_components(q)
    octant = ((st.ray_d[0] >= 0).long() * 4 + (st.ray_d[1] >= 0).long() * 2
              + (st.ray_d[2] >= 0).long())
    order = torch.sort((octant << 27) | (cell >> 3), stable=True).indices
    return _lanes(st, lambda a: a[order])


_LUM = (0.2126, 0.7152, 0.0722)  # Reinhard's weights (prog.cl:249)


def _luminance(v3: V3) -> torch.Tensor:
    return _LUM[0] * v3[0] + _LUM[1] * v3[1] + _LUM[2] * v3[2]


def converged_mask(samples: torch.Tensor, colors: V3, lum_m2: torch.Tensor,
                   tol: float, min_samples: int) -> torch.Tensor:
    """Adaptive sampling's stop rule, per lane: at least min_samples
    samples, and the standard error of the mean sample luminance within
    `tol` of the mean (plus a 0.05 floor, so that black pixels stop):
    m2 / (n (n - 1)) <= (tol (mean + 0.05))^2, multiplied out."""
    n = samples.to(torch.float32)
    a = tol * (_luminance(colors) + 0.05)
    rhs = a * a * n * (n - 1.0)
    return (samples >= min_samples) & (lum_m2 <= rhs)


def wavefront_step(cam: Camera, mats: MaterialsSoA, st: WavefrontState, *,
                   intersect_fn, iterations: int, mode: str = "parity",
                   key=None, max_samples: int | None = None,
                   ids: torch.Tensor | None = None, sort_every: int = 0,
                   scene_bounds=None, env=None, nee=None,
                   rr: tuple[int, float] | None = None, qmc: bool = False,
                   dof=None, variance_tol: float | None = None,
                   min_samples: int = 8, lane_offset: int = 0,
                   occluded_fn=None) -> WavefrontState:
    """One wavefront step: intersect every lane once, shade, terminate
    and regenerate. `ids` is accepted for the JAX signature and unused
    (lanes carry st.pixel).

    max_samples: lanes with that many samples idle. lane_offset: the
    global index of this state's first lane (a shard of a larger
    wavefront), so that fast draws continue the one-device streams.
    sort_every > 0 re-sorts lanes every that many steps (needs
    scene_bounds = (lo, inv_extent)). rr = (start_bounce, p_min):
    Russian roulette after start_bounce bounces, survival probability
    clip(max channel of (f_l + f_b) f_s f_r, p_min, 1), survivors scale
    f_s by 1/p; its draws ride an independent counter-hash stream.
    nee: an `ops.nee.EmitterTable` (draws keyed by key, or key(1791),
    salt 2); occluded_fn: the any-hit shadow-ray test, None for the
    intersector. env: an `EnvLight` or an `ops.envmap.EnvMap` (gather
    draws keyed by key, or key(3791), salt 5; escape rays through
    occluded_fn at rmax 3.0e38); a lane whose path dies on a miss first
    collects the environment, a budget-terminated lane nothing. dof:
    (aperture, focus), the regenerated rays' lens draws keyed by key, or
    key(401), salt 4. variance_tol: adaptive sampling; lanes idle once
    `converged_mask(..., variance_tol, min_samples)` holds, and finished
    samples update `lum_m2` (None leaves it as it is)."""
    env_kind = _env_kind(env)
    env_gather = env_kind == "map" and env.nee
    want_pdf = nee is not None or env_gather
    n = st.lanes
    dev = st.samples.device
    if sort_every and scene_bounds is not None and st.step % sort_every == 0:
        st = sort_state(st, scene_bounds[0], scene_bounds[1])

    if max_samples is None:
        active = torch.ones(n, dtype=torch.bool, device=dev)
    else:
        active = st.samples < max_samples
    if variance_tol is not None:
        active = active & ~converged_mask(st.samples, st.colors, st.lum_m2,
                                          variance_tol, min_samples)

    hit, mat = fetch_material(mats, intersect_fn,
                              Rays(p=st.ray_p, d=st.ray_d))
    valid = hit.valid
    has_hit = valid & active

    # Bounce draws: 2 for diffuse/emitter, 1 refractive (prog.cl:330,349,361).
    rng_state = st.rng_state
    mtype = mat.type
    is_d_or_e = has_hit & ((mtype == 0) | (mtype == 3))
    if mode == "parity":
        need1 = is_d_or_e | (has_hit & (mtype == 2))
        rng_state, r1, r2 = _draws_parity(rng_state, need1, is_d_or_e)
    elif mode == "fast":
        u = rng.fast_uniforms(key, st.step, 0, n, 2, lane_offset=lane_offset,
                              device=dev)
        r1, r2 = u[0], u[1]
    else:
        raise ValueError(f"unknown mode {mode!r}")

    s = shade(cam, mat, hit, st.ray_p, st.ray_d, st.inside, r1, r2, has_hit)
    cur_color = st.cur_color
    if iterations == 1:  # preview (prog.cl:323-325)
        cur_color = vwhere(has_hit, vadd(mat.kd, mat.emission), cur_color)
    emit_scale, prev_pdf = None, st.prev_pdf
    if nee is not None:
        u = rng.fast_uniforms(key if key is not None else rng.key(1791),
                              st.step, 2, n, 3, lane_offset=lane_offset,
                              device=dev)
        # Gather where the path survives to the next intersect.
        cur_color = vadd(cur_color, nee_ops.direct_light(
            nee, intersect_fn=intersect_fn, cam_eye=cam.eye, hit_p=hit.p,
            n_vec=s["n_vec"], mat=mat, f_l=st.f_l, f_b=st.f_b, f_s=st.f_s,
            f_r=st.f_r, is_diff=s["is_diff"] & (st.bounce + 1 < iterations),
            u1=u[0], u2=u[1], u3=u[2], occluded_fn=occluded_fn))
        emit_scale = nee_ops.pickup_mis_weight(
            nee, st.prev_pdf, s["emit_cos"], hit.t, mat.emission,
            mati=hit.mati, hit_p=hit.p, ray_p=st.ray_p)
    if want_pdf:
        prev_pdf = torch.where(
            active, torch.where(s["is_diff"], s["intens_d"] * _INV_PI,
                                torch.zeros_like(st.prev_pdf)), st.prev_pdf)
    if env_gather:
        u = rng.fast_uniforms(key if key is not None else rng.key(3791),
                              st.step, 5, n, 3, lane_offset=lane_offset,
                              device=dev)
        # The same survival gating as the emitter gather.
        cur_color = vadd(cur_color, envmap_ops.direct_light_env(
            env, intersect_fn=intersect_fn, cam_eye=cam.eye, hit_p=hit.p,
            n_vec=s["n_vec"], mat=mat, f_l=st.f_l, f_b=st.f_b, f_s=st.f_s,
            f_r=st.f_r, is_diff=s["is_diff"] & (st.bounce + 1 < iterations),
            u1=u[0], u2=u[1], u3=u[2], occluded_fn=occluded_fn))
    f_l, f_b, f_s, f_r, inside, cur_color = apply_factors(
        s, st.f_l, st.f_b, st.f_s, st.f_r, st.inside, cur_color, emit_scale)
    had_diffuse = st.had_diffuse
    if env_kind == "map":
        # st.prev_pdf (the previous bounce's) weighs the pickup.
        cur_color = envmap_ops.envmap_miss_update(
            env, active & ~hit.valid, st.bounce == 0, st.prev_pdf,
            f_l, f_b, f_s, f_r, st.ray_d, cur_color)
    elif env_kind == "light":
        cur_color = env_miss_update(env, active & ~hit.valid,
                                    st.bounce == 0, st.had_diffuse,
                                    f_l, f_b, f_s, f_r, cur_color)
        had_diffuse = st.had_diffuse | s["is_diff"]

    bounce = torch.where(active, st.bounce + 1, st.bounce)
    terminated = active & (~valid | (bounce >= iterations))

    if rr is not None:
        start, pmin = rr
        continuing = active & valid & (bounce < iterations)
        w_lb = vadd(f_l, f_b)
        thr = tuple(w_lb[k] * f_s[k] * f_r[k] for k in range(3))
        p = torch.clamp(torch.maximum(torch.maximum(thr[0], thr[1]), thr[2]),
                        pmin, 1.0)
        rr_key = key if key is not None else rng.key(2791)
        u = rng.fast_uniforms(rr_key, st.step, 3, n, 1,
                              lane_offset=lane_offset, device=dev)[0]
        gate = continuing & (bounce >= start)
        dead = gate & (u >= p)
        one = torch.ones_like(p)
        f_s = vscale(f_s, torch.where(gate & ~dead, one / p, one))
        terminated = terminated | dead

    # Fold finished samples into the running average (prog.cl:379).
    s_f = st.samples.to(torch.float32)
    inv = 1.0 / (s_f + 1.0)
    colors = tuple(torch.where(terminated,
                               (st.colors[k] * s_f + cur_color[k]) * inv,
                               st.colors[k]) for k in range(3))
    samples = torch.where(terminated, st.samples + 1, st.samples)
    lum_m2 = st.lum_m2
    if variance_tol is not None:
        # Welford on the finished samples' luminance: colors is each
        # channel's running mean, so _luminance(colors) is the running
        # mean of the luminances.
        lum_new = _luminance(cur_color)
        delta = lum_new - _luminance(st.colors)
        lum_m2 = torch.where(terminated,
                             st.lum_m2 + delta * (lum_new - _luminance(colors)),
                             st.lum_m2)

    # Regenerate: the next sample's camera ray (gen_ray, prog.cl:384-389).
    if mode == "parity":
        rng_state, g1, g2 = _draws_parity(rng_state, terminated, terminated)
    elif qmc:
        # Each pixel walks its own R2 sequence by sample index.
        g1, g2 = rng.r2_jitter(key, st.pixel, samples)
    else:
        u = rng.fast_uniforms(key, st.step, 1, n, 2, lane_offset=lane_offset,
                              device=dev)
        g1, g2 = u[0], u[1]
    if dof is not None:
        lu = rng.fast_uniforms(key if key is not None else rng.key(401),
                               st.step, 4, n, 2, lane_offset=lane_offset,
                               device=dev)
        fresh = raygen.camera_rays_dof(cam, st.pixel, g1, g2, lu[0], lu[1],
                                       dof[0], dof[1])
    else:
        fresh = raygen.camera_rays(cam, st.pixel, g1, g2)

    ones = tuple(torch.ones_like(s_f) for _ in range(3))
    zeros = tuple(torch.zeros_like(s_f) for _ in range(3))
    return WavefrontState(
        colors=colors,
        samples=samples,
        pixel=st.pixel,
        rng_state=rng_state,
        ray_p=vwhere(terminated, fresh.p, s["new_p"]),
        ray_d=vwhere(terminated, fresh.d, s["new_d"]),
        f_l=vwhere(terminated, ones, f_l),
        f_b=vwhere(terminated, ones, f_b),
        f_s=vwhere(terminated, ones, f_s),
        f_r=vwhere(terminated, ones, f_r),
        cur_color=vwhere(terminated, zeros, cur_color),
        inside=torch.where(terminated, False, inside),
        bounce=torch.where(terminated, 0, bounce),
        had_diffuse=(torch.where(terminated, False, had_diffuse)
                     if env_kind == "light" else had_diffuse),
        prev_pdf=(torch.where(terminated, 0.0, prev_pdf) if want_pdf
                  else prev_pdf),
        lum_m2=lum_m2,
        step=st.step + 1,
    )


def render_wavefront(cam: Camera, mats: MaterialsSoA, *, intersect_fn,
                     num_pixels: int, iterations: int, min_spp: int,
                     mode: str = "parity", seed: int = 1, key=None,
                     max_extra_steps: int = 1_000_000,
                     exact_spp: bool = False,
                     ids: torch.Tensor | None = None, env=None, nee=None,
                     rr=None, qmc: bool = False, dof=None,
                     occluded_fn=None, device=None) -> WavefrontState:
    """Run steps until every pixel has >= min_spp samples, with a host
    check of min(samples) every max(2 * iterations, 8) steps. Runs on
    `device` (CUDA unless "cpu" is asked for); cam and mats must live
    there. exact_spp=True caps every pixel at exactly min_spp samples
    (for bit-parity comparisons against the megakernel). occluded_fn:
    NEE's any-hit test, as `wavefront_step` takes it (the JAX function
    has no such argument)."""
    dev = resolve_device(device)
    if cam.eye.device.type != dev.type or mats.n.device.type != dev.type:
        raise ValueError(f"cam and mats must be on {dev}")
    if mode == "fast" and key is None:
        key = rng.key(seed)
    state = init_wavefront(cam, num_pixels, seed=seed, mode=mode, key=key,
                           ids=ids, qmc=qmc, dof=dof)
    cap = min_spp if exact_spp else None
    chunk = max(iterations * 2, 8)
    for _ in range(max_extra_steps):
        for _ in range(chunk):
            state = wavefront_step(
                cam, mats, state, intersect_fn=intersect_fn,
                iterations=iterations, mode=mode, key=key, max_samples=cap,
                env=env, nee=nee, rr=rr, qmc=qmc, dof=dof,
                occluded_fn=occluded_fn)
        if int(state.samples.min()) >= min_spp:
            break
    return state


def sort_open_first(st: WavefrontState,
                    open_mask: torch.Tensor) -> WavefrontState:
    """Lanes permuted so that the open ones (still sampling) come first,
    each class in its old order; `step` rides along. Any lane order is
    correct (each lane carries its pixel, accumulators and Lehmer
    stream), so the converged tail can be parked (`render_adaptive`)."""
    order = torch.sort((~open_mask).to(torch.uint8), stable=True).indices
    return _lanes(st, lambda a: a[order])


def state_split(st: WavefrontState, n: int):
    """(the first n lanes, the rest); both keep `step`."""
    return _lanes(st, lambda a: a[:n]), _lanes(st, lambda a: a[n:])


def state_concat(parts) -> WavefrontState:
    """The lanes of `parts` in order; `step` is the first part's."""
    first = parts[0]
    out = {}
    for f in _LANE_FIELDS:
        vs = [getattr(p, f) for p in parts]
        out[f] = (tuple(torch.cat(cs) for cs in zip(*vs))
                  if isinstance(vs[0], tuple) else torch.cat(vs))
    return first.replace(**out)


def compact_target(bucket: int, n_open: int, min_bucket: int) -> int:
    """The bucket after a convergence check: halved while the open lanes
    still fit in half of it and half of it is at least min_bucket, and
    only while it is even (2,073,600 = 2^10 x 2025 halves ten times)."""
    target = bucket
    while target // 2 >= max(n_open, min_bucket) and target % 2 == 0:
        target //= 2
    return target


def render_adaptive(cam: Camera, mats: MaterialsSoA, *, intersect_fn,
                    num_pixels: int, iterations: int, tol: float,
                    max_spp: int, min_spp: int = 8, mode: str = "fast",
                    seed: int = 1, key=None, env=None, nee=None, rr=None,
                    qmc: bool = False, dof=None, compact: bool = True,
                    min_bucket: int = 4096,
                    max_extra_steps: int = 1_000_000,
                    device=None) -> WavefrontState:
    """Adaptive render: each pixel takes min_spp to max_spp samples and
    stops once `converged_mask` holds (the reference gives every pixel
    every sample, prog.cl:379). A host check every max(6 iterations, 24)
    steps; with `compact`, once the open lanes fit in half the live
    bucket, they are moved to the front (`sort_open_first`), the bucket
    halves (`compact_target`) and the converged tail is parked until the
    end. Runs on `device` (CUDA unless "cpu" is asked for)."""
    dev = resolve_device(device)
    if cam.eye.device.type != dev.type or mats.n.device.type != dev.type:
        raise ValueError(f"cam and mats must be on {dev}")
    if mode == "fast" and key is None:
        key = rng.key(seed)
    state = init_wavefront(cam, num_pixels, seed=seed, mode=mode, key=key,
                           qmc=qmc, dof=dof)
    chunk = max(iterations * 6, 24)
    parked = []
    bucket = num_pixels
    for _ in range(max_extra_steps):
        for _ in range(chunk):
            state = wavefront_step(
                cam, mats, state, intersect_fn=intersect_fn,
                iterations=iterations, mode=mode, key=key,
                max_samples=max_spp, env=env, nee=nee, rr=rr, qmc=qmc,
                dof=dof, variance_tol=tol, min_samples=min_spp)
        done = (converged_mask(state.samples, state.colors, state.lum_m2,
                               tol, min_spp)
                | (state.samples >= max_spp))
        n_open = int((~done).sum())
        if n_open == 0:
            break
        if compact:
            target = compact_target(bucket, n_open, min_bucket)
            if target < bucket:
                state, tail = state_split(sort_open_first(state, ~done),
                                          target)
                parked.append(tail)
                bucket = target
    return state_concat([state] + parked) if parked else state


def colors_by_pixel(state: WavefrontState,
                    num_pixels: int | None = None) -> torch.Tensor:
    """(num_pixels, 3) float32 colors indexed by pixel id, on the state's
    device. Undoes any lane order; with several lanes per pixel, each
    lane's running average is weighted by its completed samples."""
    pix = state.pixel.long()
    n = (int(num_pixels) if num_pixels is not None
         else (int(pix.max()) + 1 if pix.numel() else 0))
    dev = pix.device
    cols = torch.stack(state.colors, dim=-1)
    if pix.shape[0] == n and torch.unique(pix).shape[0] == n:
        out = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        out[pix] = cols
        return out
    w = state.samples.to(torch.float64)
    den = pixel_sum(pix, w, n)
    num = pixel_sum(pix, w[:, None] * cols.to(torch.float64), n)
    return (num / torch.clamp_min(den, 1.0)[:, None]).to(torch.float32)


def pixel_sum(pix: torch.Tensor, vals: torch.Tensor,
              num_pixels: int) -> torch.Tensor:
    """(num_pixels, ...) sums of vals (L, ...) over the lanes of each pixel
    (pix: (L,) ids), added in lane order from 0.0: the order of CPU
    `index_add_` and of the JAX package's `np.add.at`, and the same bits
    on every device and run. CUDA's `index_add_` adds with atomics in the
    order the lanes arrive, which on an H100 moved float32 sums (and so
    pixels of the engine's `display_u8_device`) between runs where a
    pixel's lanes lie near one another (PERF.md section 6). One round a
    lane rank: round r adds each pixel's r-th lane, so no two lanes of a
    round share a pixel."""
    pix = pix.long()
    out = torch.zeros((num_pixels,) + tuple(vals.shape[1:]),
                      dtype=vals.dtype, device=vals.device)
    if pix.numel() == 0:
        return out
    order = torch.argsort(pix, stable=True)
    counts = torch.bincount(pix, minlength=num_pixels)
    first = torch.cumsum(counts, 0) - counts
    for r in range(int(counts.max())):
        p = torch.nonzero(counts > r).squeeze(1)
        out[p] = out[p] + vals[order[first[p] + r]]
    return out
