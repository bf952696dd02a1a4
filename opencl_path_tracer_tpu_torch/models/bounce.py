"""K21: the megakernel's fast-mode bounce in one pass (CUDA kernel and
plain version), and the sample it runs in.

No counterpart in `opencl_path_tracer_tpu`: the JAX megakernel's shading
is plain XLA. Here a fast-mode sample keeps its path state packed, as
rows of one (21, N) float32 tensor S [ray_p, ray_d, f_l, f_b, f_s, f_r,
colour] and an (N,) int32 flags row (bit 0 alive, bit 1 inside), and
runs two entry points of `csrc/bounce.cu`:

  * `raygen`, once a sample: the salt-0 fast-hash draws, the pinhole
    camera ray (`ops.raygen.camera_rays`) and the state's start;
  * `bounce`, once a bounce after the intersector: the material fetch,
    the salt b + 1 draws, `megakernel.shade`, `megakernel.apply_factors`,
    the miss kill and the next ray; the lanes live at its start are added
    to an int64 counter (the exact rays_traced), and the last bounce
    folds the sample into the running average instead.

Their plain versions compose `rng.fast_uniforms`, `raygen.camera_rays`,
`megakernel.shade` and `megakernel.apply_factors` unchanged, so on the
CPU a packed sample equals `megakernel.trace_sample`'s plain path bit
for bit. CPU tensors take the plain versions; CUDA tensors launch the
kernel or raise. The camera and the materials reach the kernel through a
small device table in K5's `fused_table` layout (16 camera floats, 16
per material), built on the device from the device camera and materials.

`megakernel.trace_sample` sends a call here when `use_kernel` holds: the
state on CUDA, fast mode without QMC, no NEE, environment or DOF, and
more than one bounce (preview stays plain). Every other call keeps the
plain path.
"""

from __future__ import annotations

import dataclasses

import torch

from opencl_path_tracer_tpu_torch.core.types import Hits, Rays, vmul
from opencl_path_tracer_tpu_torch.models import megakernel
from opencl_path_tracer_tpu_torch.ops import raygen as raygen_ops
from opencl_path_tracer_tpu_torch.ops import rng
from opencl_path_tracer_tpu_torch.ops.kernels import _build
from opencl_path_tracer_tpu_torch.utils import profiling

# State rows.
RAYP, RAYD, FL, FB, FS, FR, COL = 0, 3, 6, 9, 12, 15, 18
S_ROWS = 21
# Flag bits.
ALIVE, INSIDE = 1, 2
# The table: K5's fused_table layout.
CAM_COLS = 16   # eye(3) lookat(3) right(3) up(3) 0 0 0 0
MAT_COLS = 16   # type n shininess kd(3) ks(3) emission(3) f0(3) 0


def use_kernel(device: torch.device, mode: str, qmc: bool, nee, env, dof,
               iterations: int) -> bool:
    """Whether a megakernel sample takes the packed path (this module)
    rather than the plain one, from the call's own inputs."""
    return (device.type == "cuda" and mode == "fast" and not qmc
            and nee is None and env is None and dof is None
            and iterations > 1)


def scene_table(cam, mats) -> torch.Tensor:
    """The kernel's constants, (16 + 16 M,) float32 on the camera's
    device: the camera row then one row per material, made on the device
    (no host read, so the host does not wait for the card)."""
    z = torch.zeros(mats.count + 4, dtype=torch.float32,
                    device=cam.eye.device)
    cols = [mats.type.to(torch.float32), mats.n, mats.shininess, *mats.kd,
            *mats.ks, *mats.emission, *mats.f0, z[4:]]
    return torch.cat([cam.eye, cam.lookat, cam.right, cam.up, z[:4],
                      torch.stack(cols, dim=1).reshape(-1)])


def raygen_plain(cam, n: int, first_id: int, sample: int, key):
    """Plain version of the raygen entry: (S, flags) of a sample's start,
    lane j on pixel first_id + j."""
    dev = cam.eye.device
    ids = raygen_ops.pixel_ids_like(n, device=dev) + first_id
    u = rng.fast_uniforms(key, sample, 0, n, 2, device=dev)
    rays = raygen_ops.camera_rays(cam, ids, u[0], u[1])
    one = torch.ones(n, dtype=torch.float32, device=dev)
    zero = torch.zeros(n, dtype=torch.float32, device=dev)
    S = torch.stack([*rays.p, *rays.d] + [one] * 12 + [zero] * 3)
    return S, torch.full((n,), ALIVE, dtype=torch.int32, device=dev)


def raygen(cam, table, n: int, first_id: int, sample: int, key):
    """The raygen entry: (S (21, n) float32, flags (n,) int32). key is
    the tile's fast-mode key (rng.fold_in(key, first_id)); table from
    scene_table (None on the CPU)."""
    if cam.eye.device.type == "cpu":
        return raygen_plain(cam, n, first_id, sample, key)
    _build.check(table, "table", (None,))
    if table.device != cam.eye.device:
        raise ValueError("table and the camera must be on one device")
    S = torch.empty((S_ROWS, n), dtype=torch.float32, device=table.device)
    flags = torch.empty(n, dtype=torch.int32, device=table.device)
    _build.launch("bounce_raygen", table, S, flags, n, int(first_id),
                  int(cam.xm), float(cam.xm), float(cam.ym),
                  int(sample) & 0xFFFFFFFF, key[0] & 0xFFFFFFFF,
                  key[1] & 0xFFFFFFFF)
    return S, flags


def bounce_plain(S, flags, hit: Hits, kd_scale, cam, mats, sample: int,
                 salt: int, key, counter=None, fold=None):
    """Plain version of the bounce entry. Returns (S', flags'), or with
    fold = (colors, s_f, inv) the folded (3, N) colours."""
    n = S.shape[1]

    def v3(r):
        return (S[r], S[r + 1], S[r + 2])

    alive = (flags & ALIVE) != 0
    inside = (flags & INSIDE) != 0
    if counter is not None:
        counter += alive.sum()
    mat = mats.take(hit.mati)
    if kd_scale is not None:
        mat = dataclasses.replace(mat, kd=vmul(mat.kd, kd_scale))
    has_hit = hit.valid & alive
    u = rng.fast_uniforms(key, sample, salt, n, 2, device=S.device)
    s = megakernel.shade(cam, mat, hit, v3(RAYP), v3(RAYD), inside, u[0],
                         u[1], has_hit)
    f_l, f_b, f_s, f_r, inside, color = megakernel.apply_factors(
        s, v3(FL), v3(FB), v3(FS), v3(FR), inside, v3(COL))
    if fold is not None:
        return torch.stack(megakernel.fold(fold[0], color, fold[1],
                                           fold[2]))
    S2 = torch.stack([*s["new_p"], *s["new_d"], *f_l, *f_b, *f_s, *f_r,
                      *color])
    flags2 = (has_hit.to(torch.int32) * ALIVE
              | inside.to(torch.int32) * INSIDE)
    return S2, flags2


def bounce(S, flags, hit: Hits, kd_scale, cam, mats, table, sample: int,
           salt: int, key, counter=None, fold=None):
    """The bounce entry: (S', flags') from the state and this bounce's
    hits, or, with fold = (colors, s_f, inv) on the last bounce, the
    sample folded into the running average as (3, N) rows
    ((colors[k] * s_f + colour[k]) * inv). kd_scale: the textured
    intersector's per-lane kd multipliers (a V3) or None; counter: an
    int64 (1,) tensor that gains the lanes alive at the bounce's start,
    or None; salt: the bounce's draw salt (b + 1); table from
    scene_table (unused on the CPU)."""
    n = S.shape[1]
    _build.check(S, "S", (S_ROWS, n))
    _build.check(flags, "flags", (n,), dtype=torch.int32)
    rows = [hit.t, *hit.p, *hit.n]
    for what, x in zip(("t", "px", "py", "pz", "nx", "ny", "nz"), rows):
        _build.check(x, f"hit.{what}", (n,))
    _build.check(hit.mati, "hit.mati", (n,), dtype=torch.int32)
    kds = list(kd_scale) if kd_scale is not None else [None] * 3
    for k, x in enumerate(kds):
        if x is not None:
            _build.check(x, f"kd_scale[{k}]", (n,))
    if counter is not None:
        _build.check(counter, "counter", (1,), dtype=torch.int64)
    if fold is not None:
        for k, c in enumerate(fold[0]):
            _build.check(c, f"colors[{k}]", (n,))
    tensors = [S, flags, *rows, hit.mati, *(x for x in kds if x is not None)]
    if any(x.device != S.device for x in tensors):
        raise ValueError("the state, the hits and kd_scale must be on one "
                         "device")
    if S.device.type == "cpu":
        return bounce_plain(S, flags, hit, kd_scale, cam, mats, sample, salt,
                            key, counter, fold)
    _build.check(table, "table", (None,))
    n_mats = (table.shape[0] - CAM_COLS) // MAT_COLS
    if n_mats < 1 or table.shape[0] != CAM_COLS + MAT_COLS * n_mats:
        raise ValueError("table must hold the camera and >= 1 material")
    if table.device != S.device:
        raise ValueError("table must be on the state's device")
    if fold is None:
        So, flags_o = torch.empty_like(S), torch.empty_like(flags)
        colors, c_in = None, [None] * 3
        s_f = inv = 0.0
    else:
        So = flags_o = None
        colors = torch.empty((3, n), dtype=torch.float32, device=S.device)
        c_in, s_f, inv = fold
    _build.launch("bounce", S, flags, *rows, hit.mati, *kds, table, n_mats,
                  So, flags_o, *c_in, colors, counter, n,
                  int(sample) & 0xFFFFFFFF, int(salt) & 0xFFFFFFFF,
                  key[0] & 0xFFFFFFFF, key[1] & 0xFFFFFFFF, float(s_f),
                  float(inv))
    return (So, flags_o) if fold is None else colors


def _hit_rows(res):
    """(Hits, kd_scale or None) of an intersector's result, each row a
    contiguous (N,) tensor (a copy only where an intersector returns a
    strided view) and mati int32, as the kernel reads them."""
    hit, kd_scale = res if isinstance(res, tuple) else (res, None)
    hit = Hits(t=hit.t.contiguous(),
               p=tuple(c.contiguous() for c in hit.p),
               n=tuple(c.contiguous() for c in hit.n),
               mati=hit.mati.to(torch.int32).contiguous())
    if kd_scale is not None:
        kd_scale = tuple(c.contiguous() for c in kd_scale)
    return hit, kd_scale


def trace_sample(cam, mats, state, *, intersect_fn, iterations: int, key,
                 with_stats: bool = False, ids: int | None = None,
                 sample_index: int | None = None):
    """`megakernel.trace_sample` in fast mode on the packed state (its
    arguments, without those `use_kernel` keeps on the plain path): one
    raygen, then per bounce the intersector and one bounce."""
    with profiling.span("step", sample=state.sample):
        with profiling.span("step.raygen"):
            n = state.rng_state.shape[0]
            dev = state.rng_state.device
            if iterations < 2:
                raise ValueError("the packed path needs iterations > 1 "
                                 "(the preview stays on the plain path)")
            first_id, s_idx = megakernel.sample_ids(state, ids, sample_index)
            tile_key = megakernel.fast_key(key, first_id)
            table = scene_table(cam, mats) if dev.type == "cuda" else None
            S, flags = raygen(cam, table, n, first_id, s_idx, tile_key)
            counter = (torch.zeros(1, dtype=torch.int64, device=dev)
                       if with_stats else None)
        fold = (tuple(c.contiguous() for c in state.colors),
                *megakernel.fold_weights(state.sample))
        kind = "fused" if dev.type == "cuda" else "plain"
        for b in range(iterations):
            with profiling.span("step.bounce"):
                with profiling.span("isect"):
                    res = intersect_fn(Rays(p=(S[RAYP], S[RAYP + 1],
                                               S[RAYP + 2]),
                                            d=(S[RAYD], S[RAYD + 1],
                                               S[RAYD + 2])))
                hit, kd_scale = _hit_rows(res)
                last = b == iterations - 1
                with profiling.span("step.shade"):
                    out = bounce(S, flags, hit, kd_scale, cam, mats, table,
                                 s_idx, b + 1, tile_key, counter,
                                 fold if last else None)
                profiling.count("step.bounces." + kind)
            if not last:
                S, flags = out
        new_state = megakernel.TraceState(
            colors=(out[0], out[1], out[2]), rng_state=state.rng_state,
            sample=state.sample + 1)
    if with_stats:
        return new_state, counter[0].to(torch.float32)
    return new_state
