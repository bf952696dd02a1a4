"""The fused fast-mode pipeline: Plucker intersect, rotating exact slice
and fused step, all on packed lane state.

Port of `opencl_path_tracer_tpu/models/pipeline.py`: `make_fast_pipeline`
and `render_fast`. Each step:

 1. K13a + K13b (`make_plucker_intersect(...).rows`) straight off the
    packed ray rows: candidates, exact refine, pending flags.
 2. The rotating exact slice: lanes [s L, (s + 1) L), s = step mod
    n_slices, go through K4 and overwrite their rows (pending cleared).
    This is the net that turns the refine's rare PENDING lanes into exact
    results within n_slices steps.
 3. K5, the fused shade / terminate / regenerate step; pending lanes
    freeze.

Spheres are refused: this pipeline intersects triangles only. The
unfused `models/wavefront.py` stays the parity path.
"""

from __future__ import annotations

import time

import torch

from opencl_path_tracer_tpu_torch.models import fused_step as fs
from opencl_path_tracer_tpu_torch.models import wavefront
from opencl_path_tracer_tpu_torch.ops import raygen
from opencl_path_tracer_tpu_torch.ops.kernels.intersect_kernel import (
    build_tri_pack, dense,
)
from opencl_path_tracer_tpu_torch.ops.kernels.plucker_kernel import (
    make_plucker_intersect,
)
from opencl_path_tracer_tpu_torch.utils.device import resolve_device


def make_fast_pipeline(scene, cam, *, width: int, height: int,
                       iterations: int, key, tr: int = 1024,
                       n_slices: int = 32, lanes: int = 1):
    """(state0, step, unpack): state0 = (F, I, ctr) on the camera's
    device, step(F, I, ctr) -> (F, I, ctr + 1), unpack(F, I, ctr) ->
    WavefrontState; step.hit_rows(F, ctr) gives the step's (6, N) hit rows
    [t, nx, ny, nz, mati, pending].

    The lane count, width * height * lanes, is rounded up to a multiple of
    tr; the pad lanes render extra samples of pixel 0. The exact slice is
    a whole number of tr-lane blocks: n_slices becomes the largest divisor
    of the block count not above the request (1080p at tr = 1024: 2,025
    blocks, 27 slices of 76,800 lanes; the JAX comment at pipeline.py:91
    says 25, but 27 divides 2,025)."""
    if getattr(scene, "spheres", None) is not None:
        raise ValueError(
            "the fused pipeline intersects triangles only; analytic-sphere "
            "scenes would render silently wrong. Use the wavefront model "
            "(RenderConfig(model='wavefront')), which min-merges the "
            "sphere kernel.")
    dev = cam.eye.device
    if width % 16 == 0 and height % 8 == 0:
        ids = raygen.tile_major_ids(width, height, 16, 8, device=dev)
    else:
        ids = raygen.pixel_ids_like(width * height, device=dev)
    if lanes > 1:
        ids = ids.repeat(lanes)
    n = -(-ids.shape[0] // tr) * tr
    if n != ids.shape[0]:
        ids = torch.cat([ids, torch.zeros(n - ids.shape[0], dtype=ids.dtype,
                                          device=dev)])
    st = wavefront.init_wavefront(cam, n, mode="fast", key=key, ids=ids)
    state0 = fs.pack_state(st, width, height)

    plucker = make_plucker_intersect(scene.tris)
    fstep = fs.make_fused_step(cam, scene.mats, width=width, height=height,
                               iterations=iterations, key=key)
    tri_pack = build_tri_pack(scene.tris)
    n_blocks = n // tr
    n_slices = max(d for d in range(1, n_slices + 1) if n_blocks % d == 0)
    sl_len = n // n_slices

    def hit_rows(F, ctr: int) -> torch.Tensor:
        # Rows 3-8 of F are the ray; the ray kernels read rows 0-5 of an
        # (8, N) pack, so F's rows 3-10 serve in place.
        rays8 = F[fs._RAYP:fs._RAYP + 8]
        h = plucker.rows(rays8)
        s = (ctr % n_slices) * sl_len
        # K4 writes the slice's exact rows (pending cleared) into h.
        dense(rays8[:, s:s + sl_len], tri_pack, out=h[:, s:s + sl_len])
        return h

    def step(F, I, ctr: int):
        F2, I2 = fstep(F, I, ctr, hit_rows(F, ctr))
        return F2, I2, ctr + 1

    step.hit_rows = hit_rows
    step.n_slices = n_slices

    def unpack(F, I, ctr):
        return fs.unpack_state(F, I, ctr)

    return state0, step, unpack


def render_fast(scene, cam, *, width: int, height: int, iterations: int,
                steps: int, key, lanes: int = 1, device=None):
    """Two warm-up steps, then `steps` timed steps ending in a
    synchronise, on `device` (CUDA unless "cpu" is asked for; scene and
    cam must live there). Returns (WavefrontState, seconds, samples): the
    state has taken steps + 2 steps, and `samples` is the number of
    samples the lanes finished in the timed steps (read before and after
    them, outside the timing). The JAX `render_fast` returns the first
    two only."""
    dev = resolve_device(device)
    if cam.eye.device.type != dev.type or scene.tris.device.type != dev.type:
        raise ValueError(f"scene and cam must be on {dev}")
    (F, I, ctr), step, unpack = make_fast_pipeline(
        scene, cam, width=width, height=height, iterations=iterations,
        key=key, lanes=lanes)
    for _ in range(2):
        F, I, ctr = step(F, I, ctr)
    warm = int(I[fs._SAMP].sum())          # synchronises
    t0 = time.perf_counter()
    for _ in range(steps):
        F, I, ctr = step(F, I, ctr)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    return unpack(F, I, ctr), secs, int(I[fs._SAMP].sum()) - warm
