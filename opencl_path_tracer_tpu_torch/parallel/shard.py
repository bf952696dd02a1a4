"""Multi-device progressive rendering on torch.distributed.

Port of `opencl_path_tracer_tpu/parallel/shard.py`. The reference is
strictly single-device (one OpenCL work-item per pixel, main.cpp:674,678).
Progressive path tracing is additive, so two shardings scale it out over
the ranks of a `parallel.mesh.make_render_mesh` mesh:

  * TILE sharding (`make_tiled_step`, `make_tiled_wavefront_step`): rank
    k holds the k-th contiguous slice of every per-pixel or per-lane
    tensor (`shard_state`, `shard_wavefront_state`) and traces only its
    own pixels, whose global ids are k * n_local + lane. No communication
    in the step; each pixel's Lehmer stream lives on one rank, so parity
    mode matches the single-device render bit for bit. One all_reduce of
    the luminance sum gives the meter.
  * SAMPLE sharding (`make_sample_sharded_render`): every rank renders
    the whole frame with its own sample indices (rank k: k, k + n, ...)
    in fast mode, and one all_reduce averages the frames.

Where the JAX package runs one process over a `jax.sharding.Mesh`
(shard_map, psum), the port runs one process per rank
(`parallel.launch.launch`): each function here is called on every rank,
on that rank's slice, and its collectives must be reached by every rank.
They are all_reduce and all_gather only (gloo covers both on CUDA
tensors, not gather or scatter), on the default group: the mesh spans
the world (`make_render_mesh` refuses any other size), and the default
group is the backend the launcher chose, where the mesh's own group may
not be (a DeviceMesh over a gloo world on a CUDA host makes a new group
with the host's default backends).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.distributed as dist

from opencl_path_tracer_tpu_torch.core.camera import Camera
from opencl_path_tracer_tpu_torch.core.materials import MaterialsSoA
from opencl_path_tracer_tpu_torch.models import megakernel, wavefront
from opencl_path_tracer_tpu_torch.models.megakernel import TraceState


def mesh_rank(mesh) -> int:
    """This rank's coordinate on the mesh's one axis."""
    return int(mesh.get_coordinate()[0])


def _tile(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's contiguous slice of x's first axis, as its own tensor
    (the whole-frame tensor is not kept alive)."""
    world = mesh.size()
    if x.shape[0] % world:
        raise ValueError(f"{x.shape[0]} lanes do not divide evenly over "
                         f"{world} devices")
    m = x.shape[0] // world
    lo = mesh_rank(mesh) * m
    return x[lo:lo + m].clone()


def all_gather_lanes(x: torch.Tensor, mesh) -> torch.Tensor:
    """The ranks' x concatenated in rank order along the first axis, on
    every rank (each rank's x of one shape). bool goes as uint8."""
    is_bool = x.dtype == torch.bool
    src = (x.to(torch.uint8) if is_bool else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size())]
    dist.all_gather(parts, src)
    out = torch.cat(parts)
    return out.bool() if is_bool else out


def _lanes_map(st, fields, fn):
    """st with fn applied to each named lane field (each V3 component)."""
    return dataclasses.replace(st, **{
        f: (tuple(fn(c) for c in getattr(st, f))
            if isinstance(getattr(st, f), tuple) else fn(getattr(st, f)))
        for f in fields})


def shard_state(state: TraceState, mesh) -> TraceState:
    """This rank's tile of a whole-frame TraceState: its slice of colors
    and rng_state; the sample counter is replicated."""
    return _lanes_map(state, ("colors", "rng_state"),
                      lambda x: _tile(x, mesh))


def gather_state(state: TraceState, mesh) -> TraceState:
    """The whole-frame TraceState from the ranks' tiles, on every rank."""
    return _lanes_map(state, ("colors", "rng_state"),
                      lambda x: all_gather_lanes(x, mesh))


class WavefrontStateSpec(NamedTuple):
    """The WavefrontState fields by placement: `lane`, split across the
    ranks; `replicated`, the same on every rank."""

    lane: tuple
    replicated: tuple


def wavefront_state_spec() -> WavefrontStateSpec:
    """Every lane field of WavefrontState is sharded on the render axis;
    the step counter is replicated."""
    names = tuple(f.name for f in dataclasses.fields(wavefront.WavefrontState))
    return WavefrontStateSpec(lane=tuple(n for n in names if n != "step"),
                              replicated=("step",))


def shard_wavefront_state(state, mesh):
    """This rank's lanes of a WavefrontState: its slice of every per-lane
    tensor (colors, rng, ray, factors, pixel binding); the step counter
    is replicated."""
    return _lanes_map(state, wavefront_state_spec().lane,
                      lambda x: _tile(x, mesh))


def gather_wavefront_state(state, mesh):
    """The WavefrontState of every rank's lanes in rank order, on every
    rank (the ranks' lane counts equal)."""
    return _lanes_map(state, wavefront_state_spec().lane,
                      lambda x: all_gather_lanes(x, mesh))


def _mean_luminance(colors, lanes: int, mesh) -> torch.Tensor:
    """The world's mean of every lane's three colour channels: this
    rank's float32 sum, all_reduce'd, over lanes x world x 3."""
    lum = sum(c.sum() for c in colors)
    dist.all_reduce(lum)
    return lum / (lanes * mesh.size() * 3)


def make_tiled_step(cam: Camera, mats: MaterialsSoA, mesh, *,
                    intersect_fn, iterations: int, mode: str = "parity",
                    key=None, env=None, nee=None, qmc: bool = False,
                    dof=None, occluded_fn=None):
    """One progressive sample, the framebuffer tiled across the mesh.

    Returns step(state) -> (state, mean_luminance): state is this rank's
    tile (`shard_state`), traced as pixels rank * n_local + lane (the
    tile's first id keys the fast-mode, NEE, map and lens draws, as in
    the JAX package); mean_luminance is the world's mean, a 0-dim tensor
    from one all_reduce (the live render meter)."""
    rank = mesh_rank(mesh)

    def step(state: TraceState):
        n_local = state.rng_state.shape[0]
        new = megakernel.trace_sample(
            cam, mats, state, intersect_fn=intersect_fn,
            iterations=iterations, mode=mode, key=key, ids=rank * n_local,
            env=env, nee=nee, qmc=qmc, dof=dof, occluded_fn=occluded_fn)
        return new, _mean_luminance(new.colors, n_local, mesh)

    return step


def make_tiled_wavefront_step(cam: Camera, mats: MaterialsSoA, mesh, *,
                              intersect_fn, iterations: int,
                              mode: str = "parity", key=None,
                              max_samples: int | None = None, env=None,
                              nee=None, rr=None, qmc: bool = False,
                              dof=None, variance_tol: float | None = None,
                              min_samples: int = 8, occluded_fn=None):
    """One wavefront step, the lane axis tiled across the mesh.

    The wavefront state is lane-local (every lane carries its pixel, RNG
    stream and accumulators), so the step needs no communication: each
    rank traces its own lanes. Fast-mode counter-hash draws take the
    rank's global lane offset, rank x its current lane count (after an
    adaptive split, rank x the split size, as the JAX package's
    state.samples.shape[0] inside shard_map), so every rank draws its
    slice of the single-device streams: per-lane results equal the
    single-device `wavefront.wavefront_step`'s in both modes.

    Returns step(state) -> (state, mean_luminance), state this rank's
    lanes (`shard_wavefront_state`), mean_luminance one all_reduce."""
    rank = mesh_rank(mesh)

    def step(state):
        new = wavefront.wavefront_step(
            cam, mats, state, intersect_fn=intersect_fn,
            iterations=iterations, mode=mode, key=key,
            max_samples=max_samples, env=env, nee=nee, rr=rr, qmc=qmc,
            dof=dof, occluded_fn=occluded_fn, variance_tol=variance_tol,
            min_samples=min_samples, lane_offset=rank * state.lanes)
        return new, _mean_luminance(new.colors, new.lanes, mesh)

    return step


def make_shard_sort_open_first(mesh):
    """sort(state, open_mask): the rank-local open-first lane permutation
    of adaptive compaction (`wavefront.sort_open_first` on this rank's
    lanes; no lane crosses ranks). Lane order is free, so per-rank parking
    changes which lanes park together, never a lane's result."""
    del mesh   # rank-local: the mesh's shape does not enter
    return wavefront.sort_open_first


def make_shard_split(mesh, n_local: int):
    """split(state) -> (head, tail): the first n_local lanes of each rank
    stay live, the rest park (`wavefront.state_split` on this rank's
    lanes; every rank keeps the same count)."""
    del mesh   # rank-local

    def split(state):
        return wavefront.state_split(state, n_local)

    return split


def make_sample_sharded_render(cam: Camera, mats: MaterialsSoA, mesh, *,
                               intersect_fn, iterations: int,
                               num_pixels: int, samples_per_device: int,
                               key):
    """Offline high-spp render: rank k renders samples k + i * world of
    the whole frame (fast mode), then one all_reduce averages the ranks'
    frames, as the JAX package's pmean.

    Returns render() -> (num_pixels, 3), the mean of samples_per_device x
    world samples, the same on every rank."""
    rank, world = mesh_rank(mesh), mesh.size()

    def render() -> torch.Tensor:
        dev = cam.eye.device
        z = torch.zeros(num_pixels, dtype=torch.float32, device=dev)
        state = TraceState(colors=(z, z.clone(), z.clone()),
                           rng_state=torch.zeros(num_pixels,
                                                 dtype=torch.int64,
                                                 device=dev),
                           sample=0)
        for i in range(samples_per_device):
            state = megakernel.trace_sample(
                cam, mats, state, intersect_fn=intersect_fn,
                iterations=iterations, mode="fast", key=key,
                sample_index=rank + i * world)
        # state.colors is the mean of this rank's samples; the frame's is
        # the mean over ranks (equal sample counts).
        out = torch.stack(state.colors, dim=-1)
        dist.all_reduce(out)
        return out / world

    return render


def gather_colors(state, mesh=None) -> torch.Tensor:
    """The framebuffer, (N, 3), on the state's device: a TraceState's
    colors, gathered over the mesh's ranks (every rank gets the frame)
    when a mesh is given."""
    colors = torch.stack(state.colors, dim=-1)
    return colors if mesh is None else all_gather_lanes(colors, mesh)
