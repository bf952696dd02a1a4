"""Rank-side scenarios of the port's multi-device tests.

The tests start one world of ranks per file (`parallel.launch.launch`,
gloo on the CPU) and call `run` in it. This module never imports JAX: a
spawned rank imports the module of the function it runs, and the test
files import JAX at their top. Each rank sets its own thread count and
any module constant a scenario needs (a monkeypatch of the parent does
not reach a child).

Every scenario returns numpy values: a sharded result as this rank's
rows (the test concatenates them in rank order and holds them against
single-device runs and against the JAX package), a replicated one as it
is. The scenes, cameras and intersectors are built by the functions
below, which the tests call too, so both sides use the same inputs.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from opencl_path_tracer_tpu_torch import interop
from opencl_path_tracer_tpu_torch.config import CameraConfig, RenderConfig
from opencl_path_tracer_tpu_torch.models import megakernel, spectral
from opencl_path_tracer_tpu_torch.models import wavefront
from opencl_path_tracer_tpu_torch.ops import envmap, intersect, nee, rng
from opencl_path_tracer_tpu_torch.ops.kernels.plucker_kernel import (
    make_minarg_intersect,
)
from opencl_path_tracer_tpu_torch.ops.kernels.sorted_intersect import (
    make_pair_intersect,
)
from opencl_path_tracer_tpu_torch.ops.kernels.sphere_kernel import (
    make_sphere_intersect,
)
from opencl_path_tracer_tpu_torch.ops.kernels.tilecull_kernel import (
    make_scene_occluded,
)
from opencl_path_tracer_tpu_torch.ops.shading import smooth_hit_normals
from opencl_path_tracer_tpu_torch.parallel import shard
from opencl_path_tracer_tpu_torch.parallel.mesh import (
    RENDER_AXIS, make_render_mesh,
)
from opencl_path_tracer_tpu_torch.runtime import engine
from opencl_path_tracer_tpu_torch.scene import library

W, H = 16, 4          # the frame of the step scenarios: 64 pixels
PAIR_KW = dict(cluster_size=128, l1=2, l2=4, l3=8, trp=128, trb=128,
               tail=128, mxu=True, thin=True, move="sort")
LEG_STEPS = 2         # wavefront steps of each dryrun leg


# --- inputs shared with the tests ------------------------------------------

def bruteforce(scene):
    return functools.partial(intersect.first_intersect, tris=scene.tris)


def with_spheres(scene):
    """The dryrun's analytic composition: minarg triangles min-merged with
    the sphere kernel."""
    tri_fn = make_minarg_intersect(scene.tris)
    sph_fn = make_sphere_intersect(scene.spheres)

    def isect(rays):
        return intersect.merge_hits(tri_fn(rays), sph_fn(rays))

    return isect


def smooth_pair(scene):
    ids_fn = make_pair_intersect(scene.tris, with_ids=True, **PAIR_KW)

    def isect(rays):
        hits, ids = ids_fn(rays)
        return smooth_hit_normals(hits, ids, scene.attribs)

    return isect


def flagship():
    """`__graft_entry__._flagship`: the Cornell box with spheres through
    the LBVH (leaves of 4)."""
    from opencl_path_tracer_tpu_torch.accel import (
        build_lbvh, make_bvh_intersect,
    )
    scene = library.cornell_box(with_spheres=True)
    return scene, make_bvh_intersect(build_lbvh(scene.tris, leaf_size=4))


def wf_case(name):
    """(scene, intersector, iterations, steps, init kwargs, step kwargs)
    of a wavefront step scenario: the twins of tests/test_parallel.py
    ('wf_parity', 'wf_fast', 'pair', 'nee_sphere', 'env_nee') and the
    wavefront legs of `__graft_entry__.dryrun_multichip` ('leg3'-'leg9')."""
    key = rng.key(5)
    fast = dict(mode="fast", key=key)
    par = dict(mode="parity")
    if name in ("wf_parity", "wf_fast"):
        scene = library.cornell_box(with_spheres=False)
        kw = par if name == "wf_parity" else fast
        return scene, bruteforce(scene), 3, 5, kw, kw
    if name == "pair":
        scene = library.stress_scene(1200)
        return (scene, make_pair_intersect(scene.tris, **PAIR_KW), 2, 2,
                par, par)
    if name == "nee_sphere":
        scene = library.cornell_box(with_spheres=False, sphere_lamp=True)
        tab = nee.build_emitter_table(scene.tris, scene.mats, scene.spheres)
        return (scene, engine.make_intersect_fn(scene, "bruteforce"), 3, 4,
                fast, dict(fast, nee=tab))
    if name == "env_nee":
        scene = library.cornell_box(with_spheres=False)
        env = envmap.build_envmap(envmap.sun_sky(res=(64, 32)),
                                  sample_res=(32, 16), nee=True)
        return (scene, engine.make_intersect_fn(scene, "bruteforce"), 3, 4,
                fast, dict(fast, env=env))
    if name == "leg3":
        scene, isect = flagship()
        return scene, isect, 3, LEG_STEPS, par, par
    if name == "leg4":
        scene = library.stress_scene(1200)
        return (scene, make_pair_intersect(scene.tris, **PAIR_KW), 2,
                LEG_STEPS, par, par)
    if name == "leg5":
        scene = library.cornell_box(with_spheres=True, analytic_spheres=True)
        return scene, with_spheres(scene), 2, LEG_STEPS, par, par
    if name == "leg6":
        scene = library.stress_scene(1200, smooth=True)
        return scene, smooth_pair(scene), 2, LEG_STEPS, par, par
    if name == "leg7":
        scene = library.cornell_box(with_spheres=True, analytic_spheres=True,
                                    sphere_lamp=True)
        tab = nee.build_emitter_table(scene.tris, scene.mats, scene.spheres)
        lens = dict(fast, qmc=True, dof=(5.0, 900.0))
        return (scene, with_spheres(scene), 3, LEG_STEPS, lens,
                dict(lens, max_samples=4, nee=tab, rr=(2, 0.05),
                     variance_tol=0.1, min_samples=2,
                     occluded_fn=make_scene_occluded(scene, gs=8)))
    if name == "leg8":
        scene = library.many_light_scene(6)
        tab = nee.build_emitter_table(scene.tris, scene.mats, scene.spheres,
                                      select="distance")
        return (scene, with_spheres(scene), 3, LEG_STEPS, fast,
                dict(fast, max_samples=4, nee=tab))
    if name == "leg9":
        scene = library.cornell_box(with_spheres=True, analytic_spheres=True)
        mats = spectral.dispersive_materials(scene.mats, 465.0, v_d=20.0)
        return (dataclasses.replace(scene, mats=mats), with_spheres(scene),
                2, LEG_STEPS, par, par)
    raise KeyError(name)


def wf_init(name):
    """The whole-frame initial state of a wavefront scenario."""
    scene, _, _, _, init_kw, _ = wf_case(name)
    return wavefront.init_wavefront(library.cornell_camera(W, H), W * H,
                                    seed=1, **init_kw)


def wf_single(name):
    """The port's single-device steps of a wavefront scenario."""
    scene, isect, iters, steps, _, kw = wf_case(name)
    cam = library.cornell_camera(W, H)
    st = wf_init(name)
    for _ in range(steps):
        st = wavefront.wavefront_step(cam, scene.mats, st,
                                      intersect_fn=isect, iterations=iters,
                                      **kw)
    return st


def lanes_np(st) -> dict:
    """A WavefrontState's lane fields as numpy, the step as an int."""
    return interop.wavefront_state_to_numpy(st)


# --- the rank side -----------------------------------------------------------

def run(names, world: int) -> dict:
    """Each named scenario on this rank (threads: one). Returns name ->
    its result."""
    torch.set_num_threads(1)
    mesh = make_render_mesh(world)
    return {name: SCENARIOS[name.split(":")[0]](mesh, name) for name in names}


def _mesh_info(mesh, _name):
    try:
        make_render_mesh(mesh.size() + 1)
        refused = ""
    except ValueError as e:
        refused = str(e)
    return dict(rank=shard.mesh_rank(mesh), size=mesh.size(),
                names=tuple(mesh.mesh_dim_names), axis=RENDER_AXIS,
                refused=refused)


def _tiled(mesh, _name):
    """tests/test_parallel.py's tiled parity step, 3 samples at 3
    bounces; the meter after each."""
    scene = library.cornell_box(with_spheres=False)
    step = shard.make_tiled_step(library.cornell_camera(W, H), scene.mats,
                                 mesh, intersect_fn=bruteforce(scene),
                                 iterations=3, mode="parity")
    st = shard.shard_state(megakernel.init_state(W * H, 1), mesh)
    lums = []
    for _ in range(3):
        st, lum = step(st)
        lums.append(float(lum))
    gathered = shard.gather_colors(st, mesh).numpy()
    return dict(colors=megakernel.colors_array(st).numpy(),
                rng=st.rng_state.numpy(), sample=st.sample, lums=lums,
                gathered=gathered)


def _subset(mesh, _name):
    """test_tiled_step_on_subset_mesh: 16x16, one parity sample at 2
    bounces."""
    w = h = 16
    scene = library.cornell_box(with_spheres=False)
    step = shard.make_tiled_step(library.cornell_camera(w, h), scene.mats,
                                 mesh, intersect_fn=bruteforce(scene),
                                 iterations=2, mode="parity")
    st, lum = step(shard.shard_state(megakernel.init_state(w * h, 1), mesh))
    return dict(sample=st.sample, lum=float(lum), size=mesh.size(),
                colors=megakernel.colors_array(st).numpy(),
                rng=st.rng_state.numpy())


def _sample_sharded(mesh, name):
    """make_sample_sharded_render: 'sample' is the twin of
    test_sample_sharded_render_equals_single_device (4 samples a rank,
    key 11, 3 bounces); 'leg2' the dryrun's (the flagship, 1 a rank)."""
    if name == "leg2":
        scene, isect = flagship()
        spd, key = 1, rng.key(1)
    else:
        scene = library.cornell_box(with_spheres=False)
        isect, spd, key = bruteforce(scene), 4, rng.key(11)
    render = shard.make_sample_sharded_render(
        library.cornell_camera(W, H), scene.mats, mesh, intersect_fn=isect,
        iterations=3, num_pixels=W * H, samples_per_device=spd, key=key)
    return render().numpy()


def _leg1(mesh, _name):
    """The dryrun's leg 1: the tiled parity step with the dormant sky on
    the flagship."""
    scene, isect = flagship()
    step = shard.make_tiled_step(library.cornell_camera(W, H), scene.mats,
                                 mesh, intersect_fn=isect, iterations=3,
                                 mode="parity", env=megakernel.EnvLight())
    st, lum = step(shard.shard_state(megakernel.init_state(W * H, 1), mesh))
    return dict(colors=megakernel.colors_array(st).numpy(),
                rng=st.rng_state.numpy(), sample=st.sample, lum=float(lum))


def _wavefront(mesh, name):
    """A wavefront scenario (`wf_case`) through make_tiled_wavefront_step:
    this rank's lanes after its steps, and the last meter."""
    scene, isect, iters, steps, _, kw = wf_case(name)
    step = shard.make_tiled_wavefront_step(
        library.cornell_camera(W, H), scene.mats, mesh, intersect_fn=isect,
        iterations=iters, **kw)
    st = shard.shard_wavefront_state(wf_init(name), mesh)
    for _ in range(steps):
        st, lum = step(st)
    return dict(lanes=lanes_np(st), lum=float(lum))


def _partition_4k(mesh, _name):
    """The 4K frame's partition (tests/test_parallel.py's 4K shape test,
    cut to the ids): this rank's contiguous tile of 3840 x 2160 pixel
    ids, their gather, and the meter over 4K lanes of ones."""
    n = 3840 * 2160
    ids = torch.arange(n, dtype=torch.int32)
    tile = shard._tile(ids, mesh)
    back = shard.all_gather_lanes(tile, mesh)
    ones = (torch.ones(tile.shape[0]),) * 3
    return dict(first=int(tile[0]), last=int(tile[-1]), lanes=tile.shape[0],
                gathered=bool(torch.equal(back, ids)),
                lum=float(shard._mean_luminance(ones, tile.shape[0], mesh)))


# --- the engine's sharded paths ------------------------------------------------

EW, EH = 16, 8   # the engine scenarios' frame


def engine_cfg(devices=1, **kw):
    base = dict(width=EW, height=EH, iterations=3, mode="parity",
                accel="bruteforce", devices=devices,
                camera=CameraConfig(fov=60.0, yaw=0.0, pitch=0.0,
                                    shift=(0.0, 0.0, 0.0)))
    base.update(kw)
    return RenderConfig(**base)


def make_engine(devices=1, scene=None, **kw):
    return engine.RenderEngine(scene or library.cornell_box(with_spheres=True),
                               engine_cfg(devices, **kw), device="cpu")


def _engine_mega(mesh, _name):
    """devices=world, the megakernel in parity mode: 4 samples with the
    meter (estimated_rays' collective), the image, the rays; a checkpoint
    at 2 samples (written by rank 0) and the resume of a single-device
    checkpoint made here by rank 0; frame()'s refusal."""
    world = mesh.size()
    eng = make_engine(world)
    eng.render(4, progress=True)
    out = dict(image=eng.image(apply_tonemap=False), rays=eng.rays_traced,
               est=eng.estimated_rays(4), rank=eng._rank)
    try:
        eng.frame(0.016)
        out["frame"] = ""
    except ValueError as e:
        out["frame"] = str(e)
    tmp = os.environ["PTX_TEST_TMP"]
    half = make_engine(world)
    half.render(2, progress=False)
    half.save(os.path.join(tmp, f"mega{world}.npz"))
    if eng._rank == 0:
        one = make_engine(1)
        one.render(2, progress=False)
        one.save(os.path.join(tmp, "mega1.npz"))
    # every rank reads mega1.npz only after rank 0 wrote it
    torch.distributed.barrier()
    resumed = make_engine(world)
    resumed.load(os.path.join(tmp, "mega1.npz"))
    resumed.render(2, progress=False)
    out["resumed"] = resumed.image(apply_tonemap=False)
    out["display"] = resumed.display_u8()
    out["display_device"] = resumed.display_u8_device()
    return out


def _engine_fast_tiles(mesh, _name):
    """devices=world, the megakernel in fast mode with NEE: this rank's
    tile after 2 samples (keyed on its first pixel id)."""
    eng = make_engine(mesh.size(), mode="fast", nee=True)
    eng.render(2, progress=False)
    return megakernel.colors_array(eng.state).numpy()


def _engine_wavefront(mesh, name):
    """devices=world, the wavefront in parity or fast mode: 3 samples, the
    image, the floor; a checkpoint at 2 samples, and 1 more sample after
    resuming a single-device one."""
    world = mesh.size()
    mode = name.split(":")[1]
    eng = make_engine(world, model="wavefront", mode=mode)
    eng.render(3, progress=True)
    out = dict(image=eng.image(apply_tonemap=False),
               floor=eng._sample_host, rays=eng.rays_traced,
               steps=eng.steps_run)
    tmp = os.environ["PTX_TEST_TMP"]
    half = make_engine(world, model="wavefront", mode=mode)
    half.render(2, progress=False)
    half.save(os.path.join(tmp, f"wf_{mode}{world}.npz"))
    return out


def _engine_adaptive(mesh, _name):
    """tests/test_adaptive.py's mesh-sharded adaptive render (32x16, 3
    bounces, parity, tol 0.25, 2 to 12 samples) with the bucket floor
    lowered to 32 so that each rank's 256 lanes halve."""
    engine.ADAPTIVE_MIN_BUCKET = 32
    eng = make_engine(mesh.size(), width=32, height=16, model="wavefront",
                      spp=12)
    eng.render_adaptive(0.25, max_spp=12, min_spp=2, progress=False)
    whole = shard.gather_wavefront_state(eng.state, mesh)
    return dict(colors=wavefront.colors_by_pixel(whole, 32 * 16).numpy(),
                pixel=eng.state.pixel.numpy(),
                samples=eng.state.samples.numpy(),
                buckets=list(eng.adaptive_buckets), floor=eng._sample_host,
                whole=lanes_np(whole))


def _engine_errors(mesh, _name):
    """The engine's refusals inside a world: a frame that does not divide
    over the ranks, and a devices count that is not the world's."""
    out = {}
    for key, kw in (("divide", dict(width=15, height=3)),
                    ("count", dict())):
        devices = mesh.size() + (1 if key == "count" else 0)
        try:
            make_engine(devices, **kw)
            out[key] = ""
        except ValueError as e:
            out[key] = str(e)
    return out


SCENARIOS = {
    "mesh": _mesh_info, "tiled": _tiled, "subset": _subset,
    "sample": _sample_sharded, "leg2": _sample_sharded, "leg1": _leg1,
    "4k": _partition_4k,
    **{n: _wavefront for n in ("wf_parity", "wf_fast", "pair", "nee_sphere",
                               "env_nee", "leg3", "leg4", "leg5", "leg6",
                               "leg7", "leg8", "leg9")},
    "engine_mega": _engine_mega, "engine_fast_tiles": _engine_fast_tiles,
    "engine_wavefront": _engine_wavefront,
    "engine_adaptive": _engine_adaptive, "engine_errors": _engine_errors,
}


def launch_world(names, world: int, tmp: str | None = None):
    """run(names) on a gloo world of `world` CPU ranks; the ranks'
    results in rank order. tmp: a directory the engine scenarios write
    their checkpoints to."""
    from opencl_path_tracer_tpu_torch.parallel.launch import launch
    if tmp is not None:
        os.environ["PTX_TEST_TMP"] = tmp
    return launch(run, world, (tuple(names), world), device="cpu")

