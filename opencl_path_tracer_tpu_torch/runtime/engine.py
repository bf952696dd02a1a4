"""Progressive render engine (offline path).

Port of `make_intersect_fn` (with `_make_textured_fn` and
`_make_ids_tri_fn`) and of `RenderEngine.__init__`, `frame`, `render`
(with `_render_wavefront`, autosave and the progress meter),
`render_adaptive`, `adaptive_prediction`, `render_adaptive_auto`,
`reset_accumulation`, `estimated_rays`, `display_u8`,
`display_u8_device`, `image`, `save_png`, `denoised_image`, `save_hdr`,
`save` and `load` from `opencl_path_tracer_tpu/runtime/engine.py`, with
their sharded paths (devices != 1, `RenderEngine`'s docstring; the
reference's frame loop, main.cpp:683-687 and 1171-1241). The engine owns
the progressive state on its device, in the megakernel model
(TraceState) or the wavefront model (WavefrontState), the camera
controller (the pose, the bounce depth and the input flags:
`runtime/controller.py`), the 1 Hz meter (`runtime/meter.py`) and the
intersector.

Accel choice: 'auto' without a camera resolves to 'minarg' (K1 + K2) up
to 8,192 triangles and to 'pairwin' above, the JAX package's cut
(engine.py:380-393). Given a camera (`make_intersect_fn(cam=...)`, as
the engine and the CLI build it) on CUDA, a scene of at most 8,192
triangles takes the host predictor's pick instead
(`tilecull_kernel.auto_small_accel` at AUTO_TILECULL_THRESHOLD, which an
H100 measurement set; PERF.md): 'tilecull' where the camera's sampled
rays need a small enough share of K6's groups, else 'minarg'; the CPU
keeps 'minarg'. The pick depends on the bounce depth, so an engine
whose accel is 'auto' re-picks when the controller's depth changes
(`_maybe_repick_accel`, called by `_trace` and `_wf_steps`), caching
one intersector per depth; an injected intersect_fn is never replaced.
The returned intersector carries the resolved name as `.accel`.
'pairwin' is the pair-expansion intersector in the TPU's production
configuration (`PAIR_TPU_WINNER`: K4 seeds from the scene-spanning
triangles, K9 and K10 test rays against their nearest Morton clusters,
K4 certifies the rest, K11 fetches the winners' attributes).
'bruteforce' is the plain PyTorch reference and is refused on CUDA, so
no plain version carries the main path on the card. 'pallas' is K4, the
dense exact intersector with attributes; 'tilecull' is K6 with groups
ordered front to back from the camera eye, then K2. 'pair' is the same
pair intersector at its own defaults (the VPU pairs round K12 on Morton
clusters of 512, K9 on their boxes, the full attribute payload, no K11);
'cluster' is K17 (per-tile cluster lists, `make_cluster_intersect`);
'group' is K16 (mask-sorted rays, scenes of at most 30 clusters,
`make_group_intersect`). 'march' is the block march (K18 rounds 1 and 2
after their K18m copies, K4 tail; `make_march_intersect` at cs = tr =
512, K1 = 24, K2 = 64) and 'flat' the flat visit list (K18 round 0, K19,
K4 tail; `make_flat_march_intersect` at cs = tr = 256, K0 = 4), the JAX
engine's defaults (engine.py:435-450); their hits report no triangle
ids, so smooth shading refuses them. 'pairmx' is the pair intersector
with K10's full payload (`make_pair_intersect(mxu=True, trp=512)`, the
JAX engine's kwargs: Morton clusters of 512, K9, K10 writing five
streams, K4 seed and tail). 'bvh' is the LBVH (`accel.build_lbvh`,
leaves of 4) and 'median' the reference's own tree (`accel.
build_median_tree(split='midpoint_mean')`, one subtree per object of
`scene.object_ranges`), both walked by `accel.make_bvh_intersect`,
plain PyTorch with no hand-written kernel (the JAX package has none
either): on CUDA they are refused unless `force=True` (`accel_force`,
`--accel-force`), for the card's own reason, their times (PERF.md
section 5). None of the three reports ids, so smooth shading and
textures refuse them too. 'auto' never picks these eight, and
the port prints none of the JAX package's TPU-only warnings about them.
The JAX package's 'auto' on a CPU host picks 'bvh' above 4,096
triangles and 'bruteforce' below, a speed policy for a CPU host; the
port's 'auto' resolves as above on every device. Analytic spheres go
through K3 (K3b above 64) and are min-merged after the triangles. With
`smooth`, the triangle winner's normal is the interpolated vertex normal
(`_make_smooth_tri_fn`): 'auto' is 'minarg' (K1 then K8) up to 4,096
triangles and 'pairwin' with ids (K1 + K2 seed, K1 tail) and
`smooth_hit_normals` above, as the JAX package routes it
(engine.py:334-356); the 4,096 cap comes from its kernel holding the
whole one-hot table in the TPU's VMEM, and the port carries it over as
the starting choice without a GPU measurement. Where the predictor
picks 'minarg' above 4,096 triangles for a smooth (untextured) path, the
port takes 'pairwin', smooth 'auto''s choice there; the JAX engine
passes 'minarg' on and its smooth minarg refuses (ROADMAP.md queue 3).
The textured path takes the pick as given. With `textured`, the
intersector returns (Hits, kd_scale) (`_make_textured_fn`): an
ids-reporting accel resolved as for smooth shading ('auto': 'minarg',
K1 with ids then K2, up to 4,096 triangles, 'pairwin' with ids above;
'tilecull' is K6 with ids; with `smooth`, `smooth_hit_normals` after the
ids intersector, not K8), the spheres merged after it, the hit's UVs and
the atlas sample (`core.textures.kd_scale`). With `nee`, the engine
builds the emitter table. With an environment map (`env_map`) it builds
`ops.envmap.EnvMap` (`env_nee`: the gather and its escape rays), with
`env_light` the dormant sky (`megakernel.EnvLight`). Whenever NEE or the
map's gather traces shadow rays and `nee_anyhit` is on, it builds the
any-hit test (K7, or-ed with the spheres: the escape rays run it at rmax
3.0e38) and hands it to the model. `dof_aperture` > 0 gives thin-lens
camera rays.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.distributed as dist

from opencl_path_tracer_tpu_torch.accel import (
    build_lbvh, build_median_tree, make_bvh_intersect,
)
from opencl_path_tracer_tpu_torch.config import ACCELS, RenderConfig
from opencl_path_tracer_tpu_torch.core.textures import kd_scale
from opencl_path_tracer_tpu_torch.io.checkpoint import (
    load_checkpoint, save_checkpoint,
)
from opencl_path_tracer_tpu_torch.io.image import (
    to_uint8, write_pfm, write_png,
)
from opencl_path_tracer_tpu_torch.models import megakernel, wavefront
from opencl_path_tracer_tpu_torch.ops import intersect, rng
from opencl_path_tracer_tpu_torch.ops.denoise import (
    atrous_denoise, primary_aovs,
)
from opencl_path_tracer_tpu_torch.ops import tonemap as tonemap_ops
from opencl_path_tracer_tpu_torch.ops.envmap import load_envmap
from opencl_path_tracer_tpu_torch.ops.nee import build_emitter_table
from opencl_path_tracer_tpu_torch.ops.kernels.intersect_kernel import (
    make_pallas_intersect,
)
from opencl_path_tracer_tpu_torch.ops.kernels.plucker_kernel import (
    make_minarg_intersect,
)
from opencl_path_tracer_tpu_torch.ops.kernels.shading_kernel import (
    make_smooth_minarg_intersect,
)
from opencl_path_tracer_tpu_torch.ops.kernels.cluster_kernel import (
    make_cluster_intersect,
)
from opencl_path_tracer_tpu_torch.ops.kernels.flat_march import (
    make_flat_march_intersect,
)
from opencl_path_tracer_tpu_torch.ops.kernels.march_kernel import (
    make_march_intersect,
)
from opencl_path_tracer_tpu_torch.ops.kernels.sorted_intersect import (
    PAIR_TPU_WINNER, make_group_intersect, make_pair_intersect,
)
from opencl_path_tracer_tpu_torch.ops.kernels.sphere_kernel import (
    make_sphere_intersect,
)
from opencl_path_tracer_tpu_torch.ops.kernels.tilecull_kernel import (
    auto_small_accel, make_scene_occluded, make_tilecull_intersect,
)
from opencl_path_tracer_tpu_torch.ops.shading import (
    interpolate_uvs, smooth_hit_normals,
)
from opencl_path_tracer_tpu_torch.parallel import shard
from opencl_path_tracer_tpu_torch.parallel.mesh import make_render_mesh
from opencl_path_tracer_tpu_torch.runtime.controller import CameraController
from opencl_path_tracer_tpu_torch.runtime.meter import PerfMeter
from opencl_path_tracer_tpu_torch.scene.builder import Scene
from opencl_path_tracer_tpu_torch.utils import profiling
from opencl_path_tracer_tpu_torch.utils.device import resolve_device

AUTO_MINARG_MAX_TRIS = 8192
SMOOTH_MINARG_MAX_TRIS = 4096   # a TPU VMEM limit (see the docstring)
# 'auto' picks 'tilecull' on CUDA where the predicted share of K6's group
# tests is below this. Set by the rule of PERF.md's in-turn anchor table
# (megakernel wall ms a sample of 'minarg' and 'tilecull' on the JAX
# package's four anchors, H100 80GB HBM3 at 700 W,
# runtime/accel_anchors.py): 'tilecull' won all four, so 1.0, and
# 'minarg' only where every sampled tile needs every group.
AUTO_TILECULL_THRESHOLD = 1.0

# render_adaptive_auto's bars, copied from the JAX package
# (engine.py:59-61) as the starting choice: they were calibrated on TPU
# renders and no H100 measurement has re-decided them. Adaptive
# sampling goes on when the probe predicts at least this speedup
# (fixed cost over adaptive cost, the latter times the overhead of the
# checks and the compaction) and at most this share of the pixels has
# a variance of exactly zero (without NEE such pixels have not yet met
# an emitter, and their estimate lies).
ADAPTIVE_MIN_PREDICTED_SPEEDUP = 1.2
ADAPTIVE_MAX_ZERO_VAR_FRAC = 0.25
ADAPTIVE_OVERHEAD_FACTOR = 1.15
# The smallest bucket compaction halves to (the JAX engine's 4096).
ADAPTIVE_MIN_BUCKET = 4096


# The accels that run on CUDA only with force: the BVH walker's.
FORCE_ONLY = ("bvh", "median")


def resolve_accel(accel: str, num_triangles: int, on_cuda: bool,
                  smooth: bool = False, force: bool = False) -> str:
    """The triangle intersector `accel` names for this scene and device.
    smooth: the path needs the winner's index (smooth shading or
    textures), which lowers 'auto''s minarg cap to 4,096. force: run
    'bvh' or 'median' on CUDA."""
    if accel == "auto":
        cap = SMOOTH_MINARG_MAX_TRIS if smooth else AUTO_MINARG_MAX_TRIS
        return "minarg" if num_triangles <= cap else "pairwin"
    if accel == "bruteforce" and on_cuda:
        raise ValueError(
            "accel 'bruteforce' is the plain PyTorch reference and does not "
            "run on CUDA; use 'minarg' (or 'auto')")
    if accel in FORCE_ONLY and on_cuda and not force:
        raise ValueError(
            f"accel {accel!r} is refused on CUDA without force=True (CLI: "
            "--accel-force): the BVH walker (accel/traverse.py) is plain "
            "PyTorch with no hand-written kernel, dozens of launches and an "
            "(R, leaf, 16) row gather per lockstep step; its times on the "
            "card are in PERF.md section 5")
    if accel not in ACCELS:
        raise ValueError(f"unknown accel {accel!r}; the port has {ACCELS}")
    return accel


def _has_vertex_normals(scene: Scene) -> bool:
    """True when some corner normal is nonzero (a scene with texture
    coordinates only has attributes too, all of whose normals are 0)."""
    return (scene.attribs is not None
            and bool(scene.attribs.packed[:, 8:17].any()))


def _make_ids_tri_fn(scene: Scene, accel: str, what: str):
    """fn(rays) -> (Hits, ids), ids the winner's triangle index (-1 on a
    miss), for a resolved accel: 'minarg' (K1 with ids, then K2),
    'tilecull' (K6 with ids; the groups in Morton order, no camera
    origin, as the JAX package builds them for ids), 'pairwin' (with
    ids) or 'bruteforce' (the plain reference, CPU only). `what` names
    the feature in the refusal of any other accel."""
    if accel == "minarg":
        return make_minarg_intersect(scene.tris, with_ids=True)
    if accel == "tilecull":
        return make_tilecull_intersect(scene.tris, with_ids=True)
    if accel == "pairwin":
        return make_pair_intersect(scene.tris, with_ids=True,
                                   **PAIR_TPU_WINNER)
    if accel == "bruteforce":
        return functools.partial(intersect.first_intersect_ids,
                                 tris=scene.tris)
    raise ValueError(
        f"{what} needs an ids-reporting intersector (one that reports the "
        f"winner's index): 'minarg', 'tilecull', 'pairwin', 'bruteforce' "
        f"or 'auto', not {accel!r}")


def _make_smooth_tri_fn(scene: Scene, accel: str):
    """The smooth-shading triangle intersector for a resolved accel.
    'minarg' is K1 then K8 (`make_smooth_minarg_intersect`); the other
    ids-reporting accels (`_make_ids_tri_fn`) report the winner's index
    and `smooth_hit_normals` interpolates."""
    attribs = scene.attribs
    if accel == "minarg":
        if scene.num_triangles > SMOOTH_MINARG_MAX_TRIS:
            raise ValueError(
                f"accel='minarg' with smooth shading tops out at "
                f"{SMOOTH_MINARG_MAX_TRIS} triangles (the JAX package's "
                f"cap); the scene has {scene.num_triangles}")
        return make_smooth_minarg_intersect(scene.tris, attribs)
    ids_fn = _make_ids_tri_fn(scene, accel, "smooth shading")

    def smooth_fn(rays):
        hits, ids = ids_fn(rays)
        return smooth_hit_normals(hits, ids, attribs)

    return smooth_fn


def _make_sphere_fn(scene: Scene, accel: str):
    """The analytic spheres' intersector (K3, K3b above 64 spheres; the
    plain version beside 'bruteforce'), or None."""
    if scene.spheres is None:
        return None
    if accel == "bruteforce":
        return functools.partial(intersect.sphere_intersect,
                                 spheres=scene.spheres)
    return make_sphere_intersect(scene.spheres)


def _make_textured_fn(scene: Scene, accel: str, smooth: bool):
    """(Hits, kd_scale) intersector (the JAX engine's _make_textured_fn and
    _make_ids_tri_fn): the ids-reporting triangle stream (its normals
    interpolated by `smooth_hit_normals` when smooth, K8 not used), the
    sphere merge, the hit's UVs (`interpolate_uvs`) and the bilinear
    atlas sample (`core.textures.kd_scale`). A sphere winner, a miss or
    an unbound material gets exactly 1.0."""
    if scene.textures is None:
        raise ValueError(
            "textured=True but the scene has no textures; bind one with "
            "add_texture + set_material_texture, or load an OBJ whose MTL "
            "has map_Kd entries (PNG)")
    if scene.attribs is None:
        raise ValueError(
            "textured=True needs per-corner UVs; add_triangle(uv=...) or "
            "an OBJ with vt data")
    ids_fn = _make_ids_tri_fn(scene, accel, "textured rendering")
    sphere_fn = _make_sphere_fn(scene, accel)
    attribs, textures = scene.attribs, scene.textures

    def textured_fn(rays):
        tri_hits, ids = ids_fn(rays)
        if smooth:
            tri_hits = smooth_hit_normals(tri_hits, ids, attribs)
        if sphere_fn is None:
            hits, tri_won = tri_hits, tri_hits.valid
        else:
            hits = intersect.merge_hits(tri_hits, sphere_fn(rays))
            # merge_hits keeps the triangle stream on exact-t ties.
            tri_won = tri_hits.valid & hits.valid & (hits.t == tri_hits.t)
        ids = torch.where(tri_won, ids, -1)
        s, t = interpolate_uvs(hits, ids, attribs)
        return hits, kd_scale(textures, hits.mati, s, t,
                              hits.valid & (ids >= 0))

    return textured_fn


def predicted_accel(scene: Scene, cam, iterations: int,
                    smooth: bool = False) -> str:
    """'auto''s pick for a scene of at most 8,192 triangles on CUDA:
    `auto_small_accel` at AUTO_TILECULL_THRESHOLD for this camera and
    depth. smooth (an untextured smooth path): a pick of 'minarg' above
    SMOOTH_MINARG_MAX_TRIS becomes 'pairwin', smooth 'auto''s choice
    there, where the JAX engine passes 'minarg' on to a smooth minarg
    that refuses it (ROADMAP.md queue 3)."""
    accel = auto_small_accel(scene.tris, cam, iterations=iterations,
                             threshold=AUTO_TILECULL_THRESHOLD)
    if (smooth and accel == "minarg"
            and scene.num_triangles > SMOOTH_MINARG_MAX_TRIS):
        return "pairwin"
    return accel


def make_intersect_fn(scene: Scene, accel: str = "auto", origin=None,
                      smooth: bool = False, textured: bool = False,
                      cam=None, iterations: int = 5, force: bool = False):
    """intersect(rays) -> Hits over the scene's triangles, min-merged with
    its analytic spheres (the triangle stream wins exact-t ties). origin
    (the camera eye; cam.eye when a camera is given) orders the
    'tilecull' groups front to back. cam and iterations: with
    accel='auto' on CUDA and at most 8,192 triangles, the accel is the
    predictor's pick for this camera and depth (see the module's
    docstring). smooth=True interpolates the vertex normals of
    scene.attribs at the triangle hits (analytic spheres have exact
    normals already). textured=True returns (Hits, kd_scale) instead
    (`_make_textured_fn`): it needs scene.textures, the corner UVs of
    scene.attribs and an ids-reporting accel ('auto' resolves as for
    smooth shading), and composes with smooth. force: run 'bvh' or
    'median' on CUDA (see resolve_accel). The intersector's `.accel` is
    the resolved accel."""
    on_cuda = scene.tris.device.type == "cuda"
    if smooth and not _has_vertex_normals(scene):
        raise ValueError(
            "smooth=True but the scene has no vertex normals; build it "
            "with add_obj(smooth_normals=True), add_sphere(smooth=True) "
            "or add_triangle(vn=...)")
    if cam is not None and origin is None:
        origin = tuple(float(v) for v in cam.eye.cpu())
    if (accel == "auto" and cam is not None and on_cuda
            and scene.num_triangles <= AUTO_MINARG_MAX_TRIS):
        accel = predicted_accel(scene, cam, iterations, smooth and not
                                textured)
    accel = resolve_accel(accel, scene.num_triangles, on_cuda,
                          smooth or textured, force)
    fn = _make_fn(scene, accel, origin, smooth, textured)
    fn.accel = accel
    return fn


def _make_fn(scene: Scene, accel: str, origin, smooth: bool,
             textured: bool):
    """make_intersect_fn's intersector for a resolved accel."""
    if textured:
        return _make_textured_fn(scene, accel, smooth)
    if smooth:
        tri_fn = _make_smooth_tri_fn(scene, accel)
    elif accel == "minarg":
        tri_fn = make_minarg_intersect(scene.tris)
    elif accel == "pallas":
        tri_fn = make_pallas_intersect(scene.tris)
    elif accel == "tilecull":
        tri_fn = make_tilecull_intersect(scene.tris, origin=origin)
    elif accel == "pairwin":
        tri_fn = make_pair_intersect(scene.tris, **PAIR_TPU_WINNER)
    elif accel == "pairmx":
        tri_fn = make_pair_intersect(scene.tris, mxu=True, trp=512)
    elif accel == "pair":
        tri_fn = make_pair_intersect(scene.tris)
    elif accel == "bvh":
        tri_fn = make_bvh_intersect(build_lbvh(scene.tris, leaf_size=4))
    elif accel == "median":
        tri_fn = make_bvh_intersect(build_median_tree(
            scene.tris, split="midpoint_mean",
            object_ranges=scene.object_ranges))
    elif accel == "cluster":
        tri_fn = make_cluster_intersect(scene.tris)
    elif accel == "group":
        tri_fn = make_group_intersect(scene.tris)
    elif accel == "march":
        tri_fn = make_march_intersect(scene.tris)[0]
    elif accel == "flat":
        tri_fn = make_flat_march_intersect(scene.tris)[0]
    else:
        tri_fn = functools.partial(intersect.first_intersect, tris=scene.tris)
    sphere_fn = _make_sphere_fn(scene, accel)
    if sphere_fn is None:
        return tri_fn

    def with_spheres(rays):
        return intersect.merge_hits(tri_fn(rays), sphere_fn(rays))

    return with_spheres


class RenderEngine:
    """The progressive render state, its controller, meter and
    intersector (the module's docstring).

    devices != 1 renders over a mesh of that many ranks (0: the whole
    world), the JAX engine's sharded paths on torch.distributed: the
    engine is built on every rank of a world that `parallel.launch.launch`
    started (one rank a GPU with NCCL, CPU ranks with gloo; outside a
    world it raises), with this rank's device, and every rank makes the
    same calls. Each rank holds its contiguous slice of the state's
    lanes: `render` traces that tile (the megakernel keyed on the tile's
    first pixel id, the wavefront on its lane offset), `render_adaptive`
    sorts and splits per rank, and `image`, `save` and the other outputs
    gather the frame or the state with all_gather (collectives: every
    rank calls them); files are written by rank 0, then a barrier. The
    meter ticks on rank 0 with the world's rays. `frame` refuses a mesh.
    """

    def __init__(self, scene: Scene, config: RenderConfig,
                 intersect_fn=None, device=None) -> None:
        with profiling.span("engine.init", force=True):
            self._build(scene, config, intersect_fn, device)

    def _build(self, scene: Scene, config: RenderConfig, intersect_fn,
               device) -> None:
        self.device = resolve_device(device)
        self.cfg = config.validate()
        self.num_pixels = config.width * config.height
        self.mesh = None
        if config.devices != 1:
            self.mesh = make_render_mesh(config.devices or None,
                                         self.device.type)
            nd = self.mesh.size()
            if self.num_pixels % nd:
                raise ValueError(
                    f"{config.width}x{config.height} = {self.num_pixels} "
                    f"pixels must divide evenly over {nd} devices")
        self._rank = 0 if self.mesh is None else shard.mesh_rank(self.mesh)
        self._world = 1 if self.mesh is None else self.mesh.size()
        # The megakernel tile's first global pixel id (0 on one device).
        self._tile0 = self._rank * (self.num_pixels // self._world)
        self.scene = scene.to(self.device)
        self.controller = CameraController(config, device=self.device)
        self.meter = PerfMeter()
        cam = self.camera
        with profiling.span("engine.accel", force=True):
            self.intersect_fn = intersect_fn or make_intersect_fn(
                self.scene, config.accel, smooth=config.smooth,
                textured=config.textured, cam=cam,
                iterations=config.iterations, force=config.accel_force)
        # 'auto' re-picks on a depth change where the predictor decides
        # it (`_maybe_repick_accel`); an injected intersector stays.
        self._accel_auto = (
            intersect_fn is None and config.accel == "auto"
            and self.device.type == "cuda"
            and self.scene.num_triangles <= AUTO_MINARG_MAX_TRIS)
        self._accel_iters = config.iterations
        self._accel_by_iters = {config.iterations: self.intersect_fn}
        # The environment: a map (host-built once), the dormant sky, or
        # None (the shipped kernel's plain break on a miss).
        if config.env_map is not None:
            self.env = load_envmap(
                config.env_map, scale=config.env_scale,
                sample_res=tuple(config.env_sample_res), nee=config.env_nee,
                device=self.device)
        else:
            self.env = (megakernel.EnvLight(sky=tuple(config.env_sky),
                                            deep=tuple(config.env_deep))
                        if config.env_light else None)
        with profiling.span("engine.emitters", force=True):
            self.nee = (build_emitter_table(
                self.scene.tris, self.scene.mats, self.scene.spheres,
                select=config.nee_select) if config.nee else None)
            # The any-hit shadow-ray test, built when some gather traces
            # shadow rays, unless nee_anyhit is off or the scene is above
            # K7's range (None: the shadow rays then go through
            # intersect_fn, as in the JAX engine).
            wants_shadow = self.nee is not None or (
                config.env_map is not None and config.env_nee)
            self.occluded = (make_scene_occluded(self.scene)
                             if wants_shadow and config.nee_anyhit else None)
        self.dof = ((config.dof_aperture, config.dof_focus)
                    if config.dof_aperture > 0.0 else None)
        self.key = rng.key(config.seed)
        self.rr = ((config.rr_start, config.rr_pmin)
                   if config.rr_start is not None else None)
        with profiling.span("engine.rng_seed", force=True):
            if config.model == "wavefront":
                self.state = wavefront.init_wavefront(
                    cam, self.num_pixels, seed=config.seed,
                    mode=config.mode, key=self.key, qmc=config.qmc,
                    dof=self.dof)
                self._wf_pose = self.controller._cam_key
            else:
                self.state = megakernel.init_state(
                    self.num_pixels, config.seed, device=self.device)
        if self.mesh is not None:
            self.state = self._shard(self.state)
        # Rays traced since construction: live lanes at each bounce, once
        # more per shadow batch (megakernel, on the device; this rank's,
        # and the world's as of the last render in _rays_world), or lanes
        # x steps (wavefront, host, the world's), as the JAX engine counts
        # them.
        self._rays = torch.zeros((), dtype=torch.float32, device=self.device)
        self._rays_world = 0.0
        self._wf_rays = 0
        self._rays_per_sample = None   # estimated_rays' calibration
        self._display = None           # display_u8_device's cached choice
        self._sample_host = 0  # samples per pixel (wavefront: the floor)
        self.steps_run = 0     # wavefront steps since construction

    @property
    def camera(self):
        """The controller's device camera for the current pose (memoised:
        the same tensors while the pose holds)."""
        return self.controller.camera(self.cfg.width, self.cfg.height)

    @property
    def iterations(self) -> int:
        """The live bounce depth (the controller's '+'/'-')."""
        return self.controller.state.iterations

    @property
    def rays_traced(self) -> float:
        """Rays traced since construction; over a mesh, the world's as of
        the end of the last render call (no collective here)."""
        mega = float(self._rays) if self.mesh is None else self._rays_world
        return mega + float(self._wf_rays)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            with profiling.span("engine.sync"):
                torch.cuda.synchronize(self.device)
            profiling.count("host_reads.engine.sync")

    # --- the mesh (devices != 1) ----------------------------------------
    def _shard(self, state):
        """This rank's slice of a whole-frame state."""
        if self.cfg.model == "wavefront":
            return shard.shard_wavefront_state(state, self.mesh)
        return shard.shard_state(state, self.mesh)

    def _whole_state(self):
        """The whole-frame state: gathered over a mesh (a collective)."""
        if self.mesh is None:
            return self.state
        if self.cfg.model == "wavefront":
            return shard.gather_wavefront_state(self.state, self.mesh)
        return shard.gather_state(self.state, self.mesh)

    def _all_reduce(self, value: torch.Tensor,
                    op=dist.ReduceOp.SUM) -> torch.Tensor:
        """value all_reduce'd with op over a mesh (a copy); value itself
        on one device."""
        if self.mesh is not None:
            value = value.clone()
            dist.all_reduce(value, op=op)
        return value

    def _on_rank0(self, write) -> None:
        """write() on rank 0 only (every rank on one device), then a
        barrier: an all_reduce that the host waits for, so the file is
        there on every rank when this returns."""
        if self.mesh is None:
            write()
            return
        if self._rank == 0:
            write()
        done = torch.zeros(1, device=self.device)
        dist.all_reduce(done)
        done.item()

    def _maybe_repick_accel(self, iterations: int) -> None:
        """Re-run 'auto''s choice when the live bounce depth changes (the
        reference's '+'/'-' keys, main.cpp:1043-1054), as the JAX engine
        does: one intersector per depth, built at the current pose the
        first time that depth is asked for, and reused after."""
        if not self._accel_auto or iterations == self._accel_iters:
            return
        fn = self._accel_by_iters.get(iterations)
        if fn is None:
            fn = make_intersect_fn(
                self.scene, "auto", smooth=self.cfg.smooth,
                textured=self.cfg.textured, cam=self.camera,
                iterations=iterations, force=self.cfg.accel_force)
            self._accel_by_iters[iterations] = fn
        self.intersect_fn = fn
        self._accel_iters = iterations

    def _trace(self, cam, state, with_stats: bool, iterations: int):
        """One sample of this rank's tile (the whole frame on one device):
        the JAX engine's make_tiled_step without the meter's all_reduce,
        which it drops."""
        self._maybe_repick_accel(iterations)
        return megakernel.trace_sample(
            cam, self.scene.mats, state, intersect_fn=self.intersect_fn,
            iterations=iterations, mode=self.cfg.mode, key=self.key,
            qmc=self.cfg.qmc, with_stats=with_stats, nee=self.nee,
            occluded_fn=self.occluded, env=self.env, dof=self.dof,
            ids=self._tile0)

    def _tick(self, sample: int, rays: float, real_time: bool = False):
        with profiling.span("engine.meter"):
            if self._rank == 0:
                self.meter.tick(sample, iterations=self.iterations,
                                real_time=real_time, rays_traced=rays)

    # --- frame API (the onIdle loop) -------------------------------------
    def frame(self, dt: float = 0.0, sync: bool = True) -> None:
        """One interactive frame: integrate the input, restart the
        accumulation if it asks for it, trace one sample at the
        controller's pose and depth, tick the meter. With sync, waits for
        the card on every frame in real time and on every third sample
        otherwise (main.cpp:670-681); sync=False leaves that to the
        caller."""
        if self.cfg.model == "wavefront":
            raise ValueError(
                "the interactive loop needs model='megakernel' (the "
                "reference's one-sample-per-frame semantics); "
                "model='wavefront' is for offline render()")
        if self.mesh is not None:
            raise ValueError("the interactive loop is single-device; "
                             "devices>1 is for offline render()")
        profiling.refresh()
        with profiling.span("engine.frame", sample=self._sample_host):
            ctl = self.controller
            ctl.update(dt)
            if ctl.consume_reset():
                self.reset_accumulation()
            st = ctl.state
            self.state, rays = self._trace(self.camera, self.state, True,
                                           st.iterations)
            self._rays += rays
            self._sample_host += 1
            sample = self._sample_host
            if sync and (st.real_time or sample % 3 == 0):
                self._sync()
            self._tick(sample, self.estimated_rays(sample), st.real_time)

    def render(self, spp: int, progress: bool = True,
               autosave_every: int = 0,
               autosave_path: str | None = None) -> None:
        """Accumulate spp more samples per pixel and wait for the device.
        progress=True ticks the meter (one line a second on stderr).

        autosave_every > 0 (with autosave_path) checkpoints the state:
        the megakernel every that many samples, the wavefront model at
        each convergence check after the first, as the JAX engine does.
        Each autosave writes `autosave_path + ".tmp.npz"` and renames it
        over autosave_path, so a checkpoint is never half-written."""
        profiling.refresh()
        with profiling.span("engine.render", sample=self._sample_host):
            if self.cfg.model == "wavefront":
                self._render_wavefront(spp, progress, autosave_every,
                                       autosave_path)
            else:
                cam = self.camera
                for i in range(spp):
                    self.state, rays = self._trace(cam, self.state, True,
                                                   self.iterations)
                    self._rays += rays
                    self._sample_host += 1
                    if (autosave_every and autosave_path
                            and (i + 1) % autosave_every == 0):
                        self._autosave(autosave_path)
                    if progress:
                        self._tick(self._sample_host,
                                   self.estimated_rays(self._sample_host))
                if self.mesh is not None:
                    self._rays_world = float(self._all_reduce(self._rays))
            self._sync()

    def _autosave(self, path: str) -> None:
        """Write the checkpoint to path + ".tmp.npz" and rename it over
        path (rank 0 over a mesh)."""
        tmp = path + ".tmp.npz"
        state = self._whole_state()

        def write():
            save_checkpoint(tmp, state, meta=self._meta())
            os.replace(tmp, path)

        self._on_rank0(write)

    def _wf_steps(self, state, k: int, cap: int, variance=None):
        """k wavefront steps with samples capped at `cap`; variance:
        (tol, min_samples) for adaptive sampling. Over a mesh, the steps
        of this rank's lanes at their global offset, rank x lanes (the
        JAX engine's make_tiled_wavefront_step without the meter's
        all_reduce, which it drops)."""
        self._maybe_repick_accel(self.iterations)
        vkw = ({} if variance is None
               else dict(variance_tol=variance[0], min_samples=variance[1]))
        cam = self.camera
        for _ in range(k):
            state = wavefront.wavefront_step(
                cam, self.scene.mats, state,
                intersect_fn=self.intersect_fn,
                iterations=self.iterations, mode=self.cfg.mode,
                key=self.key, max_samples=cap, rr=self.rr,
                qmc=self.cfg.qmc, nee=self.nee, occluded_fn=self.occluded,
                env=self.env, dof=self.dof,
                lane_offset=self._rank * state.lanes, **vkw)
        self.steps_run += k
        self._wf_rays += k * state.lanes * self._world
        return state

    def _floor(self, state) -> int:
        """The fewest samples of any lane, over the mesh's ranks."""
        return int(self._all_reduce(state.samples.min(), dist.ReduceOp.MIN))

    def _reset_if_moved(self) -> None:
        """The wavefront's rays in flight belong to the pose they started
        from: a moved camera restarts the accumulation. The controller's
        pose key is refreshed first (the JAX engine compares the key of
        the last camera built, so it resets one render late: ROADMAP.md
        queue 3)."""
        self.controller.camera(self.cfg.width, self.cfg.height)
        if self.controller._cam_key != self._wf_pose:
            self.reset_accumulation()

    def _render_wavefront(self, spp: int, progress: bool = True,
                          autosave_every: int = 0,
                          autosave_path: str | None = None) -> None:
        """Wavefront steps until every pixel has `spp` more samples, capped
        there. A lane finishes a sample in 1 to `iterations` steps, so
        (target - min samples) steps are always useful: one host read of
        min(samples) per chunk of that many steps, and spp * iterations
        + 16 steps bound the render. The meter ticks at each read after
        the first."""
        self._reset_if_moved()
        iters = self.iterations
        target = self._sample_host + spp
        max_steps = spp * iters + 16
        done = 0
        while done < max_steps:
            floor = self._floor(self.state)
            if autosave_every and autosave_path and done:
                self._autosave(autosave_path)
            if progress and done:
                self._tick(floor, float(self._wf_rays))
            if floor >= target:
                break
            k = min(max(target - floor, 1), max_steps - done)
            self.state = self._wf_steps(self.state, k, target)
            done += k
        else:
            floor = self._floor(self.state)
            if floor < target:
                raise RuntimeError(f"wavefront render stuck at {floor}/"
                                   f"{target} spp after {done} steps")
        self._sample_host = target

    def render_adaptive(self, tol: float, max_spp: int, min_spp: int = 8,
                        progress: bool = True) -> None:
        """Adaptive offline render (model='wavefront'): every pixel takes
        min_spp to max_spp samples in all and idles once its relative
        luminance SEM is within `tol` (`wavefront.converged_mask`). A
        host check every max(6 iterations, 24) steps, a fixed cadence
        (the JAX engine sizes its later dispatches by the clock, a TPU
        runtime's watchdog policy, which the port leaves out); at each,
        the open lanes move to the front and the bucket halves while
        they fit in half of it (`wavefront.compact_target`,
        down to ADAPTIVE_MIN_BUCKET), and the converged tail is parked.
        The bucket sizes stepped, one per check, are in
        `adaptive_buckets`. progress=True ticks the meter at each check
        after the first.

        Over a mesh (the JAX engine's sharded adaptive render) each rank
        sorts and splits its own lanes, the bucket is a rank's, and it
        halves on the busiest rank's open count (an all_reduce MAX, zero
        only when the world's is); at the end the state has the JAX
        engine's lane order, the world's live lanes then each parked
        part, each in rank order, split again evenly across the ranks.
        Lane order is free, so parity mode stays bit-identical to the
        single-device adaptive render."""
        if self.cfg.model != "wavefront":
            raise ValueError(
                "adaptive rendering needs model='wavefront' (per-pixel "
                "sample counts; the megakernel steps every pixel in "
                "lockstep)")
        profiling.refresh()
        self._reset_if_moved()
        variance = (float(tol), int(min_spp))
        chunk = max(self.iterations * 6, 24)
        max_steps = max_spp * self.iterations + chunk
        live, parked = self.state, []
        bucket = live.lanes
        self.adaptive_buckets = []
        done = 0
        while done < max_steps:
            mask = (wavefront.converged_mask(live.samples, live.colors,
                                             live.lum_m2, tol, min_spp)
                    | (live.samples >= max_spp))
            n_open = int(self._all_reduce((~mask).sum(), dist.ReduceOp.MAX))
            if progress and done:
                self._tick(self._floor(live), float(self._wf_rays))
            if n_open == 0:
                break
            target = wavefront.compact_target(bucket, n_open,
                                              ADAPTIVE_MIN_BUCKET)
            if target < bucket:
                live, tail = wavefront.state_split(
                    wavefront.sort_open_first(live, ~mask), target)
                parked.append(tail)
                bucket = target
            k = min(max_steps - done, chunk)
            live = self._wf_steps(live, k, max_spp, variance)
            self.adaptive_buckets.append(bucket)
            done += k
        if parked and self.mesh is not None:
            whole = wavefront.state_concat(
                [shard.gather_wavefront_state(p, self.mesh)
                 for p in [live] + parked])
            self.state = shard.shard_wavefront_state(whole, self.mesh)
        else:
            self.state = (wavefront.state_concat([live] + parked) if parked
                          else live)
        self._sample_host = self._floor(self.state)
        self._sync()

    def adaptive_prediction(self, tol: float, max_spp: int,
                            min_spp: int = 8) -> tuple[float, float]:
        """(predicted speedup, zero-variance share) of an adaptive render
        against a fixed one, from the current state's per-pixel SEMs (after
        a variance-tracked probe, `render_adaptive` to min_spp), reckoned
        on the host in float64 as the JAX engine does: each pixel needs
        n (rel / tol)^2 samples, clipped to [min_spp, max_spp]; the fixed
        render's max_spp over ADAPTIVE_OVERHEAD_FACTOR times their mean.
        Over a mesh the whole state is gathered first (a collective)."""
        st = self._whole_state()

        def host(t):
            return t.cpu().numpy().astype(np.float64)

        n = host(st.samples)
        lum = sum(w * host(c) for w, c in zip(wavefront._LUM, st.colors))
        m2 = host(st.lum_m2)
        sem = np.sqrt(np.maximum(m2, 0.0) / np.maximum(n * (n - 1.0), 1.0))
        rel = sem / (lum + 0.05)
        zero_var_frac = float(np.mean(m2 <= 1e-12))
        need = np.clip(n * (rel / tol) ** 2, float(min_spp), float(max_spp))
        speedup = float(max_spp / (ADAPTIVE_OVERHEAD_FACTOR * need.mean()))
        return speedup, zero_var_frac

    def render_adaptive_auto(self, max_spp: int, tol: float = 0.05,
                             min_spp: int = 8, progress: bool = True
                             ) -> tuple[str, float, float]:
        """Render the min_spp floor with variance tracking, predict the
        adaptive win (`adaptive_prediction`), then go on adaptively when
        it clears the bars (the module's ADAPTIVE_* constants, TPU
        choices) and with the fixed render otherwise. Returns (decision,
        predicted speedup, zero-variance share), decision 'adaptive' or
        'fixed'."""
        self.render_adaptive(tol, max_spp=min_spp, min_spp=min_spp,
                             progress=progress)
        speedup, zero_var = self.adaptive_prediction(tol, max_spp, min_spp)
        if (speedup >= ADAPTIVE_MIN_PREDICTED_SPEEDUP
                and zero_var <= ADAPTIVE_MAX_ZERO_VAR_FRAC):
            self.render_adaptive(tol, max_spp=max_spp, min_spp=min_spp,
                                 progress=progress)
            return "adaptive", speedup, zero_var
        self.render(max_spp - min_spp, progress=progress)
        return "fixed", speedup, zero_var

    def reset_accumulation(self) -> None:
        """current_sample = 0 (main.cpp:1100-1148): the average restarts.
        The megakernel keeps its Lehmer streams running (rnds[] is never
        reseeded); the wavefront's state is rebuilt at the current pose."""
        if self.cfg.model == "wavefront":
            self.state = wavefront.init_wavefront(
                self.camera, self.num_pixels, seed=self.cfg.seed,
                mode=self.cfg.mode, key=self.key, qmc=self.cfg.qmc,
                dof=self.dof)
            if self.mesh is not None:
                self.state = self._shard(self.state)
            self._wf_pose = self.controller._cam_key
        else:
            self.state = megakernel.TraceState(
                colors=self.state.colors, rng_state=self.state.rng_state,
                sample=0)
        self._sample_host = 0

    def estimated_rays(self, samples: int) -> float:
        """Rays traced in `samples` samples, for the meter: exact for the
        wavefront (lanes x steps); for the megakernel, the count of one
        instrumented sample of the current state (traced once, its state
        dropped) times `samples`. Like the JAX engine's, that sample has
        neither depth of field nor QMC jitter. `rays_traced` is the exact
        count. Over a mesh the calibration sums the ranks' tiles (an
        all_reduce the first time: every rank calls it, as `render`
        does)."""
        if self.cfg.model == "wavefront":
            return float(self._wf_rays)
        if self._rays_per_sample is None:
            with profiling.span("engine.calibrate", force=True):
                _, rays = megakernel.trace_sample(
                    self.camera, self.scene.mats, self.state,
                    intersect_fn=self.intersect_fn,
                    iterations=self.iterations, mode=self.cfg.mode,
                    key=self.key, with_stats=True, nee=self.nee,
                    occluded_fn=self.occluded, env=self.env,
                    ids=self._tile0)
                self._rays_per_sample = float(self._all_reduce(rays))
        return self._rays_per_sample * samples

    def display_u8(self) -> np.ndarray:
        """(H, W, 3) uint8 display frame, top row first: tonemapped and
        quantized on the device (`display_u8_device`), one host fetch,
        the rows flipped on the host. Over a mesh, `to_uint8` of the
        gathered `image()` (a collective)."""
        profiling.refresh()
        with profiling.span("display"):
            with profiling.span("display.tonemap"):
                dev = self.display_u8_device()
            if dev is None:
                return to_uint8(self.image())
            with profiling.span("display.copy"):
                host = dev.cpu()
            profiling.count("host_reads.display.copy")
            return host.numpy()[::-1]

    def display_u8_device(self) -> torch.Tensor | None:
        """The current state's tonemapped (H, W, 3) uint8 frame, bottom
        row first, as a tensor on the engine's device: no host copy.
        NaN (the tonemap's 0/0) becomes 0 and +inf 255, as
        `io.image.to_uint8`. A wavefront whose lanes are a permutation of
        the pixels (checked once, on the first call, as the JAX engine
        does) scatters each lane's average to its pixel; otherwise each
        pixel is its lanes' average weighted by their samples, in
        float32. None over a mesh, as in the JAX engine (the gathering
        `image()` owns that layout)."""
        if self.mesh is not None:
            return None
        h, w, n_px = self.cfg.height, self.cfg.width, self.num_pixels
        st = self.state
        if self.cfg.model == "wavefront":
            pix = st.pixel.long()
            if self._display is None:
                self._display = (st.lanes == n_px and int(
                    torch.unique(pix).shape[0]) == n_px)
            cols = torch.stack(st.colors, dim=-1)
            if self._display and st.lanes == n_px:
                img = torch.zeros((n_px, 3), dtype=torch.float32,
                                  device=cols.device)
                img[pix] = cols
            else:
                # Lane-order sums: the same bits on every run.
                wgt = st.samples.to(torch.float32)
                den = wavefront.pixel_sum(pix, wgt, n_px)
                num = wavefront.pixel_sum(pix, wgt[:, None] * cols, n_px)
                img = num / torch.clamp_min(den, 1.0)[:, None]
        else:
            img = megakernel.colors_array(st)
        img = tonemap_ops.apply(img.reshape(h, w, 3), self.cfg.tonemap)
        img = torch.nan_to_num(img, nan=0.0, posinf=1.0, neginf=0.0)
        return (torch.clamp(img, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)

    def _colors(self) -> torch.Tensor:
        """(num_pixels, 3) colors by pixel id, gathered over a mesh (a
        collective: the megakernel's tiles, or the wavefront's pixel,
        samples and colors, which are all `colors_by_pixel` reads)."""
        st = self.state
        if self.cfg.model == "megakernel":
            return shard.gather_colors(st, self.mesh)
        if self.mesh is not None:
            def gather(t):
                return shard.all_gather_lanes(t, self.mesh)
            st = st.replace(pixel=gather(st.pixel),
                            samples=gather(st.samples),
                            colors=tuple(gather(c) for c in st.colors))
        return wavefront.colors_by_pixel(st, self.num_pixels)

    def image(self, apply_tonemap: bool | str = True) -> np.ndarray:
        """(H, W, 3) float32 image, top row first (the reference's
        framebuffer is GL bottom-up); a collective over a mesh."""
        colors = self._colors().reshape(self.cfg.height, self.cfg.width, 3)
        if apply_tonemap:
            kind = self.cfg.tonemap if apply_tonemap is True else apply_tonemap
            colors = tonemap_ops.apply(colors, kind)
        return colors.cpu().numpy()[::-1]

    def save_png(self, path: str) -> None:
        img = self.image()
        self._on_rank0(lambda: write_png(path, img))

    def denoised_image(self, apply_tonemap: bool | str = True,
                       **denoise_kw) -> np.ndarray:
        """(H, W, 3) display image, top row first, through the edge-aware
        à-trous denoiser (`ops.denoise`): filtered in linear light,
        guided by first-hit normals and depth from this engine's own
        intersector at the current pose (recomputed on each call), then
        tonemapped. The megakernel's colours stay on the device; the
        wavefront's go through `colors_by_pixel`; over a mesh both are
        gathered (a collective) and every rank filters the frame.
        denoise_kw: iterations, sigma_color, sigma_normal, sigma_depth,
        clamp_percentile."""
        h, w = self.cfg.height, self.cfg.width
        colors = self._colors()
        normal, depth = primary_aovs(self.camera, self.scene.mats,
                                     self.intersect_fn, w, h)
        out = atrous_denoise(colors.reshape(h, w, 3), normal, depth,
                             **denoise_kw)
        if apply_tonemap:
            kind = self.cfg.tonemap if apply_tonemap is True else apply_tonemap
            out = tonemap_ops.apply(out, kind)
        return out.cpu().numpy()[::-1]

    def save_hdr(self, path: str) -> None:
        """Linear, untonemapped radiance: `.npy` by its extension, else
        PFM (rank 0 writes over a mesh)."""
        img = self.image(apply_tonemap=False)
        if path.endswith(".npy"):
            self._on_rank0(lambda: np.save(path, img))
        else:
            self._on_rank0(lambda: write_pfm(path, img))

    def _meta(self) -> dict:
        return {"width": self.cfg.width, "height": self.cfg.height,
                "mode": self.cfg.mode, "seed": self.cfg.seed}

    def save(self, path: str) -> None:
        """Checkpoint the state (`io.checkpoint`; the JAX package's file,
        which its engine resumes too). Over a mesh the whole state is
        gathered and rank 0 writes it."""
        state = self._whole_state()
        self._on_rank0(lambda: save_checkpoint(path, state,
                                               meta=self._meta()))

    def load(self, path: str) -> None:
        """Resume from a checkpoint of either package, onto this engine's
        device; over a mesh, this rank's slice of it, so a render resumes
        across device counts. Refuses another resolution or model."""
        state, meta = load_checkpoint(path, device=self.device)
        if (meta.get("width") != self.cfg.width
                or meta.get("height") != self.cfg.height):
            raise ValueError(
                "checkpoint resolution mismatch: "
                f"{meta.get('width')}x{meta.get('height')} vs "
                f"{self.cfg.width}x{self.cfg.height}")
        ck_model = meta.get("model", "megakernel")
        if ck_model != self.cfg.model:
            raise ValueError(f"checkpoint model {ck_model!r} != engine "
                             f"model {self.cfg.model!r}")
        self.state = state if self.mesh is None else self._shard(state)
        if self.cfg.model == "wavefront":
            self._sample_host = int(state.samples.min())
            self._wf_pose = self.controller._cam_key
        else:
            self._sample_host = int(state.sample)
