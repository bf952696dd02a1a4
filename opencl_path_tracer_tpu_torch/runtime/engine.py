"""Progressive render engine (offline path).

Port of `make_intersect_fn` and of `RenderEngine.__init__`, `render`
(with `_render_wavefront`), `image` and `save_png` from
`opencl_path_tracer_tpu/runtime/engine.py` (the reference's frame loop,
main.cpp:683-687 and 1171-1241, without interactivity). The engine owns
the progressive state on its device, in the megakernel model
(TraceState) or the wavefront model (WavefrontState), and picks the
intersector.

Accel choice: 'auto' resolves to 'minarg' (K1 + K2) up to 8,192
triangles and to 'pairwin' above, the JAX package's cut (engine.py:
380-393), carried over as its choice, not a measurement on the GPU.
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
ids, so smooth shading refuses them. 'auto' never picks these five, and
the port prints none of the JAX package's TPU-only warnings about them. Analytic spheres go
through K3 (K3b above 64) and are min-merged after the triangles. With
`smooth`, the triangle winner's normal is the interpolated vertex normal
(`_make_smooth_tri_fn`): 'auto' is 'minarg' (K1 then K8) up to 4,096
triangles and 'pairwin' with ids (K1 + K2 seed, K1 tail) and
`smooth_hit_normals` above, as the JAX package routes it
(engine.py:334-356); the 4,096 cap comes from its kernel holding the
whole one-hot table in the TPU's VMEM, and the port carries it over as
the starting choice without a GPU measurement. With `nee`, the engine
builds the emitter table and, with `nee_anyhit`, the any-hit shadow-ray
test (K7, or-ed with the spheres), and hands both to the model.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from opencl_path_tracer_tpu_torch.config import RenderConfig
from opencl_path_tracer_tpu_torch.core.camera import make_camera
from opencl_path_tracer_tpu_torch.io.image import write_png
from opencl_path_tracer_tpu_torch.models import megakernel, wavefront
from opencl_path_tracer_tpu_torch.ops import intersect, rng
from opencl_path_tracer_tpu_torch.ops import tonemap as tonemap_ops
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
    make_scene_occluded, make_tilecull_intersect,
)
from opencl_path_tracer_tpu_torch.ops.shading import smooth_hit_normals
from opencl_path_tracer_tpu_torch.scene.builder import Scene
from opencl_path_tracer_tpu_torch.utils.device import resolve_device

AUTO_MINARG_MAX_TRIS = 8192
SMOOTH_MINARG_MAX_TRIS = 4096   # a TPU VMEM limit (see the docstring)


def resolve_accel(accel: str, num_triangles: int, on_cuda: bool,
                  smooth: bool = False) -> str:
    """The triangle intersector `accel` names for this scene and device."""
    if accel == "auto":
        cap = SMOOTH_MINARG_MAX_TRIS if smooth else AUTO_MINARG_MAX_TRIS
        return "minarg" if num_triangles <= cap else "pairwin"
    if accel == "bruteforce" and on_cuda:
        raise ValueError(
            "accel 'bruteforce' is the plain PyTorch reference and does not "
            "run on CUDA; use 'minarg' (or 'auto')")
    if accel not in ("minarg", "pallas", "tilecull", "pairwin", "pair",
                     "cluster", "group", "march", "flat", "bruteforce"):
        raise NotImplementedError(
            f"accel {accel!r} is not ported yet (ROADMAP.md queue 1, the bvh "
            "and median accels)")
    return accel


def _has_vertex_normals(scene: Scene) -> bool:
    """True when some corner normal is nonzero (a scene with texture
    coordinates only has attributes too, all of whose normals are 0)."""
    return (scene.attribs is not None
            and bool(scene.attribs.packed[:, 8:17].any()))


def _make_smooth_tri_fn(scene: Scene, accel: str):
    """The smooth-shading triangle intersector for a resolved accel.
    'minarg' is K1 then K8 (`make_smooth_minarg_intersect`); 'tilecull'
    (K6 with ids; the groups in Morton order, as the JAX package builds
    them for smooth shading), 'pairwin' (with ids) and 'bruteforce' (the
    plain reference, CPU only) report the winner's index, and
    `smooth_hit_normals` interpolates."""
    attribs = scene.attribs
    if accel == "minarg":
        if scene.num_triangles > SMOOTH_MINARG_MAX_TRIS:
            raise ValueError(
                f"accel='minarg' with smooth shading tops out at "
                f"{SMOOTH_MINARG_MAX_TRIS} triangles (the JAX package's "
                f"cap); the scene has {scene.num_triangles}")
        return make_smooth_minarg_intersect(scene.tris, attribs)
    if accel == "tilecull":
        ids_fn = make_tilecull_intersect(scene.tris, with_ids=True)
    elif accel == "pairwin":
        ids_fn = make_pair_intersect(scene.tris, with_ids=True,
                                     **PAIR_TPU_WINNER)
    elif accel == "bruteforce":
        ids_fn = functools.partial(intersect.first_intersect_ids,
                                   tris=scene.tris)
    else:
        raise ValueError(
            f"smooth shading needs an intersector that reports the "
            f"winner's index: 'minarg', 'tilecull', 'pairwin', "
            f"'bruteforce' or 'auto', not {accel!r}")

    def smooth_fn(rays):
        hits, ids = ids_fn(rays)
        return smooth_hit_normals(hits, ids, attribs)

    return smooth_fn


def make_intersect_fn(scene: Scene, accel: str = "auto", origin=None,
                      smooth: bool = False):
    """intersect(rays) -> Hits over the scene's triangles, min-merged with
    its analytic spheres (the triangle stream wins exact-t ties). origin
    (the camera eye) orders the 'tilecull' groups front to back.
    smooth=True interpolates the vertex normals of scene.attribs at the
    triangle hits (analytic spheres have exact normals already)."""
    on_cuda = scene.tris.device.type == "cuda"
    if smooth and not _has_vertex_normals(scene):
        raise ValueError(
            "smooth=True but the scene has no vertex normals; build it "
            "with add_obj(smooth_normals=True), add_sphere(smooth=True) "
            "or add_triangle(vn=...)")
    accel = resolve_accel(accel, scene.num_triangles, on_cuda, smooth)
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
    elif accel == "pair":
        tri_fn = make_pair_intersect(scene.tris)
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
    if scene.spheres is None:
        return tri_fn
    sphere_fn = (functools.partial(intersect.sphere_intersect,
                                   spheres=scene.spheres)
                 if accel == "bruteforce"
                 else make_sphere_intersect(scene.spheres))

    def with_spheres(rays):
        return intersect.merge_hits(tri_fn(rays), sphere_fn(rays))

    return with_spheres


class RenderEngine:
    def __init__(self, scene: Scene, config: RenderConfig,
                 intersect_fn=None, device=None) -> None:
        self.device = resolve_device(device)
        self.cfg = config.validate()
        self.scene = scene.to(self.device)
        cam = config.camera
        self.camera = make_camera(config.width, config.height, fov=cam.fov,
                                  yaw=cam.yaw, pitch=cam.pitch,
                                  shift=cam.shift, device=self.device)
        self.intersect_fn = intersect_fn or make_intersect_fn(
            self.scene, config.accel,
            origin=tuple(float(v) for v in self.camera.eye.cpu()),
            smooth=config.smooth)
        # NEE: the emitter table, and the any-hit shadow-ray test unless
        # nee_anyhit is off or the scene is above K7's range (None: the
        # shadow rays then go through intersect_fn, as in the JAX engine).
        self.nee = (build_emitter_table(self.scene.tris, self.scene.mats,
                                        self.scene.spheres,
                                        select=config.nee_select)
                    if config.nee else None)
        self.occluded = (make_scene_occluded(self.scene)
                         if self.nee is not None and config.nee_anyhit
                         else None)
        self.num_pixels = config.width * config.height
        self.key = rng.key(config.seed)
        self.rr = ((config.rr_start, config.rr_pmin)
                   if config.rr_start is not None else None)
        if config.model == "wavefront":
            self.state = wavefront.init_wavefront(
                self.camera, self.num_pixels, seed=config.seed,
                mode=config.mode, key=self.key, qmc=config.qmc)
        else:
            self.state = megakernel.init_state(self.num_pixels, config.seed,
                                               device=self.device)
        # Rays traced since construction: live lanes at each bounce, twice
        # with NEE's shadow batch (megakernel, on the device), or lanes x
        # steps (wavefront, host), as the JAX engine counts them.
        self._rays = torch.zeros((), dtype=torch.float32, device=self.device)
        self._wf_rays = 0
        self._sample_host = 0  # samples per pixel the wavefront targets
        self.steps_run = 0     # wavefront steps since construction

    @property
    def rays_traced(self) -> float:
        return float(self._rays) + float(self._wf_rays)

    def render(self, spp: int) -> None:
        """Accumulate spp more samples per pixel and wait for the device."""
        if self.cfg.model == "wavefront":
            self._render_wavefront(spp)
        else:
            for _ in range(spp):
                self.state, rays = megakernel.trace_sample(
                    self.camera, self.scene.mats, self.state,
                    intersect_fn=self.intersect_fn,
                    iterations=self.cfg.iterations, mode=self.cfg.mode,
                    key=self.key, qmc=self.cfg.qmc, with_stats=True,
                    nee=self.nee, occluded_fn=self.occluded)
                self._rays += rays
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _render_wavefront(self, spp: int) -> None:
        """Wavefront steps until every pixel has `spp` more samples, capped
        there. A lane finishes a sample in 1 to `iterations` steps, so
        (target - min samples) steps are always useful: one host read of
        min(samples) per chunk of that many steps, and spp * iterations
        + 16 steps bound the render."""
        iters = self.cfg.iterations
        target = self._sample_host + spp
        max_steps = spp * iters + 16
        done = 0
        while done < max_steps:
            floor = int(self.state.samples.min())
            if floor >= target:
                break
            k = min(max(target - floor, 1), max_steps - done)
            for _ in range(k):
                self.state = wavefront.wavefront_step(
                    self.camera, self.scene.mats, self.state,
                    intersect_fn=self.intersect_fn, iterations=iters,
                    mode=self.cfg.mode, key=self.key, max_samples=target,
                    rr=self.rr, qmc=self.cfg.qmc, nee=self.nee,
                    occluded_fn=self.occluded)
            done += k
            self.steps_run += k
            self._wf_rays += k * self.num_pixels
        else:
            floor = int(self.state.samples.min())
            if floor < target:
                raise RuntimeError(f"wavefront render stuck at {floor}/"
                                   f"{target} spp after {done} steps")
        self._sample_host = target

    def image(self, apply_tonemap: bool | str = True) -> np.ndarray:
        """(H, W, 3) float32 image, top row first (the reference's
        framebuffer is GL bottom-up)."""
        if self.cfg.model == "wavefront":
            colors = wavefront.colors_by_pixel(self.state, self.num_pixels)
        else:
            colors = megakernel.colors_array(self.state)
        colors = colors.reshape(self.cfg.height, self.cfg.width, 3)
        if apply_tonemap:
            kind = self.cfg.tonemap if apply_tonemap is True else apply_tonemap
            colors = tonemap_ops.apply(colors, kind)
        return colors.cpu().numpy()[::-1]

    def save_png(self, path: str) -> None:
        write_png(path, self.image())
