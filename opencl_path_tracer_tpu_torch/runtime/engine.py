"""Progressive render engine (offline path).

Port of `make_intersect_fn` and of `RenderEngine.__init__`, `render`,
`image` and `save_png` from `opencl_path_tracer_tpu/runtime/engine.py`
(the reference's frame loop, main.cpp:683-687 and 1171-1241, without
interactivity). The engine owns the progressive TraceState on its
device and picks the intersector.

Accel choice: 'auto' resolves to 'minarg' (K1 + K2) up to 8,192
triangles, a cut carried over from the JAX package's choice, not a
measurement on the GPU; larger scenes need the pair intersectors, which
are not ported yet. 'bruteforce' is the plain PyTorch reference and is
refused on CUDA, so no plain version carries the main path on the card.
Analytic spheres go through K3 and are min-merged after the triangles.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from opencl_path_tracer_tpu_torch.config import RenderConfig
from opencl_path_tracer_tpu_torch.core.camera import make_camera
from opencl_path_tracer_tpu_torch.io.image import write_png
from opencl_path_tracer_tpu_torch.models import megakernel
from opencl_path_tracer_tpu_torch.ops import intersect, rng
from opencl_path_tracer_tpu_torch.ops import tonemap as tonemap_ops
from opencl_path_tracer_tpu_torch.ops.kernels.plucker_kernel import (
    make_minarg_intersect,
)
from opencl_path_tracer_tpu_torch.ops.kernels.sphere_kernel import (
    make_sphere_intersect,
)
from opencl_path_tracer_tpu_torch.scene.builder import Scene
from opencl_path_tracer_tpu_torch.utils.device import resolve_device

AUTO_MINARG_MAX_TRIS = 8192


def resolve_accel(accel: str, num_triangles: int, on_cuda: bool) -> str:
    """The triangle intersector `accel` names for this scene and device."""
    if accel == "auto":
        if num_triangles > AUTO_MINARG_MAX_TRIS:
            raise NotImplementedError(
                f"accel 'auto' for {num_triangles} triangles (over "
                f"{AUTO_MINARG_MAX_TRIS}) needs the pair intersector, "
                "K9-K12 of ROADMAP.md queue 2, which is not ported yet")
        return "minarg"
    if accel == "bruteforce" and on_cuda:
        raise ValueError(
            "accel 'bruteforce' is the plain PyTorch reference and does not "
            "run on CUDA; use 'minarg' (or 'auto')")
    if accel not in ("minarg", "bruteforce"):
        raise NotImplementedError(
            f"accel {accel!r} is not ported yet (ROADMAP.md queue 2)")
    return accel


def make_intersect_fn(scene: Scene, accel: str = "auto"):
    """intersect(rays) -> Hits over the scene's triangles, min-merged with
    its analytic spheres (the triangle stream wins exact-t ties)."""
    on_cuda = scene.tris.device.type == "cuda"
    accel = resolve_accel(accel, scene.num_triangles, on_cuda)
    if accel == "minarg":
        tri_fn = make_minarg_intersect(scene.tris)
        sphere_fn = (None if scene.spheres is None
                     else make_sphere_intersect(scene.spheres))
    else:
        tri_fn = functools.partial(intersect.first_intersect, tris=scene.tris)
        sphere_fn = (None if scene.spheres is None else functools.partial(
            intersect.sphere_intersect, spheres=scene.spheres))
    if sphere_fn is None:
        return tri_fn

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
            self.scene, config.accel)
        self.num_pixels = config.width * config.height
        self.key = rng.key(config.seed)
        self.state = megakernel.init_state(self.num_pixels, config.seed,
                                           device=self.device)
        # Rays traced (live lanes at each bounce) since construction.
        self._rays = torch.zeros((), dtype=torch.float32, device=self.device)

    @property
    def rays_traced(self) -> float:
        return float(self._rays)

    def render(self, spp: int) -> None:
        """Accumulate spp more samples and wait for the device."""
        for _ in range(spp):
            self.state, rays = megakernel.trace_sample(
                self.camera, self.scene.mats, self.state,
                intersect_fn=self.intersect_fn,
                iterations=self.cfg.iterations, mode=self.cfg.mode,
                key=self.key, qmc=self.cfg.qmc, with_stats=True)
            self._rays += rays
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def image(self, apply_tonemap: bool | str = True) -> np.ndarray:
        """(H, W, 3) float32 image, top row first (the reference's
        framebuffer is GL bottom-up)."""
        colors = megakernel.colors_array(self.state).reshape(
            self.cfg.height, self.cfg.width, 3)
        if apply_tonemap:
            kind = self.cfg.tonemap if apply_tonemap is True else apply_tonemap
            colors = tonemap_ops.apply(colors, kind)
        return colors.cpu().numpy()[::-1]

    def save_png(self, path: str) -> None:
        write_png(path, self.image())
