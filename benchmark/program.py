"""The system under test: the port's render engine, built from the
benchmark's inputs.

The only module of the benchmark that imports the program
(`opencl_path_tracer_tpu_torch`). It hands the port the configuration's
triangles, materials and camera through the port's own scene builder and
`RenderConfig`, builds `RenderEngine` as `ptx-torch render` does, and
reads back what the timed path produced: the accumulated colours of
chosen pixels, the sample count and the ray counter. A configuration
with `devices` above 1 renders over the port's mesh: `launch` starts its
ranks through the port's own launcher, and each rank builds the engine
on its tile.
"""

from __future__ import annotations

import numpy as np
import torch

from opencl_path_tracer_tpu_torch.config import CameraConfig, RenderConfig
from opencl_path_tracer_tpu_torch.parallel import launch as port_launch
from opencl_path_tracer_tpu_torch.runtime.engine import RenderEngine
from opencl_path_tracer_tpu_torch.scene.builder import SceneBuilder

# RenderConfig fields a configuration or a traffic mix may set.
RENDER_KEYS = ("width", "height", "iterations", "mode", "model", "accel",
               "tonemap", "nee", "nee_select", "nee_anyhit", "devices")


def build_scene(arrays, device):
    """The port's Scene of the benchmark's arrays (scenes.SceneArrays),
    object by object, through the scene builder."""
    b = SceneBuilder()
    for m in arrays.materials:
        b.add_material(m["kd"], m["ks"], m["emission"], m["N"], m["K"],
                       m["shininess"], m["type"])
    for lo, hi in arrays.objects:
        for i in range(lo, hi):
            v = arrays.v[i]
            b.add_triangle(v[0], v[1], v[2], int(arrays.mat[i]))
        b.end_obj()
    return b.build(device=device)


def render_config(render: dict, seed: int) -> RenderConfig:
    """The RenderConfig of the merged configuration and traffic render
    settings, with the camera and the render seed."""
    c = render["camera"]
    kw = {k: render[k] for k in RENDER_KEYS if k in render}
    return RenderConfig(seed=seed, camera=CameraConfig(
        fov=c["fov"], yaw=c["yaw"], pitch=c["pitch"],
        shift=tuple(c["shift"])), **kw)


def make_engine(arrays, render: dict, seed: int, device,
                intersect_fn=None, scene=None) -> RenderEngine:
    """The engine as the CLI builds it; scene and intersect_fn reuse a
    scene and an intersector already built (the readings script's
    seeds)."""
    scene = scene if scene is not None else build_scene(arrays, device)
    return RenderEngine(scene, render_config(render, seed),
                        intersect_fn=intersect_fn, device=device)


def accel_name(eng: RenderEngine) -> str | None:
    return getattr(eng.intersect_fn, "accel", None)


def launch(fn, world: int, args: tuple, device: str) -> list:
    """fn(*args) on each of `world` ranks of one world, through the port's
    launcher (`parallel.launch.launch`: NCCL one rank a GPU on CUDA, with
    the kernels built once before the ranks start; gloo on the CPU); the
    ranks' return values, rank 0 first. A rank that raises fails it."""
    return port_launch.launch(fn, world, args, device=device)


def pixel_colors(eng: RenderEngine, pixels: np.ndarray) -> np.ndarray:
    """(P, 3) float32 accumulated colours of the listed pixel ids. Over a
    mesh, from the whole frame as the engine gathers it for `image()` (a
    collective: every rank calls it, and each gets the frame)."""
    if eng.mesh is not None:
        frame = eng._colors()
        idx = torch.as_tensor(np.asarray(pixels, np.int64),
                              device=frame.device)
        return frame[idx].cpu().numpy()
    idx = torch.as_tensor(np.asarray(pixels, np.int64),
                          device=eng.state.colors[0].device)
    return torch.stack([c[idx] for c in eng.state.colors], 1).cpu().numpy()


def samples_done(eng: RenderEngine) -> int:
    return int(eng.state.sample)
