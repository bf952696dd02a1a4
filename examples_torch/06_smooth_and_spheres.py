"""Analytic spheres + smooth shading: capabilities the reference lacks.

Twin of `examples/06_smooth_and_spheres.py` on the PyTorch/CUDA port.
The reference tessellates every sphere into a triangle mesh
(main.cpp:1002,1009) and shades with the face normal only (its Hit
struct carries just the plane normal, prog.cl:11-16). Here:

  * `cornell_box(analytic_spheres=True)` swaps the tessellated spheres
    for exact quadrics (core/spheres.py), intersected analytically (the
    sphere kernel K3) and min-merged with the triangle stream.
  * `cornell_box(smooth_spheres=True)` keeps the tessellation but
    attaches analytic vertex normals; `RenderConfig(smooth=True)`
    interpolates them at hit points (the smooth refine kernel K8 after
    the minarg kernel K1).

The JAX example renders with accel='bruteforce', the plain reference,
which the port refuses on CUDA; this twin names 'minarg', the kernels
whose plain versions are the same functions, so the CPU run rounds as
'bruteforce' does. CLI equivalent: `ptx-torch render --smooth`.

Runs on the GPU; `--device cpu` runs the plain versions on the CPU.
"""

import argparse
import os

import numpy as np

from opencl_path_tracer_tpu_torch.config import CameraConfig, RenderConfig
from opencl_path_tracer_tpu_torch.runtime.engine import RenderEngine
from opencl_path_tracer_tpu_torch.scene import library
from opencl_path_tracer_tpu_torch.utils.device import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="96x96")
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--out", default="smooth_spheres.png")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    w, h = (int(x) for x in args.size.split("x"))
    cam = CameraConfig(fov=60.0, yaw=0.0, pitch=0.0,
                       shift=(0.0, 0.0, 0.0))

    # 1. Analytic quadric spheres: the primitive's normal is exact by
    #    construction.
    scene_q = library.cornell_box(with_spheres=True, analytic_spheres=True,
                                  device=dev)
    eng = RenderEngine(scene_q, RenderConfig(
        width=w, height=h, iterations=4, spp=args.spp, mode="fast",
        accel="minarg", camera=cam), device=dev)
    eng.render(args.spp, progress=False)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    eng.save_png(args.out)
    print(f"analytic spheres -> {args.out}")

    # 2. Smooth-shaded tessellation: the reference's geometry, vertex
    #    normals interpolated at the hits.
    scene_s = library.cornell_box(with_spheres=True, smooth_spheres=True,
                                  device=dev)
    eng2 = RenderEngine(scene_s, RenderConfig(
        width=w, height=h, iterations=4, spp=args.spp, mode="fast",
        accel="minarg", smooth=True, camera=cam), device=dev)
    eng2.render(args.spp, progress=False)
    img_smooth = eng2.image()
    if not np.isfinite(img_smooth).all():
        raise SystemExit("the smooth-shaded image is not finite")
    print(f"smooth-shaded mesh spheres: {img_smooth.shape} rendered, "
          f"mean {img_smooth.mean():.4f}")


if __name__ == "__main__":
    main()
