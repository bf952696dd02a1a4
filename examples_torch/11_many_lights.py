"""Many-light rendering: distance-aware emitter selection.

Twin of `examples/11_many_lights.py` on the PyTorch/CUDA port. NEE
sends one shadow ray per diffuse vertex, but which lamp should it aim
at? With many lamps the default power-proportional pick
(`nee_select='power'`) sends most shadow rays to far-away lights;
`nee_select='distance'` weighs each lamp by P_j / max(d^2, r_j^2) per
shading point, with the pickup's MIS side recomputing the same weights,
so the estimator converges to the same image.

This example renders library.many_light_scene (cornell walls + N small
emissive spheres) both ways at the same spp and writes the pair side by
side. On the GPU the spheres go through the sphere kernels (K3, or the
culled sphere table K3b above 64 spheres) and the shadow rays through
the any-hit kernel K7.

Run:  python examples_torch/11_many_lights.py [--lights 48] [--spp 24]
Runs on the GPU; `--device cpu` runs the plain versions on the CPU.
"""

import argparse
import os

import numpy as np

from opencl_path_tracer_tpu_torch.config import CameraConfig, RenderConfig
from opencl_path_tracer_tpu_torch.io.image import write_png
from opencl_path_tracer_tpu_torch.runtime.engine import RenderEngine
from opencl_path_tracer_tpu_torch.scene import library
from opencl_path_tracer_tpu_torch.utils.device import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="160x120")
    ap.add_argument("--lights", type=int, default=48)
    ap.add_argument("--spp", type=int, default=24)
    ap.add_argument("--out", default="out/many_lights_demo.png")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    w, h = (int(x) for x in args.size.split("x"))

    scene = library.many_light_scene(args.lights, device=dev)
    halves = []
    for select in ("power", "distance"):
        cfg = RenderConfig(
            width=w, height=h, iterations=5, mode="fast",
            model="wavefront", nee=True, nee_select=select,
            spp=args.spp,
            camera=CameraConfig(fov=60.0, yaw=0.0, pitch=0.0,
                                shift=(0.0, 0.0, 0.0)),
        )
        eng = RenderEngine(scene, cfg, device=dev)
        eng.render(args.spp, progress=False)
        halves.append(eng.image())
        print(f"{select}: {args.spp} spp done")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    write_png(args.out, np.concatenate(halves, axis=1))
    print(f"wrote {args.out} (left: power, right: distance — same "
          f"spp, same converged image)")


if __name__ == "__main__":
    main()
