"""Render the Cornell box to a PNG with the high-level engine.

Twin of `examples/01_render_cornell.py` on the PyTorch/CUDA port: the
library form of `ptx-torch render --scene cornell`. Build a scene,
configure the render, run N samples a pixel, write the image. The
engine picks the intersector for the device and scene (`accel='auto'`:
on the GPU the host predictor chooses between the tile-culling kernel
and the exact minarg kernel; on the CPU the kernels' plain versions).

Runs on the GPU; `--device cpu` runs the plain versions on the CPU.
"""

import argparse
import os

from opencl_path_tracer_tpu_torch.config import CameraConfig, RenderConfig
from opencl_path_tracer_tpu_torch.runtime.engine import RenderEngine
from opencl_path_tracer_tpu_torch.scene import library
from opencl_path_tracer_tpu_torch.utils.device import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="256x256")
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--out", default="out/example01.png")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    w, h = (int(x) for x in args.size.split("x"))

    scene = library.cornell_box(with_spheres=True, device=dev)
    cfg = RenderConfig(
        width=w, height=h, iterations=5, spp=args.spp, mode="fast",
        camera=CameraConfig(fov=60.0, yaw=0.0, pitch=0.0),
    )
    eng = RenderEngine(scene, cfg, device=dev)
    eng.render(args.spp)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    eng.save_png(args.out)
    print(f"wrote {args.out} ({w}x{h}, {args.spp} spp)")


if __name__ == "__main__":
    main()
