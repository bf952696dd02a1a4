"""Image textures: an OBJ + MTL `map_Kd` rendered end to end.

Twin of `examples/08_textured_obj.py` on the PyTorch/CUDA port. The
reference's tinyobjloader parses `map_Kd` (tiny_obj_loader.h:124-182)
but the reference never samples it: materials stay flat colors
(main.cpp:564-581). Here the PNG loads with the OBJ, lands in a padded
SoA atlas (core/textures.py), and bilinear repeat-wrap samples at the
hit UV modulate `kd` (`RenderConfig(textured=True)` / `ptx-torch render
--textured`).

This script writes a self-contained asset set (checker PNG + MTL + OBJ
quad under a small emissive panel), renders it lit with the megakernel
engine, and saves the beauty image. The JAX example renders with
accel='bruteforce', the plain reference the port refuses on CUDA; this
twin names 'minarg', the ids-reporting kernels (K1, K2) whose plain
versions are the same functions.

Runs on the GPU; `--device cpu` runs the plain versions on the CPU.
"""

import argparse
import os

import numpy as np

from opencl_path_tracer_tpu_torch.config import CameraConfig, RenderConfig
from opencl_path_tracer_tpu_torch.io.image import write_png
from opencl_path_tracer_tpu_torch.runtime.engine import RenderEngine
from opencl_path_tracer_tpu_torch.scene.builder import SceneBuilder
from opencl_path_tracer_tpu_torch.utils.device import resolve_device


def _write_assets(d: str) -> str:
    c = np.indices((8, 8)).sum(0) % 2
    img = np.where(c[..., None].astype(bool),
                   np.float32([1.0, 1.0, 1.0]),
                   np.float32([1.0, 0.2, 0.2]))
    write_png(os.path.join(d, "checker.png"), img.astype(np.float32))
    with open(os.path.join(d, "floor.mtl"), "w") as fh:
        fh.write(
            "newmtl floor\nKd 0.9 0.9 0.9\nKs 0 0 0\nKe 0 0 0\n"
            "Ns 1\nKn 1 1 1\nKk 0 0 0\nTp 0\nmap_Kd checker.png\n"
        )
    obj = os.path.join(d, "floor.obj")
    with open(obj, "w") as fh:
        # Cornell-scale floor quad extending under the camera (eye is
        # (500, 500, -1299)); vt spans 4 repeats to show the
        # repeat-wrap. add_obj X-flips, so file x = -world x.
        fh.write(
            "mtllib floor.mtl\n"
            "v 1500 0 -2000\nv -2500 0 -2000\n"
            "v 1500 0 1000\nv -2500 0 1000\n"
            "vt 0 0\nvt 4 0\nvt 0 3\nvt 4 3\n"
            "usemtl floor\nf 1/1 2/2 3/3\nf 2/2 4/4 3/3\n"
        )
    return obj


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="192x128")
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--out", default="textured.png")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    w, h = (int(x) for x in args.size.split("x"))

    d = os.path.dirname(os.path.abspath(args.out)) or "."
    os.makedirs(d, exist_ok=True)
    b = SceneBuilder()
    b.add_obj(_write_assets(d), pos=(0, 0, 0), scale=(1, 1, 1))
    # Emissive ceiling panel lighting the textured floor.
    lamp = b.add_material((0, 0, 0), (0, 0, 0), (25, 25, 25),
                          (1, 1, 1), (0, 0, 0), 1.0, 3)
    b.add_triangle((0, 999, 0), (0, 999, 1000), (1000, 999, 0), lamp)
    b.add_triangle((1000, 999, 0), (0, 999, 1000), (1000, 999, 1000),
                   lamp)
    scene = b.build(device=dev)
    if scene.textures is None:
        raise SystemExit("map_Kd did not load")

    cfg = RenderConfig(
        width=w, height=h, iterations=4, spp=args.spp, mode="fast",
        accel="minarg", textured=True,
        camera=CameraConfig(fov=60.0, yaw=0.0, pitch=25.0,
                            shift=(0.0, 0.0, 0.0)),
    )
    eng = RenderEngine(scene, cfg, device=dev)
    eng.render(cfg.spp, progress=False)
    eng.save_png(args.out)
    print(f"wrote {args.out} ({w}x{h}, {args.spp} spp, "
          f"{scene.textures.count} texture)")


if __name__ == "__main__":
    main()
