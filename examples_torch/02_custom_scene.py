"""Build a scene from scratch: materials, raw triangles, OBJ import.

Twin of `examples/02_custom_scene.py` on the PyTorch/CUDA port.
`SceneBuilder` is the analog of the reference's `Scene` class
(`Scene::add_Material` / `add_Triangle` / `add_Obj`,
main.cpp:529-617): declare materials, add geometry against them, and
`build(device=...)` uploads everything as structure-of-arrays tensors.
OBJ import applies the reference's transform pipeline (X flip, pitch,
yaw, scale, translate) and reads its custom MTL keys (Kn/Kk/Tp).

Runs on the GPU; `--device cpu` runs the plain versions on the CPU.
"""

import argparse
import os

from opencl_path_tracer_tpu_torch.config import CameraConfig, RenderConfig
from opencl_path_tracer_tpu_torch.runtime.engine import RenderEngine
from opencl_path_tracer_tpu_torch.scene.builder import SceneBuilder
from opencl_path_tracer_tpu_torch.utils.device import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="256x256")
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--out", default="out/example02.png")
    ap.add_argument(
        "--obj", default="tests/assets/models/sphere.obj",
        help="optional OBJ to drop into the scene ('' to skip)",
    )
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    w, h = (int(x) for x in args.size.split("x"))

    b = SceneBuilder()
    # Materials: (kd, ks, emission, N, K, shininess, type); type is
    # 0=diffuse 1=specular(conductor) 2=refractive 3=emitter, the
    # reference's Material struct field for field (prog.cl:10-16).
    z3 = (0.0, 0.0, 0.0)
    lamp = b.add_material(z3, z3, (120.0, 100.0, 80.0), z3, z3, 0, 3)
    white = b.add_material((0.3, 0.3, 0.3), z3, z3, z3, z3, 50, 0)
    b.add_material(z3, z3, z3, (0.17, 0.35, 1.50), (3.1, 2.7, 1.9), 0, 1)

    # A floor quad (two triangles) and a ceiling lamp.
    s = 1000.0
    b.add_triangle((-s, 0, -s), (s, 0, -s), (s, 0, s), white)
    b.add_triangle((-s, 0, -s), (s, 0, s), (-s, 0, s), white)
    b.end_obj()
    b.add_triangle((-200, 999, -200), (200, 999, -200),
                   (200, 999, 200), lamp)
    b.add_triangle((-200, 999, -200), (200, 999, 200),
                   (-200, 999, 200), lamp)
    b.end_obj()

    if args.obj and os.path.exists(args.obj):
        # Reference transform order: X-flip, pitch, yaw, scale,
        # translate (main.cpp:552-617); the OBJ's MTL materials are
        # appended after the hand-added ones.
        b.add_obj(args.obj, pos=(0.0, 250.0, 200.0),
                  scale=(150.0, 150.0, 150.0), pitch=0.0, yaw=30.0)

    scene = b.build(device=dev)
    print(f"{scene.num_triangles} triangles, "
          f"{scene.num_objects} objects")

    cfg = RenderConfig(
        width=w, height=h, iterations=5, spp=args.spp, mode="fast",
        camera=CameraConfig(fov=60.0, yaw=0.0, pitch=-10.0),
    )
    eng = RenderEngine(scene, cfg, device=dev)
    eng.render(args.spp)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    eng.save_png(args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
