"""UV interpolation: a procedural checker AOV from OBJ texcoords.

Twin of `examples/07_uv_checker.py` on the PyTorch/CUDA port. The
reference parses `vt` via tinyobj and never reads it (main.cpp:595-611).
Here OBJ texture coordinates flow end to end: loader (io/obj.py) ->
builder (per-corner uv) -> Scene.attribs -> ops.shading.interpolate_uvs
at hit points, which this example turns into a checker pattern.

Custom-integrator style (like 05): primary rays only, no light
transport; the output is an AOV, not a beauty render. The hits and the
winners' triangle ids come from `make_minarg_intersect(with_ids=True)`
(K1 then K2 on the GPU, their plain versions on the CPU).

Runs on the GPU; `--device cpu` runs the plain versions on the CPU.
"""

import argparse
import os
import tempfile

import torch

from opencl_path_tracer_tpu_torch.core.camera import make_camera
from opencl_path_tracer_tpu_torch.io.image import write_png
from opencl_path_tracer_tpu_torch.ops import raygen, shading
from opencl_path_tracer_tpu_torch.ops.kernels.plucker_kernel import (
    make_minarg_intersect,
)
from opencl_path_tracer_tpu_torch.scene.builder import SceneBuilder
from opencl_path_tracer_tpu_torch.utils.device import resolve_device


def _write_quad_obj(path: str) -> None:
    with open(path, "w") as fh:
        fh.write(
            "v -1 -1 0\nv 1 -1 0\nv -1 1 0\nv 1 1 0\n"
            "vt 0 0\nvt 1 0\nvt 0 1\nvt 1 1\n"
            "f 1/1 2/2 3/3\nf 2/2 4/4 3/3\n"
        )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="128x128")
    ap.add_argument("--tiles", type=int, default=8)
    ap.add_argument("--out", default="uv_checker.png")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    w, h = (int(x) for x in args.size.split("x"))

    b = SceneBuilder()
    b.add_material((1, 1, 1), (0, 0, 0), (0, 0, 0),
                   (1, 1, 1), (0, 0, 0), 1.0, 0)
    with tempfile.TemporaryDirectory() as tmp:
        obj = os.path.join(tmp, "quad.obj")
        _write_quad_obj(obj)
        # Scaled up and pushed in front of the reference camera.
        b.add_obj(obj, pos=(500.0, 500.0, 200.0),
                  scale=(400.0, 400.0, 1.0))
    scene = b.build(device=dev)
    if scene.attribs is None:
        raise SystemExit("the OBJ's texture coordinates were not loaded")

    cam = make_camera(w, h, fov=60.0, yaw=0.0, pitch=0.0,
                      shift=(0.0, 0.0, 0.0), device=dev)
    ids_px = raygen.pixel_ids(w, h, device=dev)
    half = torch.full(ids_px.shape, 0.5, dtype=torch.float32, device=dev)
    rays = raygen.camera_rays(cam, ids_px, half, half)

    hits, ids = make_minarg_intersect(scene.tris, with_ids=True)(rays)
    s, t = shading.interpolate_uvs(hits, ids, scene.attribs)
    k = float(args.tiles)
    checker = (torch.floor(s * k) + torch.floor(t * k)) % 2.0
    valid = hits.valid
    zero = torch.zeros_like(checker)
    rgb = torch.stack(
        [torch.where(valid, 0.15 + 0.8 * checker, zero),
         torch.where(valid, 0.15 + 0.8 * (1.0 - checker), zero + 0.02),
         torch.where(valid, zero + 0.35, zero + 0.05)], dim=-1,
    ).reshape(h, w, 3)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    write_png(args.out, rgb.flip(0).cpu().numpy())
    frac = float(checker[valid].mean())
    print(f"wrote {args.out}; hit {float(valid.float().mean()):.2f} "
          f"of pixels, checker balance {frac:.2f}")


if __name__ == "__main__":
    main()
