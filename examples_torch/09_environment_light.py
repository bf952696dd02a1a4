"""Environment (sky) light: the reference kernel's dormant feature.

Twin of `examples/09_environment_light.py` on the PyTorch/CUDA port.
The shipped OpenCL kernel breaks on a miss with no light contribution,
but its miss branch carries commented-out sky-light code
(prog.cl:367-376): primary misses see the sky color directly, misses on
specular-only paths see the sky tinted by the path throughput, and
misses after a diffuse bounce pick up a white ambient fill. The port
resurrects that code as an opt-in (`env_light=True`, or `ptx-torch
render --env`); off, miss shading stays shipped-kernel parity.

This scene is an open horizon (a matte floor next to a mirror floor
under an empty sky), so all three miss tiers are visible.

--envmap swaps the constant sky for image-based lighting
(ops/envmap.py): an equirect radiance map ('sunsky': a small bright
sun disc) with a luminance-importance-sampled gather + MIS from every
diffuse vertex; its escape rays go through the any-hit kernel K7.

Runs on the GPU; `--device cpu` runs the plain versions on the CPU.
"""

import argparse
import os

from opencl_path_tracer_tpu_torch.config import CameraConfig, RenderConfig
from opencl_path_tracer_tpu_torch.runtime.engine import RenderEngine
from opencl_path_tracer_tpu_torch.scene.builder import SceneBuilder
from opencl_path_tracer_tpu_torch.scene.library import add_sphere
from opencl_path_tracer_tpu_torch.utils.device import resolve_device


def open_horizon_scene(device):
    b = SceneBuilder()
    matte = b.add_material((0.55, 0.45, 0.35), (1.0, 1.0, 1.0),
                           (0.0, 0.0, 0.0), (1.0, 1.0, 1.0),
                           (0.0, 0.0, 0.0), 50.0, 0)
    mirror = b.add_material((0.0, 0.0, 0.0), (0.0, 0.0, 0.0),
                            (0.0, 0.0, 0.0), (0.2, 0.2, 0.2),
                            (3.0, 3.0, 3.0), 0.0, 1)
    red = b.add_material((0.7, 0.12, 0.08), (1.0, 1.0, 1.0),
                         (0.0, 0.0, 0.0), (1.0, 1.0, 1.0),
                         (0.0, 0.0, 0.0), 50.0, 0)
    for mat, x0, x1 in ((matte, -6000.0, 500.0),
                        (mirror, 500.0, 7000.0)):
        z0, z1 = -2000.0, 9000.0
        b.add_triangle((x0, 0, z0), (x1, 0, z0), (x1, 0, z1), mat)
        b.add_triangle((x0, 0, z0), (x1, 0, z1), (x0, 0, z1), mat)
    # Spheres on the ground: a matte one sky-lit from above, a mirror
    # one reflecting sky + ground (both pure env-lit: no emitter).
    add_sphere(b, center=(150.0, 280.0, 1500.0), radius=280.0, mat=red)
    add_sphere(b, center=(900.0, 330.0, 2100.0), radius=330.0,
               mat=mirror)
    b.end_obj()
    return b.build(device=device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="256x256")
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--out", default="out/example09.png")
    ap.add_argument("--envmap", default=None,
                    choices=["sunsky", "gradient"],
                    help="image-based environment instead of the "
                         "constant sky (importance-sampled NEE + MIS)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    w, h = (int(x) for x in args.size.split("x"))

    env_kw = (
        dict(env_map=args.envmap, env_scale=1.0)
        if args.envmap else
        dict(env_light=True,             # the dormant prog.cl:367-376
             env_sky=(0.25, 0.55, 1.0))  # softer blue than 0/0.75/2
    )
    cfg = RenderConfig(
        width=w, height=h, iterations=8, spp=args.spp, mode="fast",
        camera=CameraConfig(fov=60.0, yaw=0.0, pitch=14.0,
                            shift=(0.0, 0.0, 0.0)),
        **env_kw,
    )
    eng = RenderEngine(open_horizon_scene(dev), cfg, device=dev)
    eng.render(cfg.spp, progress=False)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    eng.save_png(args.out)
    kind = args.envmap or "constant sky"
    print(f"wrote {args.out} (env-lit open scene, {kind}, "
          f"{cfg.spp} spp)")


if __name__ == "__main__":
    main()
