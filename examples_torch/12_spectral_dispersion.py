"""Spectral dispersion: rainbows through glass.

Twin of `examples/12_spectral_dispersion.py` on the PyTorch/CUDA port.
The reference's dielectric bends all light identically (main.cpp:103
collapses the per-channel IOR to one scalar). `models/spectral.py`
renders B wavelength bands, each an ordinary wavefront pass whose
refractive rows carry n(lambda) from the Abbe/Cauchy model, and
combines them to RGB with per-channel partition-of-unity weights.

This example renders the analytic-glass cornell twice, achromatic (the
reference's physics) and as a strong flint (V_d=20), and writes the
pair side by side: look at the glass sphere's rim and caustic.

Run:  python examples_torch/12_spectral_dispersion.py [--spp 24] [--abbe 20]
      (equivalent CLI: ptx-torch render --model wavefront --dispersion 20)
Runs on the GPU; `--device cpu` runs the plain versions on the CPU.
"""

import argparse
import os

import torch

from opencl_path_tracer_tpu_torch.io.image import write_png
from opencl_path_tracer_tpu_torch.models import spectral
from opencl_path_tracer_tpu_torch.ops import tonemap as tonemap_ops
from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
from opencl_path_tracer_tpu_torch.scene import library
from opencl_path_tracer_tpu_torch.utils.device import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="160x120")
    ap.add_argument("--spp", type=int, default=24)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--abbe", type=float, default=20.0,
                    help="Abbe number (lower = stronger dispersion)")
    ap.add_argument("--bands", type=int, default=3)
    ap.add_argument("--out", default="out/spectral_dispersion.png")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    w, h = (int(x) for x in args.size.split("x"))

    scene = library.cornell_box(with_spheres=True, analytic_spheres=True,
                                device=dev)
    cam = library.cornell_camera(w, h, device=dev)
    isect = make_intersect_fn(scene, "auto", cam=cam,
                              iterations=args.iters)

    def render(v_d):
        return spectral.render_dispersive(
            cam, scene.mats, intersect_fn=isect, num_pixels=w * h,
            iterations=args.iters, min_spp=args.spp,
            bands=args.bands, v_d=v_d,
        ).reshape(h, w, 3).flip(0)

    flat = render(None)          # the reference's achromatic glass
    disp = render(args.abbe)     # flint-glass rainbow

    pair = torch.cat([flat, disp], dim=1)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    write_png(args.out, tonemap_ops.apply(pair, "reinhard").cpu().numpy())
    delta = float((disp - flat).abs().max())
    print(f"wrote {args.out} (achromatic | V_d={args.abbe:g}); "
          f"max channel split {delta:.4f}")


if __name__ == "__main__":
    main()
