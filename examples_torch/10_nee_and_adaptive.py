"""Smarter sampling: next-event estimation + adaptive sampling.

Twin of `examples/10_nee_and_adaptive.py` on the PyTorch/CUDA port.
Two extensions that improve rays-to-quality rather than rays/sec (the
reference has neither: its loop gives every pixel every sample and
finds light only by chance, prog.cl:358-381):

  * NEE with MIS (ops/nee.py): one shadow ray per diffuse vertex
    gathers direct light explicitly, combined with the BSDF-sampled
    emitter pickup by balance-heuristic weights.
  * Adaptive sampling (models.wavefront.render_adaptive): per-pixel
    Welford variance stops each pixel at a target luminance standard
    error; converged lanes are compacted away.

This example renders cornell three ways at a matched small ray budget
and writes the trio side by side: base 16 spp, NEE 8 spp, and
NEE+adaptive (tol 0.05, 4..32 spp as needed). The intersector is the
engine's 'auto' without a camera (the minarg kernel K1 + K2 on the GPU;
K3 for the analytic spheres of --sphere-lamp); NEE's shadow rays go
through the same intersector, as in the JAX script (the engine sends
them through the any-hit kernel K7 instead).

Run:  python examples_torch/10_nee_and_adaptive.py [--size 128x96]
      (--sphere-lamp swaps the lamp quad for an emissive analytic
      sphere: NEE then rides the solid-angle cone sampler)
Runs on the GPU; `--device cpu` runs the plain versions on the CPU.
"""

import argparse
import os

import numpy as np

from opencl_path_tracer_tpu_torch.io.image import write_png
from opencl_path_tracer_tpu_torch.models import wavefront
from opencl_path_tracer_tpu_torch.ops import nee, tonemap
from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
from opencl_path_tracer_tpu_torch.scene import library
from opencl_path_tracer_tpu_torch.utils.device import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="128x96")
    ap.add_argument("--out", default="out/nee_adaptive_demo.png")
    ap.add_argument("--sphere-lamp", action="store_true",
                    help="emissive analytic-sphere lamp (cone-sampled "
                         "NEE) instead of the lamp quad")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    w, h = (int(x) for x in args.size.split("x"))

    scene = library.cornell_box(with_spheres=True,
                                analytic_spheres=args.sphere_lamp,
                                sphere_lamp=args.sphere_lamp, device=dev)
    cam = library.cornell_camera(w, h, device=dev)
    isect = make_intersect_fn(scene, "auto")
    table = nee.build_emitter_table(scene.tris, scene.mats, scene.spheres)
    kw = dict(intersect_fn=isect, num_pixels=w * h, iterations=5,
              mode="fast", device=dev)

    base = wavefront.render_wavefront(
        cam, scene.mats, min_spp=16, exact_spp=True, seed=1, **kw)
    neer = wavefront.render_wavefront(
        cam, scene.mats, min_spp=8, exact_spp=True, seed=1,
        nee=table, **kw)
    adap = wavefront.render_adaptive(
        cam, scene.mats, tol=0.05, max_spp=32, min_spp=4, seed=1,
        nee=table, **kw)

    def tile(st):
        img = tonemap.reinhard(wavefront.colors_by_pixel(st, w * h))
        return img.reshape(h, w, 3).cpu().numpy()[::-1]

    trio = np.concatenate([tile(base), tile(neer), tile(adap)], axis=1)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    write_png(args.out, trio)
    smp = adap.samples.cpu().numpy()
    print(f"wrote {args.out} (left: base 16spp | middle: NEE 8spp | "
          f"right: NEE+adaptive spp {smp.min()}..{smp.max()} "
          f"mean {smp.mean():.1f})")


if __name__ == "__main__":
    main()
