"""Compose the ops layer directly: rays -> hits -> inspect, no model.

Twin of `examples/05_low_level_ops.py` on the PyTorch/CUDA port.
Everything the render models do is built from these pieces; use them
directly for custom integrators, debugging, or research. The flow below
is the front half of one bounce as explicit calls: seed the reference's
per-pixel Lehmer streams (main.cpp:522-527), generate jittered camera
rays (camera_get_ray, prog.cl:82-92), intersect against the scene, and
fetch materials at the hits.

The intersector is the exact small-scene one, `make_minarg_intersect`
(the minarg kernel K1, then the attribute fetch K2, on the GPU; their
plain versions on the CPU), min-merged with the analytic sphere stream
(K3) where the scene has analytic spheres. `ops.intersect.
first_intersect` is the plain brute-force reference: it never launches
a kernel. Swap in `make_tilecull_intersect` or `make_pair_intersect`
for the culling kernels.

Runs on the GPU; `--device cpu` runs the plain versions on the CPU.
"""

import argparse

import torch

from opencl_path_tracer_tpu_torch.ops import intersect, raygen, rng
from opencl_path_tracer_tpu_torch.ops.kernels.plucker_kernel import (
    make_minarg_intersect,
)
from opencl_path_tracer_tpu_torch.ops.kernels.sphere_kernel import (
    make_sphere_intersect,
)
from opencl_path_tracer_tpu_torch.scene import library
from opencl_path_tracer_tpu_torch.utils.device import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="64x64")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    w, h = (int(x) for x in args.size.split("x"))
    n = w * h

    scene = library.cornell_box(with_spheres=True, device=dev)
    cam = library.cornell_camera(w, h, device=dev)

    # Per-pixel RNG streams, seeded exactly like the reference host
    # (one minstd_rand0 draw per pixel). Fast mode instead uses a
    # stateless counter hash: see ops/rng.py.
    streams = rng.seed_pixel_streams(n, device=dev)

    # Jittered primary rays for pixel ids 0..n-1: two Lehmer draws per
    # pixel, advancing each stream like the reference's rand().
    ids = raygen.pixel_ids(w, h, device=dev)
    streams, u1 = rng.lehmer_step(streams)
    streams, u2 = rng.lehmer_step(streams)
    rays = raygen.camera_rays(cam, ids, u1, u2)

    # Nearest hit for every ray (t < 0 encodes a miss).
    tri_fn = make_minarg_intersect(scene.tris)
    hits = tri_fn(rays)
    if scene.spheres is not None:
        hits = intersect.merge_hits(hits,
                                    make_sphere_intersect(scene.spheres)(rays))
    hit_mask = hits.t >= 0.0

    # Per-ray material fetch on the hit lanes.
    m = scene.mats.take(torch.clamp_min(hits.mati, 0))
    emissive = sum(m.emission) > 0.0

    print(f"{n} rays: {int(hit_mask.sum())} hits, "
          f"{int((~hit_mask).sum())} misses")
    print(f"lamp lanes: {int((emissive & hit_mask).sum())}")
    t = hits.t[hit_mask]
    print(f"mean hit distance: {float(t.mean()):.1f}")
    if not bool(torch.isfinite(t).all()):
        raise SystemExit("a hit distance is not finite")
    print("all hit distances finite — ok")


if __name__ == "__main__":
    main()
