"""Multi-device rendering: the wavefront model tiled over ranks.

Twin of `examples/04_multi_device.py` on the PyTorch/CUDA port. The JAX
package drives a `jax.sharding.Mesh` from one process; the port runs
one process per rank (`parallel.launch.launch`: NCCL, one rank a GPU,
or gloo ranks on the CPU) over a 1-D device mesh. Each rank owns a
slice of the lane axis; because every wavefront lane carries its own
pixel binding, RNG stream and accumulators, the step
(`parallel.shard.make_tiled_wavefront_step`) needs no communication
but one all_reduce of the mean luminance for the meter. Per-lane
results equal one device's.

    python examples_torch/04_multi_device.py              # every GPU
    python examples_torch/04_multi_device.py --device cpu --devices 2
"""

import argparse
import os
import time

import numpy as np
import torch

from opencl_path_tracer_tpu_torch.io.image import write_png
from opencl_path_tracer_tpu_torch.models import wavefront
from opencl_path_tracer_tpu_torch.ops import rng, tonemap
from opencl_path_tracer_tpu_torch.parallel.launch import launch
from opencl_path_tracer_tpu_torch.parallel.mesh import make_render_mesh
from opencl_path_tracer_tpu_torch.parallel.shard import (
    gather_wavefront_state, make_tiled_wavefront_step, mesh_rank,
    shard_wavefront_state,
)
from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
from opencl_path_tracer_tpu_torch.scene import library
from opencl_path_tracer_tpu_torch.utils.device import resolve_device


def render_rank(w: int, h: int, steps: int, device_type: str) -> dict:
    """One rank's part (module level: the ranks unpickle it by name).
    Rank 0 returns the image and the meter; every rank the kernel
    launches its process made (a rank is a fresh process)."""
    from opencl_path_tracer_tpu_torch.ops.kernels import _build
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device("cpu"))
    mesh = make_render_mesh()
    n = w * h
    scene = library.cornell_box(with_spheres=True, device=dev)
    cam = library.cornell_camera(w, h, device=dev)
    isect = make_intersect_fn(scene, "auto")

    key = rng.key(3)
    state = shard_wavefront_state(
        wavefront.init_wavefront(cam, n, mode="fast", key=key), mesh)
    step = make_tiled_wavefront_step(
        cam, scene.mats, mesh, intersect_fn=isect, iterations=5,
        mode="fast", key=key,
    )
    t0 = time.time()
    for _ in range(steps):
        state, lum = step(state)
    lum = float(lum)
    dt = time.time() - t0
    out = dict(rank=mesh_rank(mesh), accel=isect.accel,
               launches={k: v for k, v in _build.launches.items() if v})
    full = gather_wavefront_state(state, mesh)
    if out["rank"] == 0:
        out.update(
            mesh=f"{mesh.size()} x {dev.type}", seconds=dt, luminance=lum,
            spp=float(full.samples.float().mean()),
            image=tonemap.reinhard(wavefront.colors_by_pixel(full, n))
            .reshape(h, w, 3).cpu().numpy())
    return out


def main(argv=None) -> list:
    """Returns each rank's kernel launches, rank 0 first."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="128x128")
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--out", default="out/example04.png")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks: one a GPU (0: every visible GPU); with "
                         "--device cpu, that many gloo ranks")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    w, h = (int(x) for x in args.size.split("x"))
    ranks = args.devices
    if ranks == 0:
        if dev.type != "cuda":
            raise SystemExit("--devices 0 is every visible GPU; with "
                             "--device cpu give the number of ranks")
        ranks = torch.cuda.device_count()
    n = w * h
    if n % ranks != 0:
        raise SystemExit(f"{w}x{h} = {n} lanes must divide evenly over "
                         f"{ranks} devices")

    res = launch(render_rank, ranks, (w, h, args.steps, dev.type),
                 device=dev.type)
    r0 = res[0]
    print(f"mesh: {r0['mesh']} (accel {r0['accel']})")
    print(f"{args.steps} steps in {r0['seconds']:.2f}s, mean "
          f"{r0['spp']:.1f} spp, meter luminance {r0['luminance']:.4f}")
    print(f"kernel launches by rank: {[r['launches'] for r in res]}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    write_png(args.out, np.ascontiguousarray(r0["image"][::-1]))
    print(f"wrote {args.out}")
    return [r["launches"] for r in res]


if __name__ == "__main__":
    main()
