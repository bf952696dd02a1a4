"""PENDING lanes of the Plucker intersector at 1080p, JAX against the port.

Not a test (pytest does not collect it); a measurement on the CPU:

    JAX_PLATFORMS=cpu python tests/torch_pending_rate.py [N]

Builds the 1920x1080 camera rays of the tessellated Cornell box with the
draws `chip_smoke.py` uses (the Lehmer streams of gen_ray), takes N
seeded random pixels (default 40,000), and runs the port's plain K13a
and K13b (`make_plucker_intersect(...).rows`, bit-equal to the CUDA
kernels) on them. Then it runs the JAX package's kernels in interpret
mode on the first 4,096 of those rays plus every other lane the port
flagged, and prints the pending rates, whether the pending sets are
equal and whether all six rows are bit-equal. Takes about a minute.
"""

import pathlib
import sys
import time

import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from opencl_path_tracer_tpu.ops.pallas import plucker_kernel as jpk
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch.ops import raygen, rng
from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
from opencl_path_tracer_tpu_torch.ops.kernels import plucker_kernel as k2
from opencl_path_tracer_tpu_torch.scene import library

W, H, FIRST, TR = 1920, 1080, 4096, 1024


def main(n: int) -> None:
    torch.set_num_threads(4)
    cam = library.cornell_camera(W, H, device="cpu")
    s1, r1 = rng.lehmer_step(rng.seed_pixel_streams(W * H, 1, device="cpu"))
    _, r2 = rng.lehmer_step(s1)
    rays = raygen.camera_rays(cam, raygen.pixel_ids(W, H, "cpu"), r1, r2)
    sel = torch.randperm(W * H, generator=torch.Generator().manual_seed(0))
    rays8 = k1.pack_rays(rays.p, rays.d)[:, sel[:n]].contiguous()
    t0 = time.perf_counter()
    rows = k2.make_plucker_intersect(
        library.cornell_box(with_spheres=True, device="cpu").tris).rows(rays8)
    pend = rows[5] > 0
    print(f"port: {int(pend.sum())} of {n} random 1080p camera rays pending "
          f"({float(pend.float().mean()) * 100:.3f} %, "
          f"{time.perf_counter() - t0:.0f} s)")

    idx = torch.cat([torch.arange(FIRST),
                     torch.nonzero(pend[FIRST:])[:, 0] + FIRST])
    m = idx.shape[0]
    j8 = np.zeros((8, -(-m // TR) * TR), np.float32)
    j8[:, :m] = rays8[:, idx].numpy()
    jrows = np.stack([np.asarray(x)[0, :m] for x in jpk.make_plucker_intersect(
        jlib.cornell_box(with_spheres=True).tris, tr=TR,
        interpret=True).rows(jnp.asarray(j8))])
    jp, pp = jrows[5] > 0, pend[idx].numpy()
    same = (jrows.view(np.int32) == rows[:, idx].numpy().view(np.int32)).all()
    print(f"jax (interpret) on {m} rays: {int(jp.sum())} pending, port "
          f"{int(pp.sum())}; pending sets equal: {bool((jp == pp).all())}; "
          f"six rows bit-equal: {bool(same)}")
    print(f"first {FIRST} random rays: jax {int(jp[:FIRST].sum())} pending "
          f"({jp[:FIRST].mean() * 100:.3f} %), port {int(pp[:FIRST].sum())}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 40_000)
