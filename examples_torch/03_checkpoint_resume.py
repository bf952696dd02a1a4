"""Crash-safe progressive rendering: checkpoint, resume, verify.

Twin of `examples/03_checkpoint_resume.py` on the PyTorch/CUDA port.
The checkpoint carries the whole progressive state (accumulated colors,
per-pixel RNG streams, sample counter) in the JAX package's file
format, so a resumed render continues the exact sample sequence: (N spp
straight) and (N/2 spp, save, load, N/2 more) give bit-identical images
in parity mode. The reference has no recovery mechanism at all.

Runs on the GPU; `--device cpu` runs the plain versions on the CPU.
"""

import argparse
import os

import numpy as np

from opencl_path_tracer_tpu_torch.config import CameraConfig, RenderConfig
from opencl_path_tracer_tpu_torch.runtime.engine import RenderEngine
from opencl_path_tracer_tpu_torch.scene import library
from opencl_path_tracer_tpu_torch.utils.device import resolve_device


def make_engine(w: int, h: int, spp: int, device) -> RenderEngine:
    scene = library.cornell_box(with_spheres=False, device=device)
    cfg = RenderConfig(
        width=w, height=h, iterations=3, spp=spp, mode="parity",
        camera=CameraConfig(fov=60.0, yaw=0.0, pitch=0.0),
    )
    return RenderEngine(scene, cfg, device=device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="64x64")
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--ckpt", default="out/example03.ckpt.npz")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    w, h = (int(x) for x in args.size.split("x"))
    half = max(1, args.spp // 2)

    # Straight render.
    eng = make_engine(w, h, args.spp, dev)
    eng.render(2 * half, progress=False)
    straight = eng.image()

    # Render half, checkpoint, resume in a fresh engine, finish.
    eng1 = make_engine(w, h, args.spp, dev)
    eng1.render(half, progress=False)
    os.makedirs(os.path.dirname(args.ckpt) or ".", exist_ok=True)
    eng1.save(args.ckpt)
    eng2 = make_engine(w, h, args.spp, dev)
    eng2.load(args.ckpt)
    eng2.render(half, progress=False)
    resumed = eng2.image()

    if np.array_equal(straight, resumed):
        print(f"resume is bit-exact at {2 * half} spp "
              f"({w}x{h}, parity mode)")
    else:
        diff = int((straight != resumed).sum())
        raise SystemExit(f"MISMATCH: {diff} differing pixels")


if __name__ == "__main__":
    main()
