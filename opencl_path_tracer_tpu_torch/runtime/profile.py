"""Where a sample's time goes on the card.

No counterpart module in `opencl_path_tracer_tpu` (its profiling helper,
`utils/profiling.py`, wraps `jax.profiler`). Renders a few samples of a
Cornell scene through `RenderEngine` under `torch.profiler` and prints
one JSON line: wall time per sample, device busy time per sample and the
busy share, device launches per sample, and the kernels that take the
most device time. Needs a GPU:

    python -m opencl_path_tracer_tpu_torch.runtime.profile --scene cornell
"""

from __future__ import annotations

import argparse
import collections
import json
import time

import torch


def main(argv=None) -> int:
    from opencl_path_tracer_tpu_torch.cli import _build_scene
    from opencl_path_tracer_tpu_torch.config import CameraConfig, RenderConfig
    from opencl_path_tracer_tpu_torch.runtime.engine import RenderEngine
    from opencl_path_tracer_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="cornell")
    ap.add_argument("--size", default="1920x1080")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--mode", default="fast")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    w, h = (int(x) for x in args.size.split("x"))
    cfg = RenderConfig(width=w, height=h, iterations=args.iters,
                       mode=args.mode,
                       camera=CameraConfig(fov=60.0, yaw=0.0, pitch=0.0,
                                           shift=(0.0, 0.0, 0.0)))
    eng = RenderEngine(_build_scene(args.scene, dev), cfg, device=dev)
    eng.render(1)  # warm-up: kernel build, allocator, first launches
    # The profiler slows the host; the busy share divides the profiled
    # device time by the wall time of an unprofiled run of equal length.
    t0 = time.perf_counter()
    eng.render(args.spp)
    wall_plain = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng.render(args.spp)
        wall = time.perf_counter() - t0
    busy_us, launches = 0.0, 0
    by_name: dict[str, float] = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            busy_us += us
            launches += 1
            by_name[e.name] += us
    top = [{"name": n[:80], "ms_per_sample": us / 1e3 / args.spp}
           for n, us in by_name.most_common(8)]
    print(json.dumps({
        "scene": args.scene, "size": args.size, "bounces": args.iters,
        "mode": args.mode, "spp": args.spp,
        "device": torch.cuda.get_device_name(dev),
        "wall_ms_per_sample": wall_plain * 1e3 / args.spp,
        "profiled_wall_ms_per_sample": wall * 1e3 / args.spp,
        "device_busy_ms_per_sample": (busy_us / 1e3 / args.spp
                                      if launches else None),
        "busy_share": (busy_us / 1e6 / wall_plain if launches else None),
        "device_launches_per_sample": launches / args.spp,
        "top_kernels": top,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
