"""K18 (the block march) built from two source trees and timed in one
process.

No counterpart in `opencl_path_tracer_tpu`. Compares the K18 kernel of
this checkout (`ptx_march`) with the K18 kernel of another checkout's
`csrc/` (its C interface must be the same) on the input `chip_smoke.py`
times K18 on: 'march' round 1 of the stress scene's 1080p camera rays
(99,380 triangles in clusters of 512, blocks of 512 lanes, 24 clusters
a block). Both builds use `_build`'s nvcc flags, run as base, this,
this, base (each the mean of --reps launches timed with CUDA events),
must give equal outputs, and one JSON line reports the four times.
Needs a GPU:

    python -m opencl_path_tracer_tpu_torch.runtime.march_ab --base DIR

where DIR is, for example, the `opencl_path_tracer_tpu_torch/csrc` of a
`git archive` of the parent commit unpacked in a gitignored directory.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re

import torch

from opencl_path_tracer_tpu_torch.runtime.minarg_ab import (
    _compile, time_in_turns)


def main(argv=None) -> int:
    from opencl_path_tracer_tpu_torch.ops import raygen, rng
    from opencl_path_tracer_tpu_torch.ops.kernels import _build
    from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
    from opencl_path_tracer_tpu_torch.ops.kernels import march_kernel as mk
    from opencl_path_tracer_tpu_torch.ops.kernels.plucker_kernel import (
        plucker_feat)
    from opencl_path_tracer_tpu_torch.scene import library
    from opencl_path_tracer_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True, type=pathlib.Path,
                    help="the csrc/ directory of the checkout to compare")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = {"base": args.base.resolve(), "this": _build.CSRC}
    procs = {k: _compile(d, out_dir / f"libmarch_{k}.so", "march.cu")
             for k, d in srcs.items()}
    fns, regs = {}, {}
    for k, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {k}:\n{log}")
        fn = ctypes.CDLL(str(out_dir / f"libmarch_{k}.so")).ptx_march
        fn.argtypes = _build.KERNELS["march"][2]
        fn.restype = ctypes.c_int
        fns[k] = fn
        regs[k] = [[int(x) for x in m] for m in re.findall(
            r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) "
            r"bytes spill loads\s+ptxas info\s+: Used (\d+) registers", log)]

    w, h, cs, tr, K = 1920, 1080, 512, 512, 24
    scene = library.stress_scene(device=dev)
    cam = library.cornell_camera(w, h, device=dev)
    s1, r1 = rng.lehmer_step(rng.seed_pixel_streams(w * h, 1, device=dev))
    _, r2 = rng.lehmer_step(s1)
    rays = raygen.camera_rays(cam, raygen.pixel_ids(w, h, dev), r1, r2)
    ms, _, _ = mk.build_march_scene(scene.tris, cs)
    r8 = k1.pack_rays(rays.p, rays.d, -(-rays.count // tr) * tr)
    order = torch.sort(mk.lane_key(r8[0:3], r8[3:6], ms), stable=True).indices
    r8s = r8[:, order].contiguous()
    feat = plucker_feat(r8s)
    ent, need = mk._slab_entries(r8s, ms, torch.full(
        (r8s.shape[1],), k1.BIG, device=dev))
    clist = mk._block_lists(ent, need, tr, K)
    del ent, need
    n = r8s.shape[1]
    outs = {k: torch.empty((7, n), device=dev) for k in fns}
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(k):
        err = fns[k](clist.data_ptr(), r8s.data_ptr(), feat.data_ptr(),
                     ms.trig.data_ptr(), ms.tric.data_ptr(),
                     outs[k].data_ptr(), n, K, tr, cs, stream)
        if err:
            raise RuntimeError(f"march ({k}) failed: cudaError_t {err}")

    order, times = time_in_turns(launch, args.reps, dev)
    equal = torch.equal(outs["base"], outs["this"])
    print(json.dumps({
        "kernel": "march", "input": "'march' round 1, stress camera rays",
        "lanes": n, "visits": int((clist >= 0).sum()), "reps": args.reps,
        "device": torch.cuda.get_device_name(dev), "order": list(order),
        "ms": times, "ptxas_frame_spills_registers": regs,
        "base_ms": (times[0] + times[3]) / 2,
        "this_ms": (times[1] + times[2]) / 2, "outputs_equal": equal,
    }))
    return 0 if equal else 1


if __name__ == "__main__":
    raise SystemExit(main())
