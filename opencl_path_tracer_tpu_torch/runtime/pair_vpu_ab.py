"""K12 (the VPU pairs round) built from two source trees and timed in one
process.

No counterpart in `opencl_path_tracer_tpu`. Compares the K12 kernel of
this checkout (`ptx_pair_vpu`) with the K12 kernel of another
checkout's `csrc/`, on the inputs `chip_smoke.py` times K12 on: round 1
of the stress scene's 1080p camera pairs at the 'pair' defaults (K9's 8
nearest of 195 clusters of 512 per ray, sorted by key in tiles of
1,024), and the same round for the first-bounce rays (the camera rays'
hits shaded once). The two kernels read the same sub-block table
(`sorted_intersect.pair_sub_boxes`). `--base-rounds R` is for a base
whose entry takes, before its coop_max, the number of 256-pair runs a
CUDA block walks (the interface before that argument was taken out); R
is passed there. Both builds use `_build`'s nvcc flags and run as base,
this, this, base (each the mean of --reps launches timed with CUDA
events), must give equal outputs, and one JSON line per input reports
the four times. Needs a GPU:

    python -m opencl_path_tracer_tpu_torch.runtime.pair_vpu_ab --base DIR \\
        [--base-rounds R]

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
    _bounce, _compile, time_in_turns)

W, H = 1920, 1080


def main(argv=None) -> int:
    from opencl_path_tracer_tpu_torch.ops import raygen, rng
    from opencl_path_tracer_tpu_torch.ops.kernels import _build
    from opencl_path_tracer_tpu_torch.ops.kernels import cluster_kernel as ck
    from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
    from opencl_path_tracer_tpu_torch.ops.kernels import pair_mxu as pm
    from opencl_path_tracer_tpu_torch.ops.kernels import sorted_intersect as si
    from opencl_path_tracer_tpu_torch.scene import library
    from opencl_path_tracer_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True, type=pathlib.Path,
                    help="the csrc/ directory of the checkout to compare")
    ap.add_argument("--base-rounds", type=int, default=None,
                    help="runs of pairs a block, for a base entry that "
                         "takes them")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = {"base": args.base.resolve(), "this": _build.CSRC}
    procs = {k: _compile(d, out_dir / f"libpair_vpu_{k}.so", "pair_vpu.cu")
             for k, d in srcs.items()}
    fns, regs = {}, {}
    for k, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {k}:\n{log}")
        fn = ctypes.CDLL(str(out_dir / f"libpair_vpu_{k}.so")).ptx_pair_vpu
        argtypes = list(_build.KERNELS["pair_vpu"][2])
        if k == "base" and args.base_rounds is not None:
            argtypes.insert(-2, ctypes.c_int)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[k] = fn
        regs[k] = [[int(x) for x in m] for m in re.findall(
            r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) "
            r"bytes spill loads\s+ptxas info\s+: Used (\d+) registers", log)]

    scene = library.stress_scene(device=dev)
    cam = library.cornell_camera(W, H, device=dev)
    s1, r1 = rng.lehmer_step(rng.seed_pixel_streams(W * H, 1, device=dev))
    _, r2 = rng.lehmer_step(s1)
    cam_rays = raygen.camera_rays(cam, raygen.pixel_ids(W, H, dev), r1, r2)
    _, rest = si.split_by_size(scene.tris)
    cs = si._auto_cluster_size(rest.count, 512)
    cscene, c, k = ck.build_clusters(rest, cs)
    rows = torch.cat([cscene.rows(), torch.zeros((k, 24), device=dev)])
    sub = si.pair_sub_boxes(rows, k)
    boxes_r = torch.zeros((-(-c // 128) * 128, 8), device=dev)
    boxes_r[:c] = cscene.boxes
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = 0
    for name, rays in (("camera", cam_rays),
                       ("first-bounce", _bounce(scene, cam, cam_rays))):
        r8 = k1.pack_rays(rays.p, rays.d).contiguous()
        ids = si.run_candidates(r8, boxes_r, 8, c)
        keys, r8p, _ = pm.sort_pairs([r8[j] for j in range(6)], ids[0], c,
                                     1024)
        p = keys.shape[0]
        outs = {kk: torch.empty((5, p), device=dev) for kk in fns}

        def launch(kk):
            extra = ((args.base_rounds,) if kk == "base"
                     and args.base_rounds is not None else ())
            err = fns[kk](keys.data_ptr(), r8p.data_ptr(), rows.data_ptr(),
                          sub.data_ptr(), outs[kk].data_ptr(), p, c, k,
                          *extra, si.PAIR_COOP, stream)
            if err:
                raise RuntimeError(f"pair_vpu ({kk}) failed: cudaError_t "
                                   f"{err}")

        order, times = time_in_turns(launch, args.reps, dev)
        equal = torch.equal(outs["base"], outs["this"])
        status |= not equal
        print(json.dumps({
            "kernel": "pair_vpu",
            "input": f"round 1, stress {name} pairs ('pair' defaults)",
            "pairs": p, "real": int((keys < c).sum()),
            "base_rounds": args.base_rounds, "coop_max": si.PAIR_COOP,
            "reps": args.reps, "device": torch.cuda.get_device_name(dev),
            "order": list(order), "ms": times,
            "ptxas_frame_spills_registers": regs,
            "base_ms": (times[0] + times[3]) / 2,
            "this_ms": (times[1] + times[2]) / 2, "outputs_equal": equal,
        }))
    return status


if __name__ == "__main__":
    raise SystemExit(main())
