"""K18 (the block march), K19 (the flat march) or K20 (the lazy march)
built from two source trees and timed in one process.

No counterpart in `opencl_path_tracer_tpu`. Compares the kernel of this
checkout with the same kernel of another checkout's `csrc/` (its C
interface must be the same), on the inputs `chip_smoke.py` times it on,
at the stress scene's 1080p shapes (99,380 triangles):

- `--kernel march` (the default): K18 (`ptx_march`) on 'march' round 1
  of the camera rays (clusters of 512, blocks of 512 lanes, 24 clusters
  a block);
- `--kernel flat`: K19 (`ptx_flat`) on the 'flat' intersector's round 1
  of the camera rays, or with `--bounce` of the first-bounce rays (the
  camera rays' hits shaded once), captured from the intersector;
- `--kernel lazy`: K20 (`ptx_lazy`) on the lazy pipeline's second step,
  captured from the pipeline.

Both builds use `_build`'s nvcc flags, run as base, this, this, base
(each the mean of --reps launches timed with CUDA events), must give
equal outputs, and one JSON line reports the four times. Needs a GPU:

    python -m opencl_path_tracer_tpu_torch.runtime.march_ab --base DIR \\
        [--kernel march|flat|lazy] [--bounce]

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
# --kernel -> (source, the _build kernel name of its entry).
SOURCES = {"march": ("march.cu", "march"), "flat": ("flat.cu", "flat_march"),
           "lazy": ("lazy.cu", "lazy_march")}


def _march_input(scene, rays, dev):
    """K18's C arguments on 'march' round 1 of `rays`: (description,
    arguments before the outputs, outputs, arguments after them)."""
    from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
    from opencl_path_tracer_tpu_torch.ops.kernels import march_kernel as mk
    from opencl_path_tracer_tpu_torch.ops.kernels.plucker_kernel import (
        plucker_feat)
    cs, tr, K = 512, 512, 24
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
    return ({"input": "'march' round 1", "lanes": n,
             "visits": int((clist >= 0).sum())},
            (clist, r8s, feat, ms.trig, ms.tric),
            lambda: [torch.empty((7, n), device=dev)], (n, K, tr, cs))


def _flat_input(scene, rays, dev):
    """K19's C arguments on the 'flat' intersector's round 1 of `rays`
    (its call captured), as `flat_march._launch_chunks` makes them."""
    from opencl_path_tracer_tpu_torch.ops.kernels import flat_march as fm
    real, got = fm.run_flat, []

    def capture(*a):
        got.append(a)
        return real(*a)

    isect, _ = fm.make_flat_march_intersect(scene.tris)
    fm.run_flat = capture
    try:
        isect(rays)
    finally:
        fm.run_flat = real
    vb, vc, r8, feat, rows0, ms, cs, tr = got[-1]
    n = r8.shape[1]
    items, vcr, _ = fm.flat_chunks(vb, vc, n // tr, fm.CHUNK)

    def outs():   # the chunks' merged (t, g) bits and pend flags, the rows
        return [torch.empty((n,), dtype=torch.int64, device=dev),
                torch.empty((n,), dtype=torch.int32, device=dev),
                torch.empty((7, n), device=dev)]

    return ({"input": "'flat' round 1", "lanes": n,
             "visits": int((vc >= 0).sum()), "chunk": fm.CHUNK},
            (items, items.shape[1], vcr, r8, feat, rows0, ms.trig, ms.tric),
            outs, (n, tr, cs))


def _lazy_input(scene, cam, dev):
    """K20's C arguments on the lazy pipeline's second step (its call
    captured), as `lazy_march._launch` makes them."""
    from opencl_path_tracer_tpu_torch.models import lazy
    from opencl_path_tracer_tpu_torch.ops import rng
    step, init, _ = lazy.make_lazy_pipeline(scene.tris, cs=512, tr=256, K=4,
                                            tail=4096)
    real, got = lazy.run_lazy_march, []

    def capture(*a):
        got.append(a)
        return real(*a)

    key = rng.key(1)
    st = init(cam, W * H, mode="fast", key=key)
    lazy.run_lazy_march = capture
    try:
        for _ in range(2):
            st = step(cam, scene.mats, st, iterations=5, mode="fast", key=key)
    finally:
        lazy.run_lazy_march = real
    clist, r8, feat, rows_in, vis, ms, cs, K, tr = got[-1]
    n = r8.shape[1]
    return ({"input": "the lazy pipeline's second step", "lanes": n,
             "visits": int((clist >= 0).sum())},
            (clist, r8, feat, rows_in, vis, ms.trig, ms.tric),
            lambda: [torch.empty((7, n), device=dev), torch.empty_like(vis)],
            (n, K, tr, cs, vis.shape[0]))


def main(argv=None) -> int:
    from opencl_path_tracer_tpu_torch.ops import raygen, rng
    from opencl_path_tracer_tpu_torch.ops.kernels import _build
    from opencl_path_tracer_tpu_torch.scene import library
    from opencl_path_tracer_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True, type=pathlib.Path,
                    help="the csrc/ directory of the checkout to compare")
    ap.add_argument("--kernel", choices=sorted(SOURCES), default="march")
    ap.add_argument("--bounce", action="store_true",
                    help="the first-bounce rays (march and flat)")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    src, entry = SOURCES[args.kernel]
    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = {"base": args.base.resolve(), "this": _build.CSRC}
    stem = src[:-3]
    procs = {k: _compile(d, out_dir / f"lib{stem}_{k}.so", src)
             for k, d in srcs.items()}
    fns, regs = {}, {}
    for k, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {k}:\n{log}")
        fn = getattr(ctypes.CDLL(str(out_dir / f"lib{stem}_{k}.so")),
                     _build.KERNELS[entry][1])
        fn.argtypes = _build.KERNELS[entry][2]
        fn.restype = ctypes.c_int
        fns[k] = fn
        regs[k] = [[int(x) for x in m] for m in re.findall(
            r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) "
            r"bytes spill loads\s+ptxas info\s+: Used (\d+) registers", log)]

    scene = library.stress_scene(device=dev)
    cam = library.cornell_camera(W, H, device=dev)
    s1, r1 = rng.lehmer_step(rng.seed_pixel_streams(W * H, 1, device=dev))
    _, r2 = rng.lehmer_step(s1)
    rays = raygen.camera_rays(cam, raygen.pixel_ids(W, H, dev), r1, r2)
    if args.bounce:
        rays = _bounce(scene, cam, rays)
    if args.kernel == "march":
        info, before, make_outs, after = _march_input(scene, rays, dev)
    elif args.kernel == "flat":
        info, before, make_outs, after = _flat_input(scene, rays, dev)
    else:
        info, before, make_outs, after = _lazy_input(scene, cam, dev)
    outs = {k: make_outs() for k in fns}
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ptr(a):
        return a.data_ptr() if isinstance(a, torch.Tensor) else int(a)

    def launch(k):
        if args.kernel == "flat":   # the chunks merge into reset buffers
            outs[k][0].fill_(-1)
            outs[k][1].zero_()
        err = fns[k](*map(ptr, before), *map(ptr, outs[k]),
                     *map(ptr, after), stream)
        if err:
            raise RuntimeError(f"{entry} ({k}) failed: cudaError_t {err}")

    order, times = time_in_turns(launch, args.reps, dev)
    equal = all(torch.equal(a, b) for a, b in zip(outs["base"], outs["this"]))
    rays_name = "first-bounce" if args.bounce else "camera"
    print(json.dumps({
        "kernel": entry, **info,
        "rays": rays_name if args.kernel != "lazy" else "lazy pipeline",
        "reps": args.reps, "device": torch.cuda.get_device_name(dev),
        "order": list(order), "ms": times,
        "ptxas_frame_spills_registers": regs,
        "base_ms": (times[0] + times[3]) / 2,
        "this_ms": (times[1] + times[2]) / 2, "outputs_equal": equal,
    }))
    return 0 if equal else 1


if __name__ == "__main__":
    raise SystemExit(main())
