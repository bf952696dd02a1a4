"""K1 (minarg) built from two source trees and timed in one process.

No counterpart in `opencl_path_tracer_tpu`. Compares the K1 kernel of
this checkout with the K1 kernel of another checkout's `csrc/` (its C
interface must be the same), on the 1080p camera rays of the Cornell box
with its 804 triangles, the inputs `chip_smoke.py` times K1 on, or with
`--scene reference` on the reference scene's (1,838 triangles), and with
`--bounce` on the first-bounce rays instead (the camera rays' hits
shaded once, as `chip_smoke.py` makes them: incoherent rays). Both
builds use `_build`'s nvcc flags, run as base, this, this, base (each the
mean of --reps launches timed with CUDA events), must give equal outputs,
and one JSON line reports the four times. Needs a GPU:

    python -m opencl_path_tracer_tpu_torch.runtime.minarg_ab --base DIR

where DIR is, for example, the `opencl_path_tracer_tpu_torch/csrc` of a
`git archive` of the parent commit unpacked in a gitignored directory.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess

import torch


def _compile(csrc: pathlib.Path, out: pathlib.Path, src: str = "minarg.cu"):
    from opencl_path_tracer_tpu_torch.ops.kernels import _build
    return subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
         str(out), str(csrc / src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def time_in_turns(launch, reps: int, dev):
    """Time launch("base") and launch("this") as base, this, this, base,
    each the mean of `reps` launches after one more, with CUDA events.
    Returns (the order, the four times in ms)."""
    def time_ms(k):
        launch(k)
        torch.cuda.synchronize(dev)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            launch(k)
        e1.record()
        torch.cuda.synchronize(dev)
        return e0.elapsed_time(e1) / reps

    order = ("base", "this", "this", "base")
    return order, [time_ms(k) for k in order]


def _bounce(scene, cam, rays):
    """The first-bounce rays: the camera rays' hits shaded once."""
    from opencl_path_tracer_tpu_torch.core.types import Rays
    from opencl_path_tracer_tpu_torch.models import megakernel
    from opencl_path_tracer_tpu_torch.ops import rng
    from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
    n = rays.count
    hit, mat = megakernel.fetch_material(
        scene.mats, make_intersect_fn(scene, "auto"), rays)
    u = rng.fast_uniforms(rng.key(7), 0, 1, n, 2, device=rays.device)
    inside = torch.zeros(n, dtype=torch.bool, device=rays.device)
    s = megakernel.shade(cam, mat, hit, rays.p, rays.d, inside, u[0], u[1],
                         hit.valid)
    return Rays(p=s["new_p"], d=s["new_d"])


def main(argv=None) -> int:
    from opencl_path_tracer_tpu_torch.ops import raygen, rng
    from opencl_path_tracer_tpu_torch.ops.kernels import _build
    from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
    from opencl_path_tracer_tpu_torch.scene import library
    from opencl_path_tracer_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True, type=pathlib.Path,
                    help="the csrc/ directory of the checkout to compare")
    ap.add_argument("--scene", choices=("cornell", "reference"),
                    default="cornell",
                    help="the scene whose 1080p camera rays and triangles "
                    "K1 is timed on (reference: tests/assets/models)")
    ap.add_argument("--bounce", action="store_true",
                    help="time on the first-bounce rays (the camera rays' "
                    "hits shaded once) instead of the camera rays")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = {"base": args.base.resolve(), "this": _build.CSRC}
    procs = {k: _compile(d, out_dir / f"libminarg_{k}.so")
             for k, d in srcs.items()}
    fns, regs = {}, {}
    for k, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {k}:\n{log}")
        fn = ctypes.CDLL(str(out_dir / f"libminarg_{k}.so")).ptx_minarg
        fn.argtypes = _build.KERNELS["minarg"][2]
        fn.restype = ctypes.c_int
        fns[k] = fn
        regs[k] = [int(x) for x in re.findall(r"Used (\d+) registers", log)]

    w, h = 1920, 1080
    if args.scene == "cornell":
        scene = library.cornell_box(with_spheres=True, device=dev)
        cam = library.cornell_camera(w, h, device=dev)
    else:
        models = pathlib.Path(__file__).resolve().parents[2] / "tests" / (
            "assets/models")
        scene = library.reference_scene(str(models), smooth=True, device=dev)
        cam = library.reference_camera(w, h, device=dev)
    s1, r1 = rng.lehmer_step(rng.seed_pixel_streams(w * h, 1, device=dev))
    _, r2 = rng.lehmer_step(s1)
    rays = raygen.camera_rays(cam, raygen.pixel_ids(w, h, dev), r1, r2)
    if args.bounce:
        rays = _bounce(scene, cam, rays)
    rays8 = k1.pack_rays(rays.p, rays.d).contiguous()
    pack = k1.build_tri_pack(scene.tris)
    n = rays8.shape[1]
    outs = {k: (torch.empty(n, device=dev), torch.empty(n, device=dev))
            for k in fns}
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(k):
        t, g = outs[k]
        err = fns[k](rays8.data_ptr(), pack.data_ptr(), t.data_ptr(),
                     g.data_ptr(), n, pack.shape[0], stream)
        if err:
            raise RuntimeError(f"minarg ({k}) failed: cudaError_t {err}")

    order, times = time_in_turns(launch, args.reps, dev)
    equal = all(torch.equal(a, b) for a, b in zip(outs["base"], outs["this"]))
    print(json.dumps({
        "kernel": "minarg", "scene": args.scene,
        "rays_kind": "bounce" if args.bounce else "camera",
        "rays": n, "triangles": pack.shape[0],
        "reps": args.reps, "device": torch.cuda.get_device_name(dev),
        "order": list(order), "ms": times, "registers": regs,
        "base_ms": (times[0] + times[3]) / 2,
        "this_ms": (times[1] + times[2]) / 2, "outputs_equal": equal,
    }))
    return 0 if equal else 1


if __name__ == "__main__":
    raise SystemExit(main())
