#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`opencl_path_tracer_tpu_torch`).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from `opencl_path_tracer_tpu_torch/csrc/`,
holds each against its plain PyTorch version at 1080p ray counts, renders
the three goldens of `tests/golden/` through the kernels, and drives the
main path (`RenderEngine.render` of the Cornell box and the analytic
Cornell box at 1920x1080, 5 bounces, 8 spp) with the launch counts reset
just before and read just after. The last two lines are a JSON object
per kernel (time, plain time, bound, launches) and the verdict. Any
failed phase raises, and the script exits non-zero without the verdict.
It writes nothing but the kernel build under the package's `_build/`.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
W, H, BOUNCES, SPP = 1920, 1080, 5, 8
# H100 SXM data sheet, dense, at the full 700 W power limit.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
GOLDENS = (  # file, cornell_box kwargs, bounces (tests/test_megakernel.py)
    ("cornell_16x16_i2_s4", dict(with_spheres=False), 2),
    ("cornell_spheres_16x16_i4_s4", dict(with_spheres=True), 4),
    ("cornell_analytic_16x16_i2_s4",
     dict(with_spheres=True, analytic_spheres=True), 2),
)
KERNEL_META = {
    "minarg": ("opencl_path_tracer_tpu_torch/csrc/minarg.cu",
               "opencl_path_tracer_tpu/ops/pallas/intersect_kernel.py:452"),
    "refine1": ("opencl_path_tracer_tpu_torch/csrc/refine1.cu",
                "opencl_path_tracer_tpu/ops/pallas/plucker_kernel.py:695"),
    "spheres": ("opencl_path_tracer_tpu_torch/csrc/spheres.cu",
                "opencl_path_tracer_tpu/ops/pallas/sphere_kernel.py:47"),
}


class SmokeError(RuntimeError):
    pass


def need(cond, msg):
    if not cond:
        raise SmokeError(msg)


def import_port():
    sys.path.insert(0, HERE)
    try:
        import opencl_path_tracer_tpu_torch as pkg
    except ImportError as e:
        raise SmokeError(f"the port is not beside this script: {e}")
    need(os.path.abspath(pkg.__file__).startswith(HERE + os.sep),
         f"imported the port from {pkg.__file__}, not from this checkout")
    return pkg


def device_line(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    from opencl_path_tracer_tpu_torch.ops.kernels import _build
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True).stdout
    rel = re.search(r"release ([\d.]+)", nvcc)
    print(smi)
    print(f"device: {smi}; torch {torch.__version__} (CUDA "
          f"{torch.version.cuda}); nvcc {rel.group(1) if rel else '?'}")
    return smi


def build_line():
    from opencl_path_tracer_tpu_torch.ops.kernels import _build
    _build.build_info.clear()
    for name in _build.KERNELS:
        _build.library(name)
    info = _build.build_info
    parts = []
    for name, rep in info.get("ptxas", {}).items():
        regs = re.search(r"Used (\d+) registers", rep)
        smem = re.search(r"(\d+) bytes smem", rep)
        parts.append(f"{name} {regs.group(1) if regs else '?'} registers "
                     f"{smem.group(1) if smem else 0} B smem")
    print(f"build: {info['seconds']:.1f} s for {len(info['built'])} sources "
          f"(sm_90a, --fmad=false); " + "; ".join(parts))


def bounce_rays(torch, scene, cam, rays, isect):
    """The rays of the first bounce: shade the camera rays' hits once."""
    from opencl_path_tracer_tpu_torch.core.types import Rays
    from opencl_path_tracer_tpu_torch.models import megakernel
    from opencl_path_tracer_tpu_torch.ops import rng
    n = rays.count
    hit, mat = megakernel.fetch_material(scene.mats, isect, rays)
    u = rng.fast_uniforms(rng.key(7), 0, 1, n, 2, device=rays.device)
    inside = torch.zeros(n, dtype=torch.bool, device=rays.device)
    s = megakernel.shade(cam, mat, hit, rays.p, rays.d, inside, u[0], u[1],
                         hit.valid)
    return Rays(p=s["new_p"], d=s["new_d"])


def check_kernels(torch, scenes, cam):
    """Each kernel against its plain version on the camera rays and the
    first-bounce rays of both scenes, with torch.equal."""
    from opencl_path_tracer_tpu_torch.ops import raygen, rng
    from opencl_path_tracer_tpu_torch.ops.kernels import (
        intersect_kernel as k1, plucker_kernel as k2, sphere_kernel as k3)
    from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
    dev = cam.eye.device
    # gen_ray's two parity draws per pixel (prog.cl:384-389).
    s1, r1 = rng.lehmer_step(rng.seed_pixel_streams(W * H, 1, device=dev))
    _, r2 = rng.lehmer_step(s1)
    cam_rays = raygen.camera_rays(cam, raygen.pixel_ids(W, H, dev), r1, r2)
    inputs, errs = {}, {"minarg": 0.0, "refine1": 0.0, "spheres": 0.0}

    def compare(name, outs, plain, where):
        torch.cuda.synchronize()
        for a, b in zip(outs, plain):
            errs[name] = max(errs[name], float((a - b).abs().max()))
        need(all(torch.equal(a, b) for a, b in zip(outs, plain)),
             f"{name} differs from its plain version on {where}")

    for sname, scene in scenes.items():
        pack = k1.build_tri_pack(scene.tris)
        table = (None if scene.spheres is None
                 else k3.build_sphere_table(scene.spheres))
        isect = make_intersect_fn(scene, "auto")
        for rname, rays in (
                ("camera", cam_rays),
                ("bounce", bounce_rays(torch, scene, cam, cam_rays, isect))):
            where = f"{sname} {rname} rays"
            rays8 = k1.pack_rays(rays.p, rays.d).contiguous()
            t, g = k1.minarg(rays8, pack)
            compare("minarg", (t, g), k1.minarg_plain(rays8, pack), where)
            compare("refine1", k2.refine1(t, g, pack),
                    k2.refine1_plain(t, g, pack), where)
            line = (f"{sname:16s} {rname:6s} rays {rays.count}: minarg "
                    f"({int((t < k1.BIG).sum())} hits) and refine1 equal")
            if table is not None:
                so = k3.spheres(rays8, table)
                compare("spheres", so, k3.spheres_plain(rays8, table), where)
                line += f", spheres ({int((so[0] > 0).sum())} hits) equal"
                inputs.setdefault("spheres", (rays8, table))
            print(line + " to their plain versions (torch.equal: exact)")
            if rname == "camera":
                inputs.setdefault("minarg", (rays8, pack))
                inputs.setdefault("refine1", (t, g, pack))
    return inputs, errs


def check_goldens(torch, np):
    from opencl_path_tracer_tpu_torch.models import megakernel
    from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
    from opencl_path_tracer_tpu_torch.scene import library
    for fname, kw, bounces in GOLDENS:
        scene = library.cornell_box(device="cuda", **kw)
        cam = library.cornell_camera(16, 16, device="cuda")
        st = megakernel.render(cam, scene.mats,
                               intersect_fn=make_intersect_fn(scene, "auto"),
                               num_pixels=256, iterations=bounces, spp=4,
                               mode="parity", device="cuda")
        img = megakernel.colors_array(st).cpu().numpy().reshape(-1)
        gold = np.load(os.path.join(HERE, "tests", "golden", fname + ".npy"))
        rel = np.abs(img - gold[3:]) / np.maximum(np.abs(gold[3:]), 1e-30)
        ok = np.allclose(img, gold[3:], rtol=1e-4, atol=1e-6)
        print(f"golden {fname}: max rel {rel.max():.3g} "
              f"(rtol 1e-4, atol 1e-6) {'ok' if ok else 'FAILED'}")
        need(ok, f"golden {fname} does not match through the kernels")


def check_no_fallback(torch, scene):
    """With the kernel loader broken, a CUDA call must raise."""
    from opencl_path_tracer_tpu_torch.ops.kernels import _build
    from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel
    pack = intersect_kernel.build_tri_pack(scene.tris)
    rays8 = torch.zeros((8, 64), device="cuda")
    real = _build.library

    def broken(name):
        raise RuntimeError("kernel loader disabled by chip_smoke")

    _build.library = broken
    try:
        intersect_kernel.minarg(rays8, pack)
    except RuntimeError:
        print("no fallback: with the loader broken, a CUDA call raises")
        return
    finally:
        _build.library = real
    raise SmokeError("minarg ran on CUDA with its kernel loader broken")


def main_path(torch, np, scenes):
    from opencl_path_tracer_tpu_torch.config import CameraConfig, RenderConfig
    from opencl_path_tracer_tpu_torch.ops.kernels import _build
    from opencl_path_tracer_tpu_torch.runtime.engine import RenderEngine
    cfg = RenderConfig(width=W, height=H, iterations=BOUNCES, spp=SPP,
                       camera=CameraConfig(fov=60.0, yaw=0.0, pitch=0.0,
                                           shift=(0.0, 0.0, 0.0)))
    engines = {name: RenderEngine(scene, cfg, device="cuda")
               for name, scene in scenes.items()}
    torch.cuda.synchronize()
    _build.reset_launches()
    per_scene = {}
    for name, eng in engines.items():
        before = dict(_build.launches)
        t0 = time.perf_counter()
        eng.render(SPP)
        dt = time.perf_counter() - t0
        counts = {k: _build.launches[k] - before[k] for k in before}
        per_scene[name] = counts
        img = eng.image()
        need(img.shape == (H, W, 3) and np.isfinite(img).all()
             and img.mean() > 0.0, f"{name}: bad image")
        print(f"main path {name}: {W}x{H}, {BOUNCES} bounces, {SPP} spp in "
              f"{dt:.3f} s: {eng.rays_traced / dt / 1e6:.1f} Mrays/s, "
              f"{SPP / dt:.2f} samples/s; launches {counts}")
    total = dict(_build.launches)
    need(per_scene["cornell"]["minarg"] > 0
         and per_scene["cornell"]["refine1"] > 0,
         "cornell did not launch minarg and refine1")
    need(all(v > 0 for v in per_scene["cornell-analytic"].values()),
         "cornell-analytic did not launch every kernel")
    return total


def time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def minarg_ops(torch, rays8, pack):
    """Float32 operations K1 needs on these inputs: 12 per pair for the
    plane test (two 3-term dots, a subtraction and a divide), 12 more for
    each edge test that is reached (t > 0, then each edge that passed)."""
    c = pack[:, :16, None]
    reached = 0
    r = rays8.shape[1]
    for s in range(0, r, 16384):
        x = rays8[:, s:s + 16384]

        def dot(b, v):
            return c[:, b] * v[0] + c[:, b + 1] * v[1] + c[:, b + 2] * v[2]

        p, d = (x[0:1], x[1:2], x[2:3]), (x[3:4], x[4:5], x[5:6])
        t = (c[:, 3] - dot(0, p)) / dot(0, d)
        ok = t > 0.0
        for b in (4, 8, 12):
            reached += int(ok.sum())
            ok = ok & (dot(b, p) + t * dot(b, d) >= c[:, b + 3])
    return 12 * r * pack.shape[0] + 12 * reached


def measure(torch, inputs, errs, launches):
    from opencl_path_tracer_tpu_torch.ops.kernels import (
        intersect_kernel as k1, plucker_kernel as k2, sphere_kernel as k3)
    rows = []
    rays8, pack = inputs["minarg"]
    r, t = rays8.shape[1], pack.shape[0]
    ops = minarg_ops(torch, rays8, pack)
    rows.append(("minarg", lambda: k1.minarg(rays8, pack),
                 lambda: k1.minarg_plain(rays8, pack),
                 ops, 24 * r + 64 * t + 8 * r))
    t1, g1, pack2 = inputs["refine1"]
    rows.append(("refine1", lambda: k2.refine1(t1, g1, pack2),
                 lambda: k2.refine1_plain(t1, g1, pack2),
                 0, 8 * r + 96 * t + 20 * r))
    rays8s, table = inputs["spheres"]
    rs, s = rays8s.shape[1], table.shape[0]
    hits = int((k3.spheres_plain(rays8s, table)[0] > 0).sum())
    rows.append(("spheres", lambda: k3.spheres(rays8s, table),
                 lambda: k3.spheres_plain(rays8s, table),
                 10 * rs + 19 * rs * s + 12 * hits,
                 24 * rs + 32 * s + 20 * rs))
    out = []
    for name, kern, plain, ops, nbytes in rows:
        ms = time_ms(torch, kern, 20)
        plain_ms = time_ms(torch, plain, 2)
        t_ops = ops / PEAK_FP32_FLOPS * 1e3
        t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
        src, repl = KERNEL_META[name]
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": launches[name], "max_abs_err": errs[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
        })
        print(f"{name}: {ms:.4f} ms (plain {plain_ms:.2f} ms), bound "
              f"{max(t_ops, t_bytes):.4f} ms by "
              f"{out[-1]['bound_by']}, {launches[name]} main-path launches")
    return out


def main() -> int:
    import numpy as np
    import torch
    need(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    import_port()
    from opencl_path_tracer_tpu_torch.scene import library
    device_line(torch)
    build_line()
    scenes = {
        "cornell": library.cornell_box(with_spheres=True, device="cuda"),
        "cornell-analytic": library.cornell_box(
            with_spheres=True, analytic_spheres=True, device="cuda"),
    }
    cam = library.cornell_camera(W, H, device="cuda")
    inputs, errs = check_kernels(torch, scenes, cam)
    check_goldens(torch, np)
    check_no_fallback(torch, scenes["cornell"])
    launches = main_path(torch, np, scenes)
    kernels = measure(torch, inputs, errs, launches)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
