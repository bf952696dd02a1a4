"""Where a sample's (or a step's) time goes on the card.

No counterpart module in `opencl_path_tracer_tpu` (its profiling helper,
`utils/profiling.py`, wraps `jax.profiler`). Runs one of the port's three
render paths on one of `ptx-torch render`'s scenes, with its camera
preset, under `torch.profiler` and prints one
JSON line: wall time, device busy time and the busy share, device
launches, the kernels that take the most device time, per sample and
per step, and every hand-written kernel's time and launches per sample.
Needs a GPU:

    python -m opencl_path_tracer_tpu_torch.runtime.profile --scene cornell
    python -m opencl_path_tracer_tpu_torch.runtime.profile --model wavefront \\
        --scene cornell-analytic
    python -m opencl_path_tracer_tpu_torch.runtime.profile --model fused
    python -m opencl_path_tracer_tpu_torch.runtime.profile --nee
    python -m opencl_path_tracer_tpu_torch.runtime.profile --model wavefront \
        --scene many-lights --nee --nee-select distance
    python -m opencl_path_tracer_tpu_torch.runtime.profile --accel tilecull
    python -m opencl_path_tracer_tpu_torch.runtime.profile --scene reference \\
        --models-dir tests/assets/models --smooth
    python -m opencl_path_tracer_tpu_torch.runtime.profile --scene stress
    python -m opencl_path_tracer_tpu_torch.runtime.profile --scene stress \\
        --model wavefront
    python -m opencl_path_tracer_tpu_torch.runtime.profile --scene stress \\
        --accel pair
    python -m opencl_path_tracer_tpu_torch.runtime.profile --scene stress \\
        --accel cluster --spp 1
    python -m opencl_path_tracer_tpu_torch.runtime.profile --scene reference \\
        --models-dir tests/assets/models --accel group
    python -m opencl_path_tracer_tpu_torch.runtime.profile --scene stress \\
        --accel march
    python -m opencl_path_tracer_tpu_torch.runtime.profile --scene stress \\
        --accel flat
    python -m opencl_path_tracer_tpu_torch.runtime.profile --scene stress \\
        --model lazy
    python -m opencl_path_tracer_tpu_torch.runtime.profile \\
        --intersect minarg-fused
    python -m opencl_path_tracer_tpu_torch.runtime.profile --intersect mxu
    python -m opencl_path_tracer_tpu_torch.runtime.profile --envmap sunsky
    python -m opencl_path_tracer_tpu_torch.runtime.profile --dof 20 600
    python -m opencl_path_tracer_tpu_torch.runtime.profile \
        --scene textured-room --textured --nee
    python -m opencl_path_tracer_tpu_torch.runtime.profile \
        --scene textured-grid --textured
    python -m opencl_path_tracer_tpu_torch.runtime.profile --denoise
    python -m opencl_path_tracer_tpu_torch.runtime.profile --model wavefront \
        --scene cornell-analytic --nee --dispersion 30 --bands 3
    python -m opencl_path_tracer_tpu_torch.runtime.profile --sphere-res 26 50
    python -m opencl_path_tracer_tpu_torch.runtime.profile --scene stress \
        --accel pairmx
    python -m opencl_path_tracer_tpu_torch.runtime.profile --accel bvh \
        --accel-force --spp 1
    python -m opencl_path_tracer_tpu_torch.runtime.profile --accel median \
        --accel-force --spp 1

--model megakernel and wavefront render --spp samples through
`RenderEngine` (with --nee, --nee-select, --accel, --smooth,
--models-dir, --dof, --env, --envmap, --env-scale, --no-env-nee and
--accel-force as `ptx-torch render` takes them; `--scene stress`, 99,380
triangles, runs the pair intersector through 'auto'; --intersect
minarg-fused or mxu passes the intersector that no accel names, K14
through `make_minarg_intersect(fuse_fetch=True)` or K15 through
`make_mxu_intersect`, as `chip_smoke.py` injects it); fused runs --steps
steps of `models.pipeline`'s fast pipeline (triangles only: --scene
cornell); lazy runs --steps steps of `models.lazy`'s pipeline as
`bench.py --model lazy` builds it (cs 512, tr 256, K 4, tail 4096, fast
mode, key 1) after two warm-up steps, its samples the per-pixel samples
those steps finished. `--scene textured-room` (with ROOM_SPHERE) and
`textured-grid` are `scene.library.textured_room`'s scenes, written to a
temporary directory and seen from the Cornell preset, as `chip_smoke.py`
renders them; --textured samples their maps. --denoise profiles one
`RenderEngine.denoised_image` call (the guides' primary rays and the
filter) after the render, per call in place of per sample.
--dispersion V_D (--model wavefront, with --bands) profiles
`models.spectral.render_dispersive` as `ptx-torch render --dispersion`
runs it, --spp samples per band. --sphere-res LAT LON tessellates the
Cornell box's spheres finer (26 50: 5,012 triangles, the dense anchor of
the auto accel's threshold). The JSON line's `accel_resolved` is the
accel the render's intersector resolved to ('auto' on CUDA is the
camera predictor's pick).
"""

from __future__ import annotations

import argparse
import collections
import json
import time

import torch


def _workload(args, dev):
    """(run(), samples, steps): run() does the profiled unit of work,
    returning the samples per pixel and the steps it took."""
    from opencl_path_tracer_tpu_torch.cli import _build_scene, _camera_preset
    from opencl_path_tracer_tpu_torch.config import RenderConfig
    from opencl_path_tracer_tpu_torch.ops import rng
    from opencl_path_tracer_tpu_torch.ops.kernels.intersect_kernel import (
        make_mxu_intersect)
    from opencl_path_tracer_tpu_torch.ops.kernels.plucker_kernel import (
        make_minarg_intersect)
    from opencl_path_tracer_tpu_torch.runtime.engine import RenderEngine

    w, h = (int(x) for x in args.size.split("x"))
    if args.scene in ("textured-room", "textured-grid"):
        import tempfile
        from opencl_path_tracer_tpu_torch.scene import library
        with tempfile.TemporaryDirectory() as tmp:
            scene = library.textured_room(
                tmp, grid=args.scene == "textured-grid",
                sphere=args.scene == "textured-room", device=dev)
        camera = _camera_preset("cornell", args)
    elif args.sphere_res:
        from opencl_path_tracer_tpu_torch.scene import library
        if args.scene != "cornell":
            raise SystemExit("--sphere-res takes --scene cornell")
        scene = library.cornell_box(with_spheres=True,
                                    sphere_res=tuple(args.sphere_res),
                                    smooth_spheres=args.smooth, device=dev)
        camera = _camera_preset(args.scene, args)
    else:
        scene = _build_scene(args.scene, dev, args.models_dir, args.smooth)
        camera = _camera_preset(args.scene, args)
    if args.model in ("megakernel", "wavefront"):
        cfg = RenderConfig(width=w, height=h, iterations=args.iters,
                           mode=args.mode, model=args.model, camera=camera,
                           accel=args.accel, accel_force=args.accel_force,
                           nee=args.nee,
                           nee_select=args.nee_select, smooth=args.smooth,
                           textured=args.textured,
                           dof_aperture=args.dof[0] if args.dof else 0.0,
                           dof_focus=args.dof[1] if args.dof else 0.0,
                           env_light=args.env, env_map=args.envmap,
                           env_scale=args.env_scale,
                           env_nee=not args.no_env_nee)
        if args.dispersion is not None:
            return _dispersive_workload(args, scene, cfg, dev)
        isect = None
        if args.intersect == "minarg-fused":
            isect = make_minarg_intersect(scene.tris, fuse_fetch=True)
        elif args.intersect == "mxu":
            isect = make_mxu_intersect(scene.tris)
        eng = RenderEngine(scene, cfg, intersect_fn=isect, device=dev)
        args.accel_resolved = getattr(eng.intersect_fn, "accel", None)
        # warm-up: kernel build, allocator, first launches
        eng.render(1, progress=False)
        if args.denoise:
            eng.denoised_image()

            def run():
                eng.denoised_image()
                return 1, None
            return run

        def run():
            steps0 = eng.steps_run
            eng.render(args.spp, progress=False)
            return args.spp, (eng.steps_run - steps0
                              if args.model == "wavefront" else None)
        return run

    if args.model == "lazy":
        return _lazy_workload(args, scene, w, h, dev)
    from opencl_path_tracer_tpu_torch.models import pipeline
    from opencl_path_tracer_tpu_torch.scene import library
    camera = library.cornell_camera(w, h, device=dev)
    state, step, _ = pipeline.make_fast_pipeline(
        scene, camera, width=w, height=h, iterations=args.iters,
        key=rng.key(1))
    box = [state]
    for _ in range(2):  # warm-up
        box[0] = step(*box[0])

    def run():
        F, I, ctr = box[0]
        s0 = int(I[0].sum())
        for _ in range(args.steps):
            F, I, ctr = step(F, I, ctr)
        box[0] = (F, I, ctr)
        return (int(I[0].sum()) - s0) / (w * h), args.steps
    return run


def _dispersive_workload(args, scene, cfg, dev):
    """`render_dispersive` at --spp samples a band, built as `ptx-torch
    render --dispersion` builds it."""
    from opencl_path_tracer_tpu_torch.cli import _spectral_nee
    from opencl_path_tracer_tpu_torch.models import spectral
    from opencl_path_tracer_tpu_torch.runtime.controller import (
        CameraController,
    )
    from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
    if cfg.model != "wavefront":
        raise SystemExit("--dispersion needs --model wavefront")
    cam = CameraController(cfg, device=dev).camera(cfg.width, cfg.height)
    isect = make_intersect_fn(scene, cfg.accel, smooth=cfg.smooth,
                              textured=cfg.textured, cam=cam,
                              iterations=cfg.iterations,
                              force=cfg.accel_force)
    args.accel_resolved = isect.accel
    nee_tab, occ = _spectral_nee(cfg, scene)

    def render(spp):
        spectral.render_dispersive(
            cam, scene.mats, intersect_fn=isect,
            num_pixels=cfg.width * cfg.height, iterations=cfg.iterations,
            min_spp=spp, bands=args.bands, v_d=args.dispersion,
            mode=cfg.mode, nee=nee_tab, occluded_fn=occ)

    render(1)   # warm-up

    def run():
        render(args.spp)
        return args.spp, None
    return run


def _lazy_workload(args, scene, w, h, dev):
    from opencl_path_tracer_tpu_torch.cli import _camera_preset
    from opencl_path_tracer_tpu_torch.core.camera import make_camera
    from opencl_path_tracer_tpu_torch.models import lazy
    from opencl_path_tracer_tpu_torch.ops import rng
    c = _camera_preset(args.scene, args)
    cam = make_camera(w, h, fov=c.fov, yaw=c.yaw, pitch=c.pitch,
                      shift=c.shift, device=dev)
    key = rng.key(1)
    step, init, _ = lazy.make_lazy_pipeline(scene.tris, cs=512, tr=256, K=4,
                                            tail=4096, device=dev)
    box = [init(cam, w * h, mode="fast", key=key)]
    for _ in range(2):  # warm-up
        box[0] = step(cam, scene.mats, box[0], iterations=args.iters,
                      mode="fast", key=key)

    def run():
        st = box[0]
        s0 = int(st.samples.sum())
        for _ in range(args.steps):
            st = step(cam, scene.mats, st, iterations=args.iters,
                      mode="fast", key=key)
        box[0] = st
        return (int(st.samples.sum()) - s0) / (w * h), args.steps
    return run


def main(argv=None) -> int:
    from opencl_path_tracer_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="megakernel",
                    choices=("megakernel", "wavefront", "fused", "lazy"))
    ap.add_argument("--scene", default="cornell")
    ap.add_argument("--size", default="1920x1080")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--spp", type=int, default=2,
                    help="samples per profiled run (megakernel, wavefront)")
    ap.add_argument("--steps", type=int, default=16,
                    help="steps per profiled run (fused, lazy)")
    ap.add_argument("--mode", default="fast")
    ap.add_argument("--accel", default="auto")
    ap.add_argument("--accel-force", action="store_true",
                    help="run bvh or median on the card (refused without "
                         "it)")
    ap.add_argument("--nee", action="store_true",
                    help="next-event estimation (shadow rays through K7)")
    ap.add_argument("--nee-select", default="power",
                    choices=("power", "distance"))
    ap.add_argument("--smooth", action="store_true",
                    help="smooth shading (interpolated vertex normals)")
    ap.add_argument("--models-dir", default=None,
                    help="the reference scene's OBJ models")
    ap.add_argument("--dof", type=float, nargs=2, default=None,
                    metavar=("APERTURE", "FOCUS"),
                    help="thin-lens depth of field")
    ap.add_argument("--env", action="store_true",
                    help="the dormant sky light (EnvLight)")
    ap.add_argument("--envmap", default=None,
                    help="environment map: gradient, sunsky or a path")
    ap.add_argument("--env-scale", type=float, default=1.0)
    ap.add_argument("--no-env-nee", action="store_true",
                    help="--envmap without its gather and escape rays")
    ap.add_argument("--textured", action="store_true",
                    help="image textures (the textured-* scenes' maps)")
    ap.add_argument("--denoise", action="store_true",
                    help="profile one denoised_image call after the render")
    ap.add_argument("--intersect", default=None,
                    choices=("minarg-fused", "mxu"),
                    help="megakernel and wavefront: an intersector that no "
                    "accel names (K14 or K15) in place of --accel's")
    ap.add_argument("--dispersion", type=float, default=None,
                    metavar="V_D",
                    help="wavefront: the spectral path at this Abbe number")
    ap.add_argument("--bands", type=int, default=3,
                    help="bands of --dispersion")
    ap.add_argument("--sphere-res", type=int, nargs=2, default=None,
                    metavar=("LAT", "LON"),
                    help="cornell: the spheres' tessellation (default 12 "
                         "18)")
    args = ap.parse_args(argv)
    args.accel_resolved = None
    dev = resolve_device("cuda")
    run = _workload(args, dev)
    # The profiler slows the host; the busy share divides the profiled
    # device time by the wall time of an unprofiled run of equal length.
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize(dev)
    wall_plain = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        samples, steps = run()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    busy_us, launches = 0.0, 0
    by_name: dict[str, float] = collections.Counter()
    count: dict[str, int] = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            busy_us += us
            launches += 1
            by_name[e.name] += us
            count[e.name] += 1

    def per(x, n):
        return x / n if n else None

    top = [{"name": n[:80], "ms_per_sample": per(us / 1e3, samples),
            "ms_per_step": per(us / 1e3, steps)}
           for n, us in by_name.most_common(8)]
    # The port's own kernels (csrc/, in anonymous namespaces), however
    # small.
    port = [{"name": n[:80], "ms_per_sample": per(us / 1e3, samples),
             "launches_per_sample": per(count[n], samples)}
            for n, us in by_name.most_common()
            if n.startswith(("(anonymous namespace)::",
                             "void (anonymous namespace)::"))]
    print(json.dumps({
        "model": args.model, "scene": args.scene, "size": args.size,
        "bounces": args.iters, "mode": args.mode, "accel": args.accel,
        "nee": args.nee, "nee_select": args.nee_select,
        "smooth": args.smooth, "intersect": args.intersect,
        "dof": args.dof, "env": args.env, "envmap": args.envmap,
        "textured": args.textured, "denoise": args.denoise,
        "env_nee": not args.no_env_nee, "accel_resolved": args.accel_resolved,
        "dispersion": args.dispersion,
        "bands": args.bands if args.dispersion is not None else None,
        "sphere_res": args.sphere_res,
        "samples_per_pixel": samples, "steps": steps,
        "device": torch.cuda.get_device_name(dev),
        "wall_ms_per_sample": per(wall_plain * 1e3, samples),
        "wall_ms_per_step": per(wall_plain * 1e3, steps),
        "profiled_wall_ms_per_sample": per(wall * 1e3, samples),
        "device_busy_ms_per_sample": (per(busy_us / 1e3, samples)
                                      if launches else None),
        "device_busy_ms_per_step": (per(busy_us / 1e3, steps)
                                    if launches else None),
        "busy_share": (busy_us / 1e6 / wall_plain if launches else None),
        "device_launches_per_sample": per(launches, samples),
        "device_launches_per_step": per(launches, steps),
        "top_kernels": top, "port_kernels": port,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
