"""`ptx-torch` command-line interface.

Port of `opencl_path_tracer_tpu/cli.py` but `bench`: `render`, an
offline progressive render to PNG, or to linear HDR when `--out` ends in
`.pfm` or `.npy`, with the 1 Hz meter on stderr; `view`, the interactive
loop without a window (the last frame to PNG); `anim`, a turntable to
PNG frames and a looping GIF (`runtime/anim.py`); `serve`, the live
browser viewer (`runtime/viewer.py`); and `info`, the device table.
render, view, anim and serve share their scene, camera and light flags
(`_common`). Every command runs on the GPU unless `--device cpu` is
given. Checkpoints (`--checkpoint`, `--resume`, `--autosave-every`)
are the JAX package's files: either CLI resumes the other's. `--median`
(the reference's dormant 3x3 median filter and filmic tonemap, to PNG)
and `--denoise` (the à-trous denoiser; to PNG, or in linear light to
`.pfm`/`.npy`) are exclusive. `--dispersion V_D [--bands B]` renders
glass whose index follows the Abbe number V_D, one wavefront render per
band (`models/spectral.py`; `_render_dispersive`). `render --devices N`
shards the render over N ranks (`parallel/launch.py`: one process a
rank, NCCL on N GPUs, or gloo ranks with `--device cpu`; 0 is every
visible GPU): every rank runs `cmd_render` on its slice, and rank 0
prints the lines and writes the files.

    ptx-torch render --scene cornell --size 1920x1080 --iters 5 --spp 8
    ptx-torch render --scene cornell-analytic --model wavefront --rr 3
    ptx-torch render --scene cornell --nee
    ptx-torch render --scene many-lights --nee --nee-select distance
    ptx-torch render --scene reference --models-dir tests/assets/models \
        --smooth
    ptx-torch render --scene model.obj --smooth
    ptx-torch render --scene room.obj --textured --denoise   # MTL map_Kd
    ptx-torch render --spp 4 --median
    ptx-torch render --scene stress          # 99,380 triangles: 'pairwin'
    ptx-torch render --scene stress --smooth
    ptx-torch render --scene stress-analytic
    ptx-torch render --scene stress --accel pairmx   # K10's full payload
    ptx-torch render --accel bvh --accel-force       # or median; plain walkers
    ptx-torch render --spp 4 --checkpoint run.npz --autosave-every 2
    ptx-torch render --spp 4 --resume run.npz --out hdr.pfm
    ptx-torch render --model wavefront --nee --adaptive 0.05 --min-spp 8
    ptx-torch render --envmap sunsky        # or gradient, or a .pfm path
    ptx-torch render --scene cornell-analytic --env
    ptx-torch render --dof 20 600           # lens radius, focal distance
    ptx-torch render --scene cornell-analytic --model wavefront \
        --dispersion 30 --bands 5 --nee      # flint glass, five bands
    ptx-torch render --config render.json   # a RenderConfig as JSON
    ptx-torch render --devices 0            # tiled over every GPU
    ptx-torch render --devices 2 --device cpu --mode parity  # gloo ranks
    ptx-torch info                          # the CUDA devices
    ptx-torch view --frames 30 --out view.png
    ptx-torch anim --frames 36 --spp 16 --out-dir frames --gif turn.gif
    ptx-torch anim --scene cornell-analytic --dispersion 30 --nee
    ptx-torch serve --port 8642             # then open the URL
"""

from __future__ import annotations

import argparse
import sys
import time


SCENES = ("cornell", "cornell-analytic", "cornell-empty",
          "cornell-sphere-lamp", "many-lights", "many-lights-N", "reference", "reference-analytic",
          "stress", "stress-analytic", "*.obj")


def _build_scene(name: str, device, models_dir: str | None = None,
                 smooth: bool = False):
    from opencl_path_tracer_tpu_torch.scene import library
    if name == "cornell":
        return library.cornell_box(with_spheres=True,
                                   smooth_spheres=smooth, device=device)
    if name == "cornell-analytic":
        # 12 box triangles + 2 exact quadrics.
        return library.cornell_box(with_spheres=True, analytic_spheres=True,
                                   device=device)
    if name == "cornell-empty":
        return library.cornell_box(with_spheres=False, device=device)
    if name == "cornell-sphere-lamp":
        # An emissive analytic sphere as the lamp (NEE's cone sampler).
        return library.cornell_box(with_spheres=True, analytic_spheres=True,
                                   sphere_lamp=True, device=device)
    if name == "many-lights" or name.startswith("many-lights-"):
        # The walls, two receivers and N small lamps (64 by default): the
        # scene of --nee --nee-select distance.
        count = (64 if name == "many-lights"
                 else int(name[len("many-lights-"):]))
        return library.many_light_scene(count, device=device)
    if name == "reference":
        return library.reference_scene(models_dir, smooth=smooth,
                                       device=device)
    if name == "reference-analytic":
        # The lamp and gold-ball sphere models as exact quadrics, the
        # other models as meshes.
        return library.reference_scene(models_dir, smooth=smooth,
                                       analytic=True, device=device)
    if name == "stress":
        # BASELINE config 4: 99,380 triangles ('auto' -> 'pairwin').
        return library.stress_scene(100_000, smooth=smooth, device=device)
    if name == "stress-analytic":
        # The same scene with its 138 spheres as exact quadrics.
        if smooth:
            raise SystemExit("--smooth is pointless here: quadric normals "
                             "are exact already")
        return library.stress_scene(100_000, analytic=True, device=device)
    if name.endswith(".obj"):
        from opencl_path_tracer_tpu_torch.scene.builder import SceneBuilder
        b = SceneBuilder()
        b.add_obj(name, pos=(0, 0, 0), scale=(1, 1, 1),
                  smooth_normals=smooth)
        return b.build(device=device)
    raise SystemExit(f"unknown scene {name!r} (the port has "
                     f"{', '.join(SCENES)})")


def _camera_preset(scene_name: str, args):
    """The Cornell preset (fov 60, no yaw, pitch or shift) for the Cornell,
    many-light and stress scenes, the reference's live camera (the
    config's default) for the others (the JAX package's CLI gives
    'stress-analytic' the default camera too); --fov, --yaw and --pitch
    override."""
    from opencl_path_tracer_tpu_torch.config import CameraConfig
    if (scene_name.startswith("cornell") or scene_name == "stress"
            or scene_name.startswith("many-lights")):
        cam = CameraConfig(fov=60.0, yaw=0.0, pitch=0.0,
                           shift=(0.0, 0.0, 0.0))
    else:
        cam = CameraConfig()
    for field in ("fov", "yaw", "pitch"):
        if getattr(args, field, None) is not None:
            setattr(cam, field, getattr(args, field))
    return cam


def _config(args, **kw):
    """The RenderConfig of the shared flags (`_common`); kw: the
    command's own fields. Every command passes --seed (the JAX package's
    view and serve drop it: ROADMAP.md queue 3)."""
    from opencl_path_tracer_tpu_torch.config import RenderConfig
    w, h = (int(x) for x in args.size.split("x"))
    return RenderConfig(width=w, height=h, iterations=args.iters,
                        mode=args.mode, seed=args.seed, accel=args.accel,
                        accel_force=args.accel_force, qmc=args.qmc,
                        nee=args.nee, nee_select=args.nee_select,
                        nee_anyhit=not args.no_nee_anyhit,
                        smooth=args.smooth, textured=args.textured,
                        dof_aperture=args.dof[0] if args.dof else 0.0,
                        dof_focus=args.dof[1] if args.dof else 0.0,
                        env_light=args.env, env_sky=tuple(args.env_sky),
                        env_deep=tuple(args.env_deep),
                        env_map=args.envmap, env_scale=args.env_scale,
                        env_nee=not args.no_env_nee,
                        camera=_camera_preset(args.scene, args), **kw)


def _rank0() -> bool:
    """Whether this process prints and writes: rank 0 of a world, or the
    one process outside one."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _say(msg: str) -> None:
    if _rank0():
        print(msg, file=sys.stderr)


def _render_over_ranks(args, cfg, device) -> int:
    """`render` with devices != 1 outside a world: cmd_render on that
    many ranks (`parallel.launch.launch`; 0: every visible GPU), which
    render over the mesh; rank 0's exit code. A rank's failure raises."""
    import torch
    from opencl_path_tracer_tpu_torch.parallel.launch import launch
    if args.dispersion is not None:
        raise SystemExit("--dispersion does not compose with --devices")
    ranks = cfg.devices
    if ranks == 0:
        if device.type != "cuda":
            raise SystemExit("--devices 0 is every visible GPU; with "
                             "--device cpu give the number of ranks")
        ranks = torch.cuda.device_count()
    return launch(cmd_render, ranks, (args,), device=device.type)[0]


def cmd_render(args) -> int:
    import torch.distributed as dist
    from opencl_path_tracer_tpu_torch.config import RenderConfig
    from opencl_path_tracer_tpu_torch.runtime.engine import RenderEngine
    from opencl_path_tracer_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if args.config:
        # The JSON config overrides the other render flags.
        with open(args.config) as fh:
            cfg = RenderConfig.from_json(fh.read())
    else:
        cfg = _config(args, spp=args.spp, tonemap=args.tonemap,
                      model=args.model, rr_start=args.rr,
                      devices=args.devices)
    if args.median and args.denoise:
        raise SystemExit("--median and --denoise are exclusive filters; "
                         "pick one")
    tol = None
    if args.adaptive is not None:
        if cfg.model != "wavefront":
            raise SystemExit("--adaptive needs --model wavefront "
                             "(per-pixel sample counts)")
        if args.adaptive == "auto":
            tol = args.adaptive_tol
        else:
            try:
                tol = float(args.adaptive)
            except ValueError:
                raise SystemExit(f"--adaptive takes a tolerance or 'auto', "
                                 f"got {args.adaptive!r}") from None
    if cfg.devices != 1 and not dist.is_initialized():
        cfg.validate()
        return _render_over_ranks(args, cfg, device)
    scene = _build_scene(args.scene, device, args.models_dir, cfg.smooth)
    if args.dispersion is not None:
        return _render_dispersive(args, cfg, scene, device)
    eng = RenderEngine(scene, cfg, device=device)
    if args.resume:
        eng.load(args.resume)
        at = (eng._sample_host if cfg.model == "wavefront"
              else eng.state.sample)
        _say(f"resumed at sample {at}")
    t0 = time.perf_counter()
    if args.adaptive == "auto":
        decision, speedup, zero_var = eng.render_adaptive_auto(
            max_spp=cfg.spp, tol=tol, min_spp=args.min_spp)
        _say(f"adaptive auto -> {decision} (predicted speedup "
             f"x{speedup:.2f}, zero-variance frac {zero_var:.2f}, "
             f"tol {tol})")
    elif tol is not None:
        eng.render_adaptive(tol, max_spp=cfg.spp, min_spp=args.min_spp)
    else:
        eng.render(cfg.spp, autosave_every=args.autosave_every,
                   autosave_path=args.checkpoint)
    dt = time.perf_counter() - t0
    where = device if eng.mesh is None else f"{eng.mesh.size()} x {device}"
    if tol is not None:
        smp = eng.state.samples
        if eng.mesh is not None:
            from opencl_path_tracer_tpu_torch.parallel.shard import (
                all_gather_lanes,
            )
            smp = all_gather_lanes(smp, eng.mesh)
        smp = smp.cpu().numpy()
        _say(f"\nadaptive: spp min {int(smp.min())} / mean {smp.mean():.1f} "
             f"/ max {int(smp.max())} (cap {cfg.spp}, tol {tol}) in "
             f"{dt:.2f}s ({eng.rays_traced / dt / 1e6:.1f} Mrays/s on "
             f"{where})")
    else:
        _say(f"\n{cfg.spp} spp in {dt:.2f}s ({cfg.spp / dt:.2f} samples/s, "
             f"{eng.rays_traced / dt / 1e6:.1f} Mrays/s on {where})")
    _write_outputs(args, eng, device)
    _say(f"wrote {args.out}")
    if args.checkpoint:
        eng.save(args.checkpoint)
        _say(f"wrote {args.checkpoint}")
    return 0


def _write_outputs(args, eng, device) -> None:
    """--out: the median-filtered PNG, linear radiance (.pfm/.npy,
    denoised with --denoise), the denoised PNG or the PNG. The image is
    every rank's call over a mesh; rank 0 writes it."""
    if args.median:
        import torch
        from opencl_path_tracer_tpu_torch.io.image import write_png
        from opencl_path_tracer_tpu_torch.ops.median_filter import median3x3
        img = torch.as_tensor(eng.image(apply_tonemap=False).copy(),
                              device=device)
        img = median3x3(img).cpu().numpy()
        if _rank0():
            write_png(args.out, img)
    elif args.out.endswith((".pfm", ".npy")):
        # Linear radiance, untonemapped (denoised in linear light with
        # --denoise).
        if args.denoise:
            import numpy as np
            from opencl_path_tracer_tpu_torch.io.image import write_pfm
            img = eng.denoised_image(apply_tonemap=False)
            if not _rank0():
                return
            if args.out.endswith(".npy"):
                np.save(args.out, img)
            else:
                write_pfm(args.out, img)
        else:
            eng.save_hdr(args.out)
    elif args.denoise:
        from opencl_path_tracer_tpu_torch.io.image import write_png
        img = eng.denoised_image()
        if _rank0():
            write_png(args.out, img)
    else:
        eng.save_png(args.out)


def _render_dispersive(args, cfg, scene, device) -> int:
    """`render --dispersion V_D [--bands B]`: the spectral path
    (`models.spectral`), per-band wavefront renders of Abbe-model glass
    combined to RGB, written as the engine's output would be. It
    composes with --nee, --rr, --qmc, --dof, --smooth and --textured and
    refuses what the JAX package's refuses. Unlike it, it validates the
    config first (so --qmc with --mode parity is refused, as on the
    normal path) and refuses V_D <= 0 (where the model gives NaN)."""
    import numpy as np
    from opencl_path_tracer_tpu_torch.io.image import write_pfm, write_png
    from opencl_path_tracer_tpu_torch.ops import tonemap as tonemap_ops

    cfg.validate()
    if cfg.model != "wavefront":
        raise SystemExit("--dispersion needs --model wavefront")
    ctrl, isect, render = _dispersive_renderer(
        args, cfg, scene, device, cfg.spp,
        ((args.adaptive is not None, "--adaptive"), (args.median, "--median"),
         (args.denoise, "--denoise"), (args.env, "--env"),
         (args.envmap is not None, "--envmap"),
         (args.resume is not None, "--resume"),
         (args.checkpoint is not None, "--checkpoint")))
    t0 = time.perf_counter()
    img = render(ctrl.camera(cfg.width, cfg.height))
    dt = time.perf_counter() - t0
    print(f"\n{args.bands}-band dispersive render (V_d="
          f"{args.dispersion:g}, accel {isect.accel}) at {cfg.spp} spp in "
          f"{dt:.2f}s on {device}", file=sys.stderr)
    img = img.reshape(cfg.height, cfg.width, 3)
    if args.out.endswith(".npy"):
        np.save(args.out, img.cpu().numpy()[::-1])
    elif args.out.endswith(".pfm"):
        write_pfm(args.out, img.cpu().numpy()[::-1])
    else:
        write_png(args.out, tonemap_ops.apply(img, cfg.tonemap)
                  .cpu().numpy()[::-1])
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


def _dispersive_renderer(args, cfg, scene, device, spp: int, refused):
    """(controller, intersector, renderer) of the dispersion path of a
    validated config, after refusing each (condition, flag) of `refused`,
    --bands < 1 and V_D <= 0: the intersector built at the controller's
    camera, the emitter table and any-hit test of
    `_spectral_nee`, and `spectral.make_dispersive_renderer` at `spp`
    samples a band, which takes each frame's camera."""
    from opencl_path_tracer_tpu_torch.models import spectral
    from opencl_path_tracer_tpu_torch.runtime.controller import (
        CameraController,
    )
    from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn

    for bad, flag in refused:
        if bad:
            raise SystemExit(f"--dispersion does not compose with {flag}")
    if args.bands < 1:
        raise SystemExit("--bands must be >= 1")
    if args.dispersion <= 0:
        raise SystemExit(f"--dispersion takes an Abbe number > 0, got "
                         f"{args.dispersion:g}")
    ctrl = CameraController(cfg, device=device)
    isect = make_intersect_fn(scene, cfg.accel, smooth=cfg.smooth,
                              textured=cfg.textured,
                              cam=ctrl.camera(cfg.width, cfg.height),
                              iterations=cfg.iterations,
                              force=cfg.accel_force)
    nee_tab, occ = _spectral_nee(cfg, scene)
    render = spectral.make_dispersive_renderer(
        scene.mats, intersect_fn=isect, num_pixels=cfg.width * cfg.height,
        iterations=cfg.iterations, min_spp=spp, bands=args.bands,
        v_d=args.dispersion, mode=cfg.mode, seed=cfg.seed, qmc=cfg.qmc,
        nee=nee_tab, occluded_fn=occ,
        rr=((cfg.rr_start, cfg.rr_pmin) if cfg.rr_start is not None
            else None),
        dof=((cfg.dof_aperture, cfg.dof_focus) if cfg.dof_aperture > 0.0
             else None))
    return ctrl, isect, render


def _spectral_nee(cfg, scene):
    """(emitter table, any-hit test) of the dispersion path, as the engine
    builds them, on the undispersed scene (emission does not disperse):
    (None, None) without --nee, and no any-hit test with
    --no-nee-anyhit."""
    from opencl_path_tracer_tpu_torch.ops.kernels.tilecull_kernel import (
        make_scene_occluded,
    )
    from opencl_path_tracer_tpu_torch.ops.nee import build_emitter_table
    if not cfg.nee:
        return None, None
    nee_tab = build_emitter_table(scene.tris, scene.mats, scene.spheres,
                                  select=cfg.nee_select)
    return nee_tab, (make_scene_occluded(scene) if cfg.nee_anyhit else None)


def cmd_info(args) -> int:
    """The device table (the reference's list_info, main.cpp:389-455)."""
    from opencl_path_tracer_tpu_torch.parallel.mesh import describe_devices
    from opencl_path_tracer_tpu_torch.utils.device import resolve_device
    import torch
    dev = resolve_device(args.device)
    print(f"torch {torch.__version__} backend: {dev.type}")
    describe_devices(verbose=True, device=dev)
    return 0


def cmd_view(args) -> int:
    """The interactive loop without a window: --frames frames of
    `RenderEngine.frame` (the 1 Hz meter on stderr), then the last frame
    to --out."""
    from opencl_path_tracer_tpu_torch.runtime.engine import RenderEngine
    from opencl_path_tracer_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = _config(args)
    scene = _build_scene(args.scene, device, args.models_dir, cfg.smooth)
    eng = RenderEngine(scene, cfg, device=device)
    last = time.time()
    for _ in range(args.frames):
        now = time.time()
        eng.frame(dt=now - last)
        last = now
    print(file=sys.stderr)
    eng.save_png(args.out)
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


def cmd_serve(args) -> int:
    """The live browser viewer (`runtime/viewer.py`) on 127.0.0.1:--port
    until ESC or an interrupt."""
    from opencl_path_tracer_tpu_torch.runtime.engine import RenderEngine
    from opencl_path_tracer_tpu_torch.runtime.viewer import ViewerServer
    from opencl_path_tracer_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = _config(args)
    scene = _build_scene(args.scene, device, args.models_dir, cfg.smooth)
    ViewerServer(RenderEngine(scene, cfg, device=device),
                 port=args.port).serve()
    return 0


def _scene_bounds(scene):
    """(lo, hi) float32 numpy corners of the scene's triangles (the
    analytic spheres are left out, as in the JAX package)."""
    import numpy as np
    t = scene.tris
    pts = np.concatenate([c.cpu().numpy().reshape(-1, 3)
                          for c in (t.r1, t.r2, t.r3)], 0)
    return pts.min(0), pts.max(0)


def cmd_anim(args) -> int:
    """An offline turntable: the camera orbits the scene and each pose is
    rendered from a fresh accumulator to a PNG (--out-dir) and a looping
    GIF (--gif); with --dispersion, through the spectral path."""
    import numpy as np
    from opencl_path_tracer_tpu_torch.runtime import anim
    from opencl_path_tracer_tpu_torch.runtime.engine import RenderEngine
    from opencl_path_tracer_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = _config(args)
    scene = _build_scene(args.scene, device, args.models_dir, cfg.smooth)
    lo, hi = _scene_bounds(scene)
    center = (tuple(args.center) if args.center is not None
              else tuple((lo + hi) / 2.0))
    radius = (args.radius if args.radius is not None
              else 1.6 * float(np.linalg.norm(hi - lo)) / 2.0)
    poses = anim.turntable_poses(
        frames=args.frames, center=center, radius=radius,
        pitch=args.pitch if args.pitch is not None else 12.0,
        sweep=args.sweep)
    print(f"turntable: {args.frames} poses around "
          f"{tuple(float(c) for c in center)}, radius {radius:.0f}, "
          f"{args.spp} spp each", file=sys.stderr)
    t0 = time.time()
    if args.dispersion is not None:
        _anim_dispersive(args, cfg, scene, poses, device)
    else:
        anim.render_animation(
            RenderEngine(scene, cfg, device=device), poses, spp=args.spp,
            out_dir=args.out_dir, gif_path=args.gif or None, fps=args.fps,
            denoise=args.denoise)
    dt = time.time() - t0
    print(f"{args.frames} frames in {dt:.1f}s ({args.frames / dt:.2f} fps "
          f"offline on {device})", file=sys.stderr)
    if args.out_dir:
        print(f"wrote {args.out_dir}/frame_*.png", file=sys.stderr)
    if args.gif:
        print(f"wrote {args.gif}", file=sys.stderr)
    return 0


def _anim_dispersive(args, cfg, scene, poses, device) -> None:
    """`anim --dispersion V_D`: the dispersive turntable. One renderer
    (`_dispersive_renderer`: the band tables, the intersector, the
    emitter table and the any-hit test built once) takes each pose's
    camera. It refuses --denoise, --env and --envmap as the JAX
    package's does and, like `_render_dispersive`, validates the config
    first and refuses V_D <= 0. Each frame is tonemapped on the device
    and its rows flipped on the host (the JAX package flips, then
    tonemaps on the host: the tonemap is per pixel, so the pixels are
    the same)."""
    import os

    import numpy as np
    from opencl_path_tracer_tpu_torch.io.image import to_uint8, write_png
    from opencl_path_tracer_tpu_torch.ops import tonemap as tonemap_ops
    from opencl_path_tracer_tpu_torch.runtime.anim import write_gif

    cfg.validate()
    ctrl, _, render = _dispersive_renderer(
        args, cfg, scene, device, args.spp,
        ((args.denoise, "--denoise"), (args.env, "--env"),
         (args.envmap is not None, "--envmap")))
    w, h = cfg.width, cfg.height
    frames = []
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
    for i, (yaw, pitch, shift) in enumerate(poses):
        st = ctrl.state
        st.yaw = float(yaw)
        st.pitch = float(pitch)
        st.shift = np.asarray(shift, np.float64)
        img = render(ctrl.camera(w, h)).reshape(h, w, 3)
        img = to_uint8(tonemap_ops.apply(img, cfg.tonemap).cpu().numpy()
                       [::-1])
        frames.append(img)
        if args.out_dir:
            write_png(os.path.join(args.out_dir, f"frame_{i:04d}.png"), img)
        print(f"\rframe {i + 1}/{len(poses)} (yaw {yaw:.1f})", end="",
              flush=True, file=sys.stderr)
    print(file=sys.stderr)
    if args.gif:
        write_gif(args.gif, frames, fps=args.fps)


def _common(p) -> None:
    """The flags that render, view, anim and serve share (the JAX CLI's
    `common`, with --device)."""
    from opencl_path_tracer_tpu_torch.config import ACCELS
    p.add_argument("--scene", default="cornell",
                   help=f"one of {', '.join(SCENES)}")
    p.add_argument("--models-dir", default=None,
                   help="directory of the reference scene's OBJ models "
                        "(tests/assets/models); a missing model is "
                        "replaced by a tessellated sphere")
    p.add_argument("--smooth", action="store_true",
                   help="smooth shading: build the scene with vertex "
                        "normals and interpolate them at the hits")
    p.add_argument("--textured", action="store_true",
                   help="image textures: multiply kd by each material's "
                        "map_Kd sample at the hit UV (needs a scene with "
                        "bound textures, e.g. an OBJ whose MTL has PNG "
                        "map_Kd entries, and the same ids-reporting "
                        "accels as --smooth)")
    p.add_argument("--size", default="512x512")
    p.add_argument("--iters", type=int, default=5, help="bounce depth")
    p.add_argument("--mode", default="fast", choices=("fast", "parity"))
    p.add_argument("--accel", default="auto", choices=ACCELS,
                   help="auto (up to 8,192 triangles minarg, or on CUDA the "
                        "camera predictor's minarg or tilecull; pairwin "
                        "above), "
                        "minarg, pallas, tilecull, pairwin (the pair "
                        "intersector for large scenes), pairmx (the same "
                        "with the full payload), pair (at its own "
                        "defaults), cluster, group (at most 30 "
                        "clusters of 128), march (block march), flat (flat "
                        "visit list), bvh (LBVH walker), median (the "
                        "reference's tree) or bruteforce (CPU)")
    p.add_argument("--accel-force", action="store_true",
                   help="run bvh or median on CUDA (plain PyTorch walkers "
                        "with no hand-written kernel, refused without it)")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--qmc", action="store_true",
                   help="R2 low-discrepancy pixel jitter (fast mode)")
    p.add_argument("--nee", action="store_true",
                   help="next-event estimation: one shadow ray per diffuse "
                        "vertex, MIS-weighted against the bounce pickup "
                        "(the same converged image, less noise)")
    p.add_argument("--nee-select", default="power",
                   choices=("power", "distance"),
                   help="emitter selection for --nee: 'power' (global, "
                        "power-proportional) or 'distance' (per-lane "
                        "distance weights; sphere emitters only, e.g. "
                        "--scene many-lights)")
    p.add_argument("--no-nee-anyhit", action="store_true",
                   help="trace the shadow rays of --nee and --envmap "
                        "through the nearest-hit intersector instead of "
                        "the any-hit kernel (the "
                        "same bits but for rays that graze a zero-area "
                        "triangle)")
    p.add_argument("--dof", type=float, nargs=2, default=None,
                   metavar=("APERTURE", "FOCUS"),
                   help="thin-lens depth of field: lens radius and "
                        "focal-plane distance (world units)")
    p.add_argument("--env", action="store_true",
                   help="the reference kernel's dormant miss-branch sky "
                        "(prog.cl:367-376)")
    p.add_argument("--env-sky", type=float, nargs=3,
                   default=(0.0, 0.75, 2.0), metavar=("R", "G", "B"),
                   help="the sky color of --env")
    p.add_argument("--env-deep", type=float, nargs=3,
                   default=(1.0, 1.0, 1.0), metavar=("R", "G", "B"),
                   help="the fill color of --env after a diffuse bounce")
    p.add_argument("--envmap", default=None, metavar="SRC",
                   help="environment map: 'gradient', 'sunsky', or a "
                        ".pfm/.npy/.png equirectangular image; adds an "
                        "importance-sampled gather with MIS unless "
                        "--no-env-nee")
    p.add_argument("--env-scale", type=float, default=1.0,
                   help="radiance multiplier of --envmap")
    p.add_argument("--no-env-nee", action="store_true",
                   help="--envmap lights misses only (no escape rays)")
    p.add_argument("--fov", type=float, default=None)
    p.add_argument("--yaw", type=float, default=None)
    p.add_argument("--pitch", type=float, default=None)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain versions")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ptx-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("render", help="offline render to PNG")
    _common(p)
    p.add_argument("--spp", type=int, default=64)
    p.add_argument("--model", default="megakernel",
                   choices=("megakernel", "wavefront"),
                   help="wavefront = path regeneration (the throughput "
                        "model; every pixel still gets exactly --spp "
                        "samples)")
    p.add_argument("--rr", type=int, default=None, metavar="START",
                   help="Russian roulette after START bounces (needs "
                        "--model wavefront)")
    p.add_argument("--devices", type=int, default=1,
                   help="shard the render over N devices "
                        "(0 = all visible; tile sharding is bit-exact "
                        "vs single device)")
    p.add_argument("--tonemap", default="reinhard")
    p.add_argument("--median", action="store_true",
                   help="3x3 median filter + filmic tonemap (the "
                        "reference's dormant filt_im kernel); writes PNG")
    p.add_argument("--denoise", action="store_true",
                   help="edge-aware a-trous wavelet denoiser (Dammertz "
                        "2010) guided by first-hit normals and depth; "
                        "with a .pfm/.npy --out, in linear light")
    p.add_argument("--out", default="render.png",
                   help="the image: PNG, or linear HDR by the extension "
                        ".pfm or .npy")
    p.add_argument("--config", default=None,
                   help="a RenderConfig as JSON (overrides the other "
                        "render flags)")
    p.add_argument("--checkpoint", default=None,
                   help="write the progressive state here at the end (and "
                        "with --autosave-every, during the render)")
    p.add_argument("--resume", default=None,
                   help="start from this checkpoint (either package's)")
    p.add_argument("--autosave-every", type=int, default=0,
                   help="checkpoint to --checkpoint every N samples "
                        "(wavefront: at each convergence check)")
    p.add_argument("--adaptive", default=None, metavar="TOL|auto",
                   help="adaptive sampling (needs --model wavefront): a "
                        "pixel stops once its relative luminance standard "
                        "error is within TOL; --spp is the cap. 'auto' "
                        "probes --min-spp samples and goes adaptive only "
                        "where the probe predicts a win (its bars are TPU "
                        "choices)")
    p.add_argument("--adaptive-tol", type=float, default=0.05,
                   metavar="TOL", help="the tolerance of --adaptive auto")
    p.add_argument("--min-spp", type=int, default=8,
                   help="adaptive floor: samples every pixel takes before "
                        "it may stop")
    p.add_argument("--dispersion", type=float, default=None,
                   metavar="V_D",
                   help="spectral dispersion (needs --model wavefront): "
                        "render --bands wavelength bands whose glass index "
                        "follows the Abbe number V_D (crown about 60, flint "
                        "about 30; lower splits more) and combine them to "
                        "RGB")
    p.add_argument("--bands", type=int, default=3,
                   help="bands of --dispersion (3: the sRGB primaries; "
                        "more: smoother spectra at proportional cost)")
    p.set_defaults(func=cmd_render)

    p = sub.add_parser("view", help="headless interactive loop")
    _common(p)
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--out", default="view.png")
    p.set_defaults(func=cmd_view)

    p = sub.add_parser("anim",
                       help="offline turntable animation (PNG frames, GIF)")
    _common(p)
    p.add_argument("--frames", type=int, default=36)
    p.add_argument("--spp", type=int, default=16,
                   help="samples per pixel per frame")
    p.add_argument("--center", type=float, nargs=3, default=None,
                   metavar=("X", "Y", "Z"),
                   help="orbit center (default: the triangles' bounding "
                        "box center)")
    p.add_argument("--radius", type=float, default=None,
                   help="orbit radius (default: 1.6 x the box's half "
                        "diagonal; --pitch sets the look-down angle, "
                        "default 12)")
    p.add_argument("--sweep", type=float, default=360.0,
                   help="total orbit degrees across --frames")
    p.add_argument("--fps", type=float, default=12.0)
    p.add_argument("--denoise", action="store_true",
                   help="a-trous denoise every frame")
    p.add_argument("--out-dir", default=None,
                   help="write frame_%%04d.png here")
    p.add_argument("--gif", default="turntable.gif",
                   help="looping GIF path ('' to skip)")
    p.add_argument("--dispersion", type=float, default=None,
                   metavar="V_D",
                   help="spectral-dispersion turntable: every frame through "
                        "the --bands-band Abbe-model glass path (see "
                        "render --dispersion)")
    p.add_argument("--bands", type=int, default=3,
                   help="bands of --dispersion")
    p.set_defaults(func=cmd_anim)

    p = sub.add_parser("serve", help="live browser viewer")
    _common(p)
    p.add_argument("--port", type=int, default=8642)
    p.set_defaults(func=cmd_serve)

    p = sub.add_parser("info", help="device table")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default: every CUDA device) or 'cpu'")
    p.set_defaults(func=cmd_info)
    args = ap.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
