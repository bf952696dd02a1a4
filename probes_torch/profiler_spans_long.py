"""Does a long run with no profiler session (`chip_smoke.check_slice25`'s
part (a)) make torch.profiler lose K6's kernel spans in the profiles
after it (20 calls a profile, as the smoke's `device_ms` takes them), and
after `utils.trace_profile`? On the GPU:

    python3 probes_torch/profiler_spans_long.py
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs


def spans(torch, fn, reps=20):
    """{kernel: (spans kept, mean span in us)} of one profile of reps
    calls of fn."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and "anonymous namespace" in e.name):
            out.setdefault("K6", []).append(e.time_range.elapsed_us())
    return {k: (len(v), round(sum(v) / len(v), 1)) for k, v in out.items()}


def main():
    import torch
    cs.import_port()
    from opencl_path_tracer_tpu_torch.models import megakernel
    from opencl_path_tracer_tpu_torch.ops import rng
    from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
    from opencl_path_tracer_tpu_torch.ops.kernels import tilecull_kernel as tk
    from opencl_path_tracer_tpu_torch.runtime.engine import RenderEngine
    from opencl_path_tracer_tpu_torch.scene import library
    from opencl_path_tracer_tpu_torch.utils import trace_profile
    cs.device_line(torch)
    cs.build_line()
    scenes = {
        "cornell": library.cornell_box(with_spheres=True, device="cuda"),
        "cornell-analytic": library.cornell_box(
            with_spheres=True, analytic_spheres=True, device="cuda"),
        "many-lights": library.many_light_scene(64, device="cuda"),
        "reference": library.reference_scene(cs.MODELS_DIR, smooth=True,
                                             device="cuda"),
        "stress": library.stress_scene(device="cuda"),
    }
    scene = scenes["cornell"]
    cam = library.cornell_camera(cs.W, cs.H, device="cuda")
    rays = cs.camera_rays(cam)
    r8 = k1.pack_rays(rays.p, rays.d).contiguous()
    eye = tuple(float(v) for v in cam.eye.cpu())
    cpack, cgroups, _ = tk.grouped_pack(scene.tris, 128, origin=eye)
    csub = tk.anyhit_sub_boxes(cpack, cgroups)
    fn = lambda: tk.tilecull(r8, cpack, cgroups, csub)
    cs._slice25_determinism(torch, scenes, lambda c: None)
    print("after part (a), no session yet:", spans(torch, fn),
          spans(torch, fn))
    eng = RenderEngine(scene, cs.slice25_cfg("cornell"), device="cuda")
    st = megakernel.init_state(cs.W * cs.H, 1, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        with trace_profile(tmp):
            megakernel.trace_sample(eng.camera, eng.scene.mats, st,
                                    intersect_fn=eng.intersect_fn,
                                    iterations=5, mode="fast",
                                    key=rng.key(1))
    print("after trace_profile:", spans(torch, fn), spans(torch, fn))


if __name__ == "__main__":
    main()
