"""Does anything of `chip_smoke.check_slice25` make torch.profiler lose
kernel spans in a fresh process? K6's spans in profiles of 20 calls on
the 1080p cornell camera rays (as the smoke's `device_ms` takes them):
at the start, after `utils.device_timer`, after a profile of a whole
megakernel sample, after `utils.trace_profile` twice; then with the
caching allocator filled to 40-78 GiB and freed, before and after
`torch.cuda.empty_cache()`. On the GPU:

    python3 probes_torch/profiler_spans.py
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
            out.setdefault(e.name.split("(")[1].split("<")[0][:30], []).append(
                e.time_range.elapsed_us())
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
    from opencl_path_tracer_tpu_torch.utils import device_timer, trace_profile
    cs.device_line(torch)
    cs.build_line()
    print("supported activities", torch.profiler.supported_activities())
    scene = library.cornell_box(with_spheres=True, device="cuda")
    cam = library.cornell_camera(cs.W, cs.H, device="cuda")
    rays = cs.camera_rays(cam)
    r8 = k1.pack_rays(rays.p, rays.d).contiguous()
    eye = tuple(float(v) for v in cam.eye.cpu())
    cpack, cgroups, _ = tk.grouped_pack(scene.tris, 128, origin=eye)
    csub = tk.anyhit_sub_boxes(cpack, cgroups)
    fn = lambda: tk.tilecull(r8, cpack, cgroups, csub)
    eng = RenderEngine(scene, cs.slice25_cfg("cornell"), device="cuda")
    st = megakernel.init_state(cs.W * cs.H, 1, device="cuda")

    def sample(s):
        return megakernel.trace_sample(eng.camera, eng.scene.mats, s,
                                       intersect_fn=eng.intersect_fn,
                                       iterations=5, mode="fast",
                                       key=rng.key(1))

    print("baseline", spans(torch, fn), spans(torch, fn))
    device_timer(sample, st)
    print("after device_timer", spans(torch, fn))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        sample(st)
        torch.cuda.synchronize()
    n = len(prof.events())
    print(f"after a whole-sample profile ({n} events)", spans(torch, fn),
          spans(torch, fn))
    for label in ("after trace_profile", "after a second trace_profile"):
        with tempfile.TemporaryDirectory() as tmp:
            with trace_profile(tmp):
                sample(st)
        print(label, spans(torch, fn), spans(torch, fn))
    for gib in (40, 60, 70, 74, 76, 78):
        held = []
        try:
            for _ in range(gib):
                held.append(torch.empty(1 << 28, dtype=torch.float32,
                                        device="cuda"))
        except torch.OutOfMemoryError:
            print(f"out of memory at {len(held)} GiB")
        del held
        free, total = torch.cuda.mem_get_info()
        print(f"cache {gib} GiB: reserved "
              f"{torch.cuda.memory_reserved() / 2**30:.1f} GiB, device free "
              f"{free / 2**30:.2f} of {total / 2**30:.1f}",
              spans(torch, fn), spans(torch, fn))
        torch.cuda.empty_cache()
        free, _ = torch.cuda.mem_get_info()
        print(f"  after empty_cache: free {free / 2**30:.2f} GiB",
              spans(torch, fn))


if __name__ == "__main__":
    main()
