"""One run of one benchmark cell.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. It needs as many CUDA devices as the cell
asks for and exits non-zero, printing no result, without them: it never
falls back to the CPU. Set-up (`setup_s`, from the start of this
process): the configuration's scene and camera as arrays, the port's
engine built as `ptx-torch render` builds it (the first run in a
checkout also compiles the port's kernels into its fixed build
directory), and one warm-up of the cell's own call. Then, with
`--trace 0`, the window: the traffic's loop for `--seconds`, whose
end-to-end numbers are the cell's `end_to_end` metrics; with `--trace
1`, two phases of equal work, one plain and one under the profiler, whose
numbers the cell's per-layer readers reduce. After either, the output
check (`compare.py`): the program's accumulated colours at pixels drawn
from the seed against the plain reference (`reference.py`) over the same
samples. The last lines on standard error are the numbers compared with
their limits; the last line on standard output is the JSON result.

A configuration with `devices` above 1 runs one rank a card
(`ranks.py`): the same set-up, window or traced phases and output gather
on every rank, the window on rank 0's clock, the check in this process
after the ranks have ended; the result sums or takes the largest of the
ranks' numbers as `ranks.run` says.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse   # noqa: E402
import gc         # noqa: E402
import json       # noqa: E402
import os         # noqa: E402
import sys        # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "opencl_path_tracer_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: the port's name starts with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def render_seed(seed: int) -> int:
    """The engine's seed for a benchmark seed: 1 to 2^31 - 2 (the fast
    sampler keys on 32 bits, the parity streams need a nonzero seed)."""
    return 1 + int(seed) % (2 ** 31 - 2)


def _caches(root) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port builds its CUDA libraries in its own `_build/` there)."""
    base = os.path.join(root, "benchmark", ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def outputs(eng, last: dict, pixels, render: dict):
    """What the timed path produced at the checked pixels: the samples the
    engine accumulated, their (P, 3) colours, and the (P, 3) uint8 of the
    last displayed frame (None without a display)."""
    from benchmark import program
    prog_u8 = None
    if last.get("image") is not None:
        w, h = render["width"], render["height"]
        prog_u8 = last["image"][h - 1 - pixels // w, pixels % w]
    return (program.samples_done(eng), program.pixel_colors(eng, pixels),
            prog_u8)


def release(dev) -> None:
    """Return the freed program's memory before the reference runs."""
    import torch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def reference_readings(arrays, cam, dev, rseed: int, pixels, asked: int,
                       render: dict, prog, prog_u8, samples: int):
    """(reference colours, the numbers compared): the reference renders
    the checked pixels over the samples asked for."""
    from benchmark import compare, reference
    ref = reference.render_pixels(
        reference.Scene(arrays, cam, dev), rseed, pixels, asked,
        int(render["iterations"]), bool(render.get("nee", False)),
        int(render.get("devices", 1)))
    ref_u8 = reference.display_u8(ref) if prog_u8 is not None else None
    return ref, compare.readings(prog, ref, prog_u8, ref_u8, samples, asked)


def _trace_phases(eng, traffic, dev, loops, trace_mod):
    """The traced run's two phases of equal work: (the Trace, the profiled
    phase's loop result). The engine's intersector and any-hit test stay
    wrapped in CallLogs from here on."""
    isect = trace_mod.CallLog(eng.intersect_fn, "intersect", dev)
    eng.intersect_fn = isect
    occ = None
    if eng.occluded is not None:
        occ = trace_mod.CallLog(eng.occluded, "occluded", dev)
        eng.occluded = occ
    rays0 = eng.rays_traced
    plain = loops.phase(eng, traffic, annotate=False)
    isect_ms, isect_rays, isect_calls = (isect.total_ms(), isect.rays,
                                         len(isect.pairs))
    anyhit_ms = occ.total_ms() if occ else 0.0
    anyhit_calls = len(occ.pairs) if occ else 0
    isect.reset()
    if occ:
        occ.reset()
    prof, spans, window_s = trace_mod.profile(
        lambda: loops.phase(eng, traffic, annotate=True), dev)
    rays1 = eng.rays_traced
    return trace_mod.Trace(
        loop=traffic["loop"], samples=plain["samples"],
        wall_plain_s=plain["wall_s"], window_s=window_s,
        busy_s=trace_mod.busy_s(spans), launches=len(spans.device),
        spans=spans, isect_ms=isect_ms, isect_rays=isect_rays,
        isect_calls=isect_calls, anyhit_ms=anyhit_ms,
        anyhit_calls=anyhit_calls, rays=rays1 - rays0,
        rays_samples=plain["samples"] + prof["samples"],
        display_ms=plain.get("display_ms", []), device=dev.type,
        image_ms=plain.get("image_ms", []),
        images=len(prof.get("image_ms", [])),
        frame_pixels=eng.num_pixels), prof


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", overrides: dict | None = None,
             manifest=None, rank_fn=None) -> dict:
    """Set up, run and check one cell; the result's fields. overrides
    (the CPU tests' small sizes): width, height, pixels, spp_per_call,
    trace_spp, trace_frames; over a mesh also devices (the ranks).
    rank_fn: what each rank runs over a mesh (`ranks.rank_cell`)."""
    import torch

    from benchmark import compare, loops, scenes
    from benchmark import trace as trace_mod
    from benchmark.manifest import Manifest

    ov = dict(overrides or {})
    man = manifest or Manifest.load()
    cell = man.workload(workload)
    cfg = man.config(cell["config"])
    traffic = dict(man.traffic(cell["traffic"]))
    checks = man.checks(workload)
    for k in ("spp_per_call", "trace_spp", "trace_frames"):
        if k in ov:
            traffic[k] = ov[k]
    if traffic["loop"] not in loops.LOOPS:
        raise ValueError(f"unknown loop {traffic['loop']!r}")
    render = {**cfg, **traffic.get("render", {})}
    for k in ("width", "height", "devices"):
        if k in ov:
            render[k] = ov[k]
    if int(render.get("devices", 1)) != 1:
        return _run_ranks(workload, seed, seconds, trace, device, ov, man,
                          cfg, traffic, checks, render, rank_fn)
    dev = torch.device(device)
    rseed = render_seed(seed)
    arrays = scenes.build_scene(cfg)
    cam = scenes.camera(render)
    npix = render["width"] * render["height"]
    pixels = compare.check_pixels(seed, npix, int(ov.get("pixels",
                                                         checks["pixels"])))

    from benchmark import program
    eng = program.make_engine(arrays, render, rseed, dev)
    accel = program.accel_name(eng)
    print(f"# {workload}: {arrays.num_triangles} triangles, accel {accel}, "
          f"{render['width']}x{render['height']}, seed {rseed}",
          file=sys.stderr)
    loops.warm_up(eng, traffic)
    asked = 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - T_START

    out = {"accel": accel}
    if trace:
        tr, last = _trace_phases(eng, traffic, dev, loops, trace_mod)
        asked += tr.rays_samples
        metrics = {}
        for m in man.per_layer(workload):
            v = man.reader(m["name"])(tr)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        units = last["units"]
        out["busy_s"], out["window_s"] = tr.busy_s, tr.window_s
        out["breakdown"] = {"device_ops": trace_mod.top_ops(tr.spans),
                            "idle_gaps": trace_mod.idle_gaps(tr.spans)}
    else:
        last = loops.window(eng, traffic, seconds)
        units = last["units"]
        asked += last["samples"]
        e2e = loops.end_to_end(traffic, last)
        e2e["setup_s"] = setup_s
        metrics = {m["name"]: {"value": float(e2e[m["name"]]),
                               "unit": m["unit"]}
                   for m in man.end_to_end(workload)}
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    samples, prog, prog_u8 = outputs(eng, last, pixels, render)
    del eng, last
    release(dev)
    t_ref = time.perf_counter()
    _, values = reference_readings(arrays, cam, dev, rseed, pixels, asked,
                                   render, prog, prog_u8, samples)
    correct, checked = compare.judge(values, checks["limits"])
    out.update(correct=bool(correct), attempted=int(units), failed=0,
               metrics=metrics, samples=samples, pixels=len(pixels),
               reference_s=time.perf_counter() - t_ref,
               memory_peak_bytes=int(peak), checks=checked)
    return out


def _run_ranks(workload, seed, seconds, trace, device, ov, man, cfg,
               traffic, checks, render, rank_fn) -> dict:
    """run_cell over a mesh of render["devices"] ranks (`ranks.py`)."""
    import torch

    from benchmark import compare, ranks, scenes

    world = int(render["devices"])
    pixels = compare.check_pixels(
        seed, render["width"] * render["height"],
        int(ov.get("pixels", checks["pixels"])))
    kind = torch.device(device).type
    job = dict(workload=workload, manifest=man, config=cfg, traffic=traffic,
               render=render, seeds=[seed], pixels=[pixels],
               seconds=seconds, trace=trace, device=kind,
               t0_wall=time.time() - (time.perf_counter() - T_START))
    (res,), bad = ranks.run(job, world, kind, rank_fn)
    out = {"accel": res["accel"], "forbidden": bad, "ranks": world,
           "memory_peak_bytes": res["memory_peak_bytes"]}
    if trace:
        out.update(metrics=res["metrics"], busy_s=res["busy_s"],
                   window_s=res["window_s"], breakdown=res["breakdown"])
    else:
        e2e = dict(res["end_to_end"], setup_s=res["setup_s"])
        out["metrics"] = {m["name"]: {"value": float(e2e[m["name"]]),
                                      "unit": m["unit"]}
                          for m in man.end_to_end(workload)}
    t_ref = time.perf_counter()
    _, values = reference_readings(
        scenes.build_scene(cfg), scenes.camera(render),
        torch.device(device), render_seed(seed), pixels, res["asked"],
        render, res["colors"], None, res["samples"])
    correct, checked = compare.judge(values, checks["limits"])
    out.update(correct=bool(correct), attempted=int(res["units"]), failed=0,
               samples=res["samples"], pixels=len(pixels),
               reference_s=time.perf_counter() - t_ref, checks=checked)
    return out


def result_line(res: dict, count: int, trace: bool, kind: str) -> dict:
    """The JSON result of a run: count cards of the given kind; the
    numbers compared come last."""
    device = {"platform": "gpu", "kind": kind, "count": count,
              "memory_peak_bytes": res["memory_peak_bytes"]}
    if trace:
        device["busy_s"] = res["busy_s"]
        device["window_s"] = res["window_s"]
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device}
    if trace:
        line["breakdown"] = res["breakdown"]
    line.update(accel=res["accel"], samples=res["samples"],
                pixels_checked=res["pixels"],
                reference_s=res["reference_s"], checks=res["checks"])
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.manifest import ROOT, Manifest
    man = Manifest.load()
    cell = man.workload(args.workload)
    _caches(ROOT)
    import torch
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < int(cell["chips"])):
        print(f"error: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " (no CPU fallback)", file=sys.stderr)
        return 2
    res = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   manifest=man)
    bad = sorted(set(forbidden_modules()) | set(res.get("forbidden", ())))
    if bad:
        print(f"error: the run loaded {bad}, which the benchmark must not "
              "import", file=sys.stderr)
        return 3
    line = result_line(res, int(res.get("ranks", cell["chips"])),
                       bool(args.trace), torch.cuda.get_device_name(0))
    print(file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
