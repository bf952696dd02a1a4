"""The two readings each limit of `checks/<workload>.json` is set from.

    python3 -m benchmark.readings --workload <name> --seeds 1 2 3 ... \\
        [--control 3] [--seconds 51] [--out chiprun_out/readings.jsonl]

For each seed, in one process (the scene and the intersector built
once): the program's engine for that seed, the cell's warm-up and a
short window of the cell's own loop at its own load, then the numbers
`compare.readings` gives for its accumulated colours (and displayed
frame) against the float32 reference: the lower reading is the largest
over the seeds. For the first `--control` seeds, the same numbers for
the control: the reference itself computed in bfloat16, the precision
below the configuration's float32, put in the program's place: the
upper reading is the smallest. One JSON line per seed and side. Needs
a CUDA device. A configuration with `devices` above 1 runs its seeds on
the multi-rank path (`ranks.py`: one set-up of the ranks for every
seed), and the reference and the control run here once the ranks have
ended.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import compare, loops, ranks, reference, scenes
from benchmark.manifest import Manifest
from benchmark.run import (
    outputs, reference_readings, release, render_seed,
)


def control_readings(arrays, cam, dev, rseed, pixels, samples, render,
                     ref, display: bool):
    """The control's numbers: the bfloat16 reference against ref (and its
    displayed uint8 where the cell displays)."""
    nee = bool(render.get("nee", False))
    sc = reference.Scene(arrays, cam, dev, dtype=torch.bfloat16)
    low = reference.render_pixels(sc, rseed, pixels, samples,
                                  int(render["iterations"]), nee,
                                  int(render.get("devices", 1)))
    if display:
        return compare.readings(low, ref, reference.display_u8(low),
                                reference.display_u8(ref))
    return compare.readings(low, ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    from benchmark import program
    man = Manifest.load()
    cell = man.workload(args.workload)
    cfg = man.config(cell["config"])
    traffic = man.traffic(cell["traffic"])
    render = {**cfg, **traffic.get("render", {})}
    arrays = scenes.build_scene(cfg)
    cam = scenes.camera(render)
    count = man.checks(args.workload)["pixels"]
    every = [compare.check_pixels(seed, render["width"] * render["height"],
                                  count) for seed in args.seeds]
    mesh = None
    if int(render.get("devices", 1)) != 1:
        job = dict(workload=args.workload, manifest=man, config=cfg,
                   traffic=traffic, render=render, seeds=args.seeds,
                   pixels=every, seconds=args.seconds, trace=False,
                   device="cuda", t0_wall=time.time())
        mesh, _ = ranks.run(job, int(render["devices"]), "cuda")
    else:
        scene = program.build_scene(arrays, dev)
    fn = None
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(args.seeds):
        rseed = render_seed(seed)
        pixels = every[i]
        if mesh is not None:
            asked, samples = mesh[i]["asked"], mesh[i]["samples"]
            prog, prog_u8, accel = mesh[i]["colors"], None, mesh[i]["accel"]
        else:
            eng = program.make_engine(arrays, render, rseed, dev,
                                      intersect_fn=fn, scene=scene)
            fn = eng.intersect_fn
            accel = getattr(fn, "accel", None)
            loops.warm_up(eng, traffic)
            win = loops.window(eng, traffic, args.seconds)
            asked = 1 + win["samples"]
            samples, prog, prog_u8 = outputs(eng, win, pixels, render)
            del eng, win
            release(dev)
        t0 = time.perf_counter()
        ref, values = reference_readings(arrays, cam, dev, rseed, pixels,
                                         asked, render, prog, prog_u8,
                                         samples)
        ref_s = time.perf_counter() - t0
        rows = [dict(side="program", **values)]
        if i < args.control:
            t0 = time.perf_counter()
            rows.append(dict(side="control", **control_readings(
                arrays, cam, dev, rseed, pixels, asked, render, ref,
                prog_u8 is not None)))
            rows[-1]["control_s"] = time.perf_counter() - t0
        for r in rows:
            r.update(workload=args.workload, seed=seed, samples=samples,
                     pixels=len(pixels), reference_s=ref_s, accel=accel)
            line = json.dumps(r)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
