"""The auto accel's anchors on the card: the measurement that sets
`runtime/engine.py::AUTO_TILECULL_THRESHOLD`.

No counterpart module in `opencl_path_tracer_tpu`: its threshold (0.55,
`tilecull_kernel.auto_small_accel`) comes from TPU anchors. The anchors
here are the JAX package's own (tests/test_tilecull.py:255-299): the
Cornell box at 5 bounces and at 1, the Cornell box with its spheres
tessellated at (26, 50) (5,012 triangles) at 5 bounces, all at
1920x1080, and the reference scene (1,838 triangles) at 5 bounces seen
from the Cornell preset at 1536x864. For each it prints the predicted
share of K6's group tests (`estimate_tile_need_fraction`), the
predictor's host seconds, and the megakernel's wall ms a sample with
accel 'minarg' and 'tilecull' (groups front to back from the eye, as the
engine builds them), timed in turns in one process, with each accel's
median and spread (largest less smallest) over the turns. An anchor is
won by an accel whose median is lower by more than the larger spread.
`threshold_rule` turns the winners into the threshold: the midpoint
between the fractions where 'tilecull' wins and those where 'minarg'
wins when they separate and each wins one; 1.0 when 'tilecull' wins or
ties everywhere; else 0.0. Needs a GPU:

    python -m opencl_path_tracer_tpu_torch.runtime.accel_anchors \\
        [--models-dir tests/assets/models] [--turns 3] [--spp 4]

The last line is the JSON of the rows and the rule's threshold.
`chip_smoke.py` runs the same measurement (`measure`).
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

ANCHORS = (  # name, scene, bounces, width, height
    ("cornell", "cornell", 5, 1920, 1080),
    ("cornell i1", "cornell", 1, 1920, 1080),
    ("dense cornell", "dense", 5, 1920, 1080),
    ("reference", "reference", 5, 1536, 864),
)
ACCELS = ("minarg", "tilecull")


def anchor_scene(kind: str, models_dir: str, device):
    from opencl_path_tracer_tpu_torch.scene import library
    if kind == "cornell":
        return library.cornell_box(with_spheres=True, device=device)
    if kind == "dense":
        return library.cornell_box(with_spheres=True, sphere_res=(26, 50),
                                   device=device)
    return library.reference_scene(models_dir, device=device)


def _config(accel, iterations, width, height):
    from opencl_path_tracer_tpu_torch.config import CameraConfig, RenderConfig
    return RenderConfig(width=width, height=height, iterations=iterations,
                        accel=accel, camera=CameraConfig(
                            fov=60.0, yaw=0.0, pitch=0.0,
                            shift=(0.0, 0.0, 0.0)))


def measure(models_dir: str, device="cuda", turns: int = 3, spp: int = 4,
            log=print):
    """One row per anchor: fraction, the predictor's host seconds (one
    `estimate_tile_need_fraction` call), the pick of
    `auto_small_accel` at the engine's threshold and of an 'auto'
    RenderEngine, and each accel's wall ms a sample per turn, median,
    spread and the winner ('minarg', 'tilecull' or 'tie')."""
    from opencl_path_tracer_tpu_torch.ops.kernels.tilecull_kernel import (
        auto_small_accel, estimate_tile_need_fraction,
    )
    from opencl_path_tracer_tpu_torch.runtime import engine
    rows = []
    for name, kind, iters, w, h in ANCHORS:
        scene = anchor_scene(kind, models_dir, device)
        engines = {a: engine.RenderEngine(scene, _config(a, iters, w, h),
                                          device=device) for a in ACCELS}
        cam = engines["minarg"].camera
        t0 = time.perf_counter()
        frac = estimate_tile_need_fraction(scene.tris, cam,
                                           iterations=iters)
        host_s = time.perf_counter() - t0
        pick = auto_small_accel(scene.tris, cam, iterations=iters,
                                threshold=engine.AUTO_TILECULL_THRESHOLD)
        auto = engine.RenderEngine(scene, _config("auto", iters, w, h),
                                   device=device).intersect_fn.accel
        for eng in engines.values():   # warm-up: build, first launches
            eng.render(1, progress=False)
        ms = {a: [] for a in ACCELS}
        for turn in range(turns):
            for a in (ACCELS if turn % 2 == 0 else ACCELS[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engines[a].render(spp, progress=False)
                ms[a].append((time.perf_counter() - t0) * 1e3 / spp)
        med = {a: statistics.median(v) for a, v in ms.items()}
        spread = {a: max(v) - min(v) for a, v in ms.items()}
        margin = max(spread.values())
        winner = ("tie" if abs(med["minarg"] - med["tilecull"]) <= margin
                  else min(ACCELS, key=med.get))
        row = dict(anchor=name, triangles=scene.num_triangles,
                   bounces=iters, size=f"{w}x{h}", fraction=frac,
                   predictor_s=host_s, pick=pick, engine_pick=auto,
                   minarg_ms=ms["minarg"], tilecull_ms=ms["tilecull"],
                   minarg_median=med["minarg"],
                   tilecull_median=med["tilecull"],
                   minarg_spread=spread["minarg"],
                   tilecull_spread=spread["tilecull"], winner=winner)
        log(f"anchor {name}: {scene.num_triangles} triangles, {iters} "
            f"bounces, {w}x{h}: fraction {frac!r} (predictor {host_s:.3f} "
            f"s on the host), minarg {ms['minarg']} ms a sample (median "
            f"{med['minarg']:.3f}, spread {spread['minarg']:.3f}), "
            f"tilecull {ms['tilecull']} (median {med['tilecull']:.3f}, "
            f"spread {spread['tilecull']:.3f}): {winner}; auto picks "
            f"{auto} (auto_small_accel {pick})")
        rows.append(row)
        del engines
    return rows


def threshold_rule(rows):
    """(threshold, reason) from the rows' winners and fractions."""
    won = {a: [r["fraction"] for r in rows if r["winner"] == a]
           for a in ACCELS}
    if not won["minarg"]:
        return 1.0, "tilecull wins or ties every anchor"
    if not won["tilecull"]:
        return 0.0, "minarg wins or ties every anchor"
    lo, hi = max(won["tilecull"]), min(won["minarg"])
    if lo < hi:
        return 0.5 * (lo + hi), (f"tilecull wins at fractions up to {lo!r}, "
                                 f"minarg from {hi!r}: the midpoint")
    return 0.0, "the winners interleave in the fraction"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--models-dir", default="tests/assets/models")
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--spp", type=int, default=4,
                    help="samples per timed render of an accel in a turn")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("accel_anchors needs a GPU")
    rows = measure(args.models_dir, "cuda", args.turns, args.spp)
    thr, why = threshold_rule(rows)
    print(f"threshold {thr!r}: {why}")
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "rows": rows, "threshold": thr, "reason": why}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
