"""The traffic: one general driver of the engine, read from a traffic file.

A traffic file (`traffic/<name>.json`) holds parameters only:

* `loop`: 'offline' (a closed loop of `RenderEngine.render(spp_per_call)`
  calls, each ending in the engine's own synchronise, the meter on, as
  `ptx-torch render` makes them) or 'interactive' (one viewer's closed
  loop: `RenderEngine.frame(dt, sync=False)`, then `display_u8()`, the
  uint8 frame on the host; the camera still, so the accumulation goes
  on: the reference's onIdle loop, main.cpp:683-687);
* `spp_per_call` (offline);
* `image_every_call` (offline, optional, false where absent): after each
  render call, `RenderEngine.image()`, the tonemapped frame on the host,
  as `ptx-torch render`'s `save_png` takes it (over a mesh it gathers
  the frame on every rank); the file is not written;
* `trace_spp` (offline) or `trace_frames` (interactive): the work of each
  phase of a traced run;
* `render`: RenderConfig settings the traffic asks for (`nee`,
  `nee_select`, `nee_anyhit`).

The window runs whole calls (or frames) back to back until `seconds`
have passed; the time runs until the last one returns. Over a mesh every
rank runs the loop, and `agree` makes rank 0's clock end it on every
rank after the same call.
"""

from __future__ import annotations

import time

import numpy as np
import torch

LOOPS = ("offline", "interactive")


def warm_up(eng, traffic: dict):
    """The cell's own calls once, outside the window: one render(1) (its
    meter's first tick traces the engine's one instrumented sample), or
    one frame and its display."""
    if traffic["loop"] == "offline":
        eng.render(1)
        if traffic.get("image_every_call"):
            eng.image()
    else:
        eng.frame(0.0, sync=False)
        eng.display_u8()


def offline(eng, spp: int, seconds: float | None = None, calls=None,
            annotate: bool = False, image: bool = False,
            agree=None) -> dict:
    """render(spp) calls back to back: for `seconds` (whole calls), or
    `calls` of them. image: each call followed by image(), whose host ms
    are kept. agree(stop) -> stop: the world's decision after each call
    (over a mesh; None: this process's own)."""
    done, image_ms = 0, []
    t0 = time.perf_counter()
    while True:
        if annotate:
            with torch.profiler.record_function("render"):
                eng.render(spp)
        else:
            eng.render(spp)
        if image:
            a = time.perf_counter()
            if annotate:
                with torch.profiler.record_function("image"):
                    eng.image()
            else:
                eng.image()
            image_ms.append((time.perf_counter() - a) * 1e3)
        done += 1
        now = time.perf_counter()
        stop = (calls is not None and done >= calls) or (
            seconds is not None and now - t0 >= seconds)
        if agree is not None:
            stop = agree(stop)
        if stop:
            break
    return dict(units=done, samples=done * spp, wall_s=now - t0,
                image_ms=image_ms)


def interactive(eng, seconds: float | None = None, frames=None,
                annotate: bool = False) -> dict:
    """frame(dt, sync=False), then display_u8(), back to back: host ms of
    each frame (the frame's call to its uint8 image on the host) and of
    each display call; the last uint8 frame."""
    lat, disp = [], []
    done, last_img = 0, None
    t0 = last = time.perf_counter()
    while True:
        a = time.perf_counter()
        if annotate:
            with torch.profiler.record_function("frame"):
                eng.frame(a - last, sync=False)
            b = time.perf_counter()
            with torch.profiler.record_function("display"):
                last_img = eng.display_u8()
        else:
            eng.frame(a - last, sync=False)
            b = time.perf_counter()
            last_img = eng.display_u8()
        c = time.perf_counter()
        last = a
        lat.append((c - a) * 1e3)
        disp.append((c - b) * 1e3)
        done += 1
        if (frames is not None and done >= frames) or (
                seconds is not None and c - t0 >= seconds):
            break
    return dict(units=done, samples=done, wall_s=c - t0, frame_ms=lat,
                display_ms=disp, image=last_img)


def window(eng, traffic: dict, seconds: float, agree=None) -> dict:
    if traffic["loop"] == "offline":
        return offline(eng, int(traffic["spp_per_call"]), seconds=seconds,
                       image=bool(traffic.get("image_every_call")),
                       agree=agree)
    return interactive(eng, seconds=seconds)


def phase(eng, traffic: dict, annotate: bool) -> dict:
    """One phase of a traced run: trace_spp samples in one render call
    (and its image() where the traffic asks for one), or trace_frames
    frames."""
    if traffic["loop"] == "offline":
        return offline(eng, int(traffic["trace_spp"]), calls=1,
                       annotate=annotate,
                       image=bool(traffic.get("image_every_call")))
    return interactive(eng, frames=int(traffic["trace_frames"]),
                       annotate=annotate)


def end_to_end(traffic: dict, w: dict) -> dict:
    """The window's end-to-end numbers."""
    if traffic["loop"] == "offline":
        return {"samples_per_s": w["samples"] / w["wall_s"]}
    return {"frame_ms_p95": float(np.percentile(w["frame_ms"], 95)),
            "frames_per_s": w["units"] / w["wall_s"]}
