"""The traced run's instruments and their arithmetic.

* `CallLog` wraps one of the engine's callables (its intersector, its
  any-hit test) and records CUDA events around every call, with the rays
  handed in; the events are read only after the traced phases, so the
  phases hold no extra synchronisation.
* `profile` runs a phase under `torch.profiler` and keeps the device
  operations' spans and the benchmark's own `record_function` ranges.
* `busy_s`, `idle_gaps` and `top_ops` reduce those spans: the busy time
  is the union of the device spans (equal to their sum while everything
  runs on one stream, as the port does today, and still right if it
  ever does not); an idle gap is named by the innermost of the
  benchmark's ranges that was open on the host when the device went
  idle. This is `runtime/profile.py`'s arithmetic (the busy share over
  the wall time of an unprofiled run of equal work), copied here.
* `Trace` carries everything the per-layer readers (`metrics/*.py`) read.
  Over a mesh each rank traces its own card and rank 0's readers read
  its own Trace, with every rank's `rank_summary` beside it (`ranks`).
"""

from __future__ import annotations

import collections
import dataclasses
import time

import torch

RANGES = ("render", "frame", "display", "intersect", "occluded", "image")
# torch.distributed's own ranges around each collective ("nccl:all_reduce"),
# projected onto the device's timeline as the benchmark's are: no op.
COLLECTIVE_RANGES = ("nccl:",)


class CallLog:
    """Events around each call of `fn` (a CUDA device) or host times (the
    CPU, where no device metric is read); `rays` counts the rays of the
    calls, the first argument's `.count`."""

    def __init__(self, fn, name: str, device: torch.device) -> None:
        self.fn, self.name, self.device = fn, name, device
        self.pairs, self.rays = [], 0

    def __call__(self, rays, *args):
        with torch.profiler.record_function(self.name):
            if self.device.type == "cuda":
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = self.fn(rays, *args)
                b.record()
            else:
                a = time.perf_counter()
                out = self.fn(rays, *args)
                b = time.perf_counter()
        self.pairs.append((a, b))
        self.rays += rays.count
        return out

    def reset(self) -> None:
        self.pairs, self.rays = [], 0

    def total_ms(self) -> float:
        """Milliseconds inside the calls (after a synchronise)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            return sum(a.elapsed_time(b) for a, b in self.pairs)
        return sum((b - a) * 1e3 for a, b in self.pairs)


@dataclasses.dataclass
class Spans:
    """One profiled phase: device spans (name, start_us, end_us) and the
    benchmark's host ranges (name, start_us, end_us)."""

    device: list
    host: list


def _kineto_events(prof):
    """(name, is_device, start_us, end_us) of every profiled event."""
    out = []
    cuda = torch.autograd.DeviceType.CUDA
    try:
        evs = prof.profiler.kineto_results.events()
        for e in evs:
            s = e.start_ns() / 1e3
            out.append((e.name(), e.device_type() == cuda, s,
                        s + e.duration_ns() / 1e3))
    except AttributeError:
        for e in prof.events():
            out.append((e.name, e.device_type == cuda, e.time_range.start,
                        e.time_range.end))
    return out


def profile(run, device: torch.device):
    """run() under torch.profiler; (run()'s value, Spans, wall seconds)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        value = run()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    return value, split(_kineto_events(prof)), wall


def split(events) -> Spans:
    """The device operations and the benchmark's host ranges among
    (name, is_device, start_us, end_us) events."""
    dev, host = [], []
    for name, is_dev, s, e in events:
        if name in RANGES:
            # The ranges come twice: on the host, and projected onto the
            # device's timeline (gpu_user_annotation), which is no op.
            if not is_dev:
                host.append((name, s, e))
        elif is_dev and not name.startswith(COLLECTIVE_RANGES):
            dev.append((name, s, e))
    return Spans(device=dev, host=host)


def _merged(spans: list) -> list:
    iv = sorted((s, e) for _, s, e in spans)
    out = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_s(spans: Spans) -> float:
    """Seconds in which some device operation ran (union of spans)."""
    return sum(e - s for s, e in _merged(spans.device)) / 1e6


def top_ops(spans: Spans, n: int = 10) -> list:
    """[[kernel name, seconds]] of the n names with most device time."""
    by = collections.Counter()
    for name, s, e in spans.device:
        by[name] += (e - s) / 1e6
    return [[name, sec] for name, sec in by.most_common(n)]


def idle_gaps(spans: Spans, n: int = 10) -> list:
    """[[range, seconds]] of the n longest device idle gaps between the
    first and the last device span, each named by the innermost of the
    benchmark's host ranges open when the gap began ('host' if none)."""
    merged = _merged(spans.device)
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for g0, g1 in gaps[:n]:
        inner = None
        for name, s, e in spans.host:
            if s <= g0 <= e and (inner is None or s >= inner[1]):
                inner = (name, s)
        out.append([inner[0] if inner else "host", (g1 - g0) / 1e6])
    return out


def is_collective(name: str) -> bool:
    """Whether a device operation is one of NCCL's kernels (a rank that
    reaches a collective first spins inside its kernel until the others
    come)."""
    return name.startswith("nccl")


def is_all_gather(name: str) -> bool:
    return is_collective(name) and "allgather" in name.lower()


def rank_summary(t: "Trace") -> dict:
    """What the mesh readers take of one rank's profiled phase: its
    samples, its device-busy seconds outside NCCL's kernels, and the
    device seconds and count of its all_gather kernels beside the
    image() calls that ran them."""
    own = Spans(device=[s for s in t.spans.device
                        if not is_collective(s[0])], host=[])
    gathers = [e - s for n, s, e in t.spans.device if is_all_gather(n)]
    return dict(samples=t.samples, compute_busy_s=busy_s(own),
                all_gather_s=sum(gathers) / 1e6,
                all_gather_kernels=len(gathers), images=t.images)


@dataclasses.dataclass
class Trace:
    """What one traced run measured, for the per-layer readers.

    loop: the traffic's loop ('offline' or 'interactive'); samples: the
    per-pixel samples of each traced phase (a frame is one);
    wall_plain_s: the unprofiled phase's wall time; window_s, busy_s,
    launches, spans: the profiled phase of equal work; isect_ms,
    isect_rays, anyhit_ms, anyhit_calls: the calls of the intersector and
    the any-hit test in the unprofiled phase; rays: the engine's ray
    counter over both phases, rays_samples the samples it covers;
    display_ms: host ms of each display_u8 call of the unprofiled phase;
    device: 'cuda' or 'cpu'; image_ms: host ms of each image() call of
    the unprofiled phase; images: image() calls in the profiled phase;
    frame_pixels: the whole frame's pixels; ranks: over a mesh, every
    rank's `rank_summary`, rank 0 first (empty on one device)."""

    loop: str
    samples: int
    wall_plain_s: float
    window_s: float
    busy_s: float
    launches: int
    spans: Spans
    isect_ms: float
    isect_rays: int
    isect_calls: int
    anyhit_ms: float
    anyhit_calls: int
    rays: float
    rays_samples: int
    display_ms: list
    device: str
    image_ms: list = dataclasses.field(default_factory=list)
    images: int = 0
    frame_pixels: int = 0
    ranks: list = dataclasses.field(default_factory=list)
