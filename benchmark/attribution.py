"""Device idle time put down to the program's own spans.

Plain arithmetic on two lists of spans on one clock, in microseconds:
the device operations of a traced run's profiled phase (`trace.Spans.
device`) and the spans the program recorded on the host in the same
phase, (name, start, end). It imports nothing of the program.

0. The program's spans are moved onto the device spans' clock (`align`):
   the profiler's device timestamps and the host's clock agreed to about
   10 µs in most profiled runs on the H100 of the port's benchmark,
   and were 0.4 ms apart in others. A blocking read (`READS`) waits for
   the device, so when it returns the device has run dry: the offset
   chosen is the one nearest zero at which the fewest reads return
   while a device span is running.
1. Every idle gap between consecutive merged device spans of the phase
   (all of them, not the longest ten `trace.idle_gaps` keeps).
2. Each gap is named by the innermost program span open on the host when
   it began: the host was there when the device ran dry.
3. A span name maps to a layer by its first dotted part (`LAYERS`):
   `step*` the model step, `isect*` the intersect, `nee.*` NEE,
   `display*` the display, `engine.*` the engine. A gap under no span,
   or under a span of no layer, is `OUTSIDE`.
4. The profiler lengthens the host's work (its phase runs 1.3-1.8x the
   plain phase's wall for the same device work), so the profiled gaps'
   lengths are the profiler's. Each layer's share of the gap time is laid
   over the plain phase's idle time instead, (wall_plain_s - busy_s) x
   1e3 / samples ms a sample: the layers and OUTSIDE sum to it.
"""

from __future__ import annotations

import bisect
import collections

LAYERS = {"step": "model step", "isect": "intersect", "nee": "NEE",
          "display": "display", "engine": "engine"}
OUTSIDE = "outside"
# The program's spans around a blocking device read: the engine's
# synchronise, the display's host copy, the intersect schedule's reads.
READS = ("engine.sync", "display.copy", "isect.host_read")
# How far (µs) the two clocks may be moved apart.
MAX_OFFSET_US = 2_000.0


def layer_of(name) -> str:
    """The layer of a span name (None, no span: OUTSIDE)."""
    if name is None:
        return OUTSIDE
    return LAYERS.get(name.split(".", 1)[0], OUTSIDE)


def align(device: list, program: list) -> list:
    """The program spans shifted by the offset (within MAX_OFFSET_US)
    nearest zero at which the fewest READS spans end inside a merged
    device span: when a read returns, the device it waited for has run
    dry. Unchanged without a read."""
    reads = [e for n, _, e in program if n in READS]
    busy = _merged(device)
    if not reads or not busy:
        return program
    starts = [a for a, _ in busy]
    # Violations as a function of the offset o: read e is inside busy
    # interval (a, b) for o in (a - e, b - e).
    events = []
    for e in reads:
        i = max(bisect.bisect_left(starts, e - MAX_OFFSET_US) - 1, 0)
        while i < len(busy) and busy[i][0] < e + MAX_OFFSET_US:
            a, b = busy[i]
            events += [(a - e, 1), (b - e, -1)]
            i += 1
    # The regions between event points, each with its count; the best
    # offset is the point of a fewest-violation region nearest zero.
    events.sort()
    best = (len(reads) + 1, 0.0)
    inside, lo = 0, -MAX_OFFSET_US
    for o, d in events + [(MAX_OFFSET_US, 0)]:
        hi = min(o, MAX_OFFSET_US)
        if hi > lo:
            at = min(max(0.0, lo), hi)
            if (inside, abs(at)) < (best[0], abs(best[1])):
                best = (inside, at)
        lo = max(lo, o)
        inside += d
    off = best[1]
    return [(n, s + off, e + off) for n, s, e in program]


def _merged(device: list) -> list:
    out = []
    for s, e in sorted((s, e) for _, s, e in device):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def gaps(device: list) -> list:
    """[(start, end)] of every idle gap between consecutive merged device
    spans, in time order."""
    m = _merged(device)
    return [(a[1], b[0]) for a, b in zip(m, m[1:])]


def innermost(program: list, times: list) -> list:
    """For each of the ascending times, the name of the innermost program
    span (name, start, end) open then (start <= t <= end), or None.
    Spans nest, as the recorder's do on one thread."""
    order = sorted(program, key=lambda p: (p[1], -p[2]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(order) and order[i][1] <= t:
            while stack and stack[-1][2] < order[i][1]:
                stack.pop()
            stack.append(order[i])
            i += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out.append(stack[-1][0] if stack else None)
    return out


def idle_by_name(device: list, program: list) -> dict:
    """{innermost span name (None: no span): idle µs of the gaps that
    began under it}."""
    g = gaps(device)
    by = collections.Counter()
    for (g0, g1), name in zip(g, innermost(program, [a for a, _ in g])):
        by[name] += g1 - g0
    return dict(by)


def idle_by_layer(device: list, program: list) -> dict:
    """{layer: idle µs}, every layer of LAYERS and OUTSIDE present."""
    out = dict.fromkeys([*LAYERS.values(), OUTSIDE], 0.0)
    for name, us in idle_by_name(device, program).items():
        out[layer_of(name)] += us
    return out


def plain_idle_ms(wall_plain_s: float, busy_s: float, samples) -> float:
    """The unprofiled phase's idle ms a sample (or a frame)."""
    return (wall_plain_s - busy_s) * 1e3 / samples


def layer_ms(device: list, program: list, wall_plain_s: float,
             busy_s: float, samples) -> dict | None:
    """{layer: ms a sample}: each layer's share of the profiled gaps times
    the plain phase's idle ms a sample; None without a gap."""
    by = idle_by_layer(device, program)
    total = sum(by.values())
    if total <= 0:
        return None
    idle = plain_idle_ms(wall_plain_s, busy_s, samples)
    return {k: idle * v / total for k, v in by.items()}


def read_layer(t, program, layer: str):
    """A per-layer reader's number: layer_ms of a traced run's Trace t
    and the program's spans (None where the program recorded none or the
    run has no device spans)."""
    if not program or t.device != "cuda" or not t.spans.device:
        return None
    ms = layer_ms(t.spans.device, align(t.spans.device, program),
                  t.wall_plain_s, t.busy_s, t.samples)
    return None if ms is None else ms[layer]
