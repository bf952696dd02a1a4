"""Profiling helpers, and the port's own spans and counters.

Port of `opencl_path_tracer_tpu/utils/profiling.py`. The reference's
only tracing is a 1 Hz printf meter (main.cpp:1230-1237). Here:

- `trace_profile(logdir)` records a `torch.profiler` trace of the
  enclosed block, every activity this build of PyTorch supports (the
  CUDA kernels' spans on a GPU build), and writes it under `logdir` as
  a Chrome trace (`trace_<ms since the epoch>_<pid>.json`; open it in
  Perfetto or chrome://tracing), with the program's spans of the block
  on a track of their own ("program spans"). It is the counterpart of
  the JAX package's `jax.profiler` trace for XProf.
- `device_timer(fn, *args)` is the JAX package's contract: wall-clock
  seconds a call, each call ending in one dependent scalar fetch built
  from the first element of every output tensor, so the clock waits for
  the device (CUDA launches return before their kernels finish).

The recorder (no JAX counterpart): `span(name)` is a context manager
that keeps one record in memory (name, start and end ns, the id of the
enclosing span on the same thread, the engine's sample index), and
`count(name, n)` a host counter. Both do nothing while the recorder is
off. It is on inside `tracing()` and while a `torch.profiler` profile
records (`torch.autograd._profiler_enabled()`); `refresh()` reads that
once, and the engine calls it at the start of every `render`, `frame`
and `display_u8`, so a site costs one flag check when off: it enqueues
nothing and reads nothing from the device. Set-up spans
(`span(..., force=True)`: the scene build, the engine's construction
and its calibration sample) are recorded on or off. Counts that need a
device read (the intersect schedules' resolved, pending and tail rays)
are kept only inside `tracing(device_counts=True)`, since the read is
itself a host read. The store holds at most `MAX_RECORDS` spans; spans
past it are dropped and counted (`spans.dropped`).

Timestamps are `time.time_ns()`, the clock of torch.profiler's host
events (Kineto reports them in ns since the Unix epoch), so a span can
be laid against the device's kernels of the same profile. Its device
events shared that clock to about 10 µs on most H100 machines and were
up to 0.4 ms off on one (PERF.md); `benchmark/attribution.py` aligns
the two from the blocking reads.
The span names, the counters and the metrics that read them are listed
in PERF.md section 3. Records are not written as `record_function`
ranges: the profiler would project those onto the device's timeline.
"""

from __future__ import annotations

import array
import collections
import contextlib
import dataclasses
import json
import os
import threading
import time

import torch

from opencl_path_tracer_tpu_torch.utils.determinism import (
    tree_leaves_with_path,
)

MAX_RECORDS = 1 << 20
# The Chrome trace's process id of the program's spans (a track apart
# from the profiler's host and device threads).
SPAN_PID = 2 ** 31 - 2


@dataclasses.dataclass(frozen=True)
class Span:
    """One closed span: its id (its index in the store), name, start and
    end (ns on time.time_ns()'s clock), the enclosing span's id (-1: none
    on its thread) and the engine's sample index (-1: none yet)."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: int
    sample: int


class Recorder:
    """The spans and counters of one process (the module's docstring)."""

    def __init__(self, max_records: int = MAX_RECORDS) -> None:
        self.max_records = max_records
        self.on = False
        self.sample = -1
        self._forced = 0
        self._device_counts = 0
        self._local = threading.local()
        self.reset()

    def reset(self) -> None:
        """Forget every span and counter."""
        self._names: list = []
        self._start = array.array("q")
        self._end = array.array("q")
        self._parent = array.array("q")
        self._sample = array.array("q")
        self._counters: collections.Counter = collections.Counter()

    def refresh(self) -> bool:
        """On inside tracing() or while torch.profiler records."""
        self.on = bool(self._forced) or torch.autograd._profiler_enabled()
        return self.on

    def device_counts(self) -> bool:
        return self.on and self._device_counts > 0

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _open(self, name: str, parent: int) -> int:
        """A new record's id, or -1 (dropped and counted) when full."""
        i = len(self._names)
        if i >= self.max_records:
            self._counters["spans.dropped"] += 1
            return -1
        self._names.append(name)
        self._parent.append(parent)
        self._sample.append(self.sample)
        self._end.append(0)
        self._start.append(time.time_ns())
        return i

    def _close(self, i: int) -> None:
        if 0 <= i < len(self._end):
            self._end[i] = time.time_ns()

    def spans(self) -> list:
        """Every closed span, in the order they opened."""
        return [Span(i, self._names[i], self._start[i], self._end[i],
                     self._parent[i], self._sample[i])
                for i in range(len(self._names)) if self._end[i]]

    def counters(self) -> collections.Counter:
        return collections.Counter(self._counters)


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _OpenSpan:
    __slots__ = ("rec", "name", "id")

    def __init__(self, rec: Recorder, name: str, sample) -> None:
        self.rec, self.name = rec, name
        if sample is not None:
            rec.sample = int(sample)

    def __enter__(self):
        st = self.rec._stack()
        self.id = self.rec._open(self.name, st[-1] if st else -1)
        st.append(self.id)
        return self

    def __exit__(self, *exc):
        self.rec._close(self.id)
        self.rec._stack().pop()
        return False


RECORDER = Recorder()


def span(name: str, sample=None, force: bool = False):
    """A context manager that records `name` around its block when the
    recorder is on (or force=True, for set-up spans). sample: the
    engine's sample index, kept by this span and every later one until
    another span sets it."""
    rec = RECORDER
    if not (rec.on or force):
        return _NULL
    return _OpenSpan(rec, name, sample)


def count(name: str, n: int = 1) -> None:
    """Add n to the host counter `name` when the recorder is on."""
    rec = RECORDER
    if rec.on:
        rec._counters[name] += n


def isect_read(x: torch.Tensor, site: str):
    """x.item(), an intersect schedule's blocking device read: the span
    isect.host_read around it, counted as host_reads.isect.<site>."""
    with span("isect.host_read"):
        v = x.item()
    count("host_reads.isect." + site)
    return v


def refresh() -> bool:
    """Turn the recorder on or off by tracing() and torch.profiler."""
    return RECORDER.refresh()


def device_counts() -> bool:
    """Whether counts that need a device read are wanted (inside
    tracing(device_counts=True))."""
    return RECORDER.device_counts()


def spans() -> list:
    return RECORDER.spans()


def counters() -> collections.Counter:
    return RECORDER.counters()


def reset() -> None:
    RECORDER.reset()


@contextlib.contextmanager
def tracing(device_counts: bool = False):
    """Turn the recorder on for the block (and device-valued counts with
    device_counts=True); yields the recorder."""
    rec = RECORDER
    rec._forced += 1
    rec._device_counts += int(device_counts)
    rec.refresh()
    try:
        yield rec
    finally:
        rec._forced -= 1
        rec._device_counts -= int(device_counts)
        rec.refresh()


def self_ns(spans_: list) -> dict:
    """{span id: its duration less the time its child spans cover}."""
    out = {s.id: s.end_ns - s.start_ns for s in spans_}
    for s in spans_:
        if s.parent in out:
            out[s.parent] -= s.end_ns - s.start_ns
    return out


def self_ms_per_sample(spans_: list, samples: float) -> dict:
    """{span name: its spans' summed self time in ms / samples}."""
    own = self_ns(spans_)
    by = collections.Counter()
    for s in spans_:
        by[s.name] += own[s.id]
    return {name: ns / 1e6 / samples for name, ns in sorted(by.items())}


def seconds_by_name(spans_: list) -> dict:
    """{span name: its spans' summed duration in seconds}."""
    by = collections.Counter()
    for s in spans_:
        by[s.name] += s.end_ns - s.start_ns
    return {name: ns / 1e9 for name, ns in sorted(by.items())}


def _add_spans(path: str, spans_: list) -> None:
    """Write spans_ into the Chrome trace at path as complete events of
    their own process, on the trace's clock (its ts are µs after
    baseTimeNanoseconds where the trace gives one)."""
    with open(path) as fh:
        trace = json.load(fh)
    base = int(trace.get("baseTimeNanoseconds", 0))
    events = trace.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "process_name", "pid": SPAN_PID,
                   "tid": 0, "args": {"name": "program spans"}})
    for s in spans_:
        events.append({"ph": "X", "cat": "program", "name": s.name,
                       "pid": SPAN_PID, "tid": 0,
                       "ts": (s.start_ns - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"id": s.id, "parent": s.parent,
                                "sample": s.sample}})
    with open(path, "w") as fh:
        json.dump(trace, fh)


@contextlib.contextmanager
def trace_profile(logdir: str):
    """Capture a torch.profiler trace of the enclosed block into a JSON
    file under `logdir` (created if missing), with the program's spans
    of the block; written when the block ends, also when it raises."""
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(
        logdir, f"trace_{int(time.time() * 1e3)}_{os.getpid()}.json")
    prof = torch.profiler.profile(
        activities=list(torch.profiler.supported_activities()))
    prof.start()
    refresh()
    t0 = time.time_ns()
    try:
        yield
    finally:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()
        refresh()
        prof.export_chrome_trace(path)
        _add_spans(path, [s for s in spans() if s.start_ns >= t0])


def _scalarize(out):
    """The sum of the first element of every output tensor, as float32:
    one value that depends on every output."""
    return sum(leaf.reshape(-1)[:1].to(torch.float32).sum()
               for _, leaf in tree_leaves_with_path(out)
               if isinstance(leaf, torch.Tensor))


def device_timer(fn, *args, iters: int = 5, warmup: int = 1) -> float:
    """Wall-clock fn(*args) with a dependent scalar fetch per call.
    Returns seconds per call (including one device-to-host round trip)."""
    for _ in range(warmup):
        float(_scalarize(fn(*args)))
    t0 = time.time()
    for _ in range(iters):
        float(_scalarize(fn(*args)))
    return (time.time() - t0) / iters
