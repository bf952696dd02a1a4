"""The program's own spans and counters, as the per-layer readers take
them: `opencl_path_tracer_tpu_torch.utils.profiling`'s recorder, which
is on while `torch.profiler` records, so it holds the profiled phase of
a traced run (and the engine's set-up spans, recorded always). A tree
whose program has no recorder gives None, and the readers then report
nothing.
"""

from __future__ import annotations

import importlib


def _recorder():
    try:
        mod = importlib.import_module(
            "opencl_path_tracer_tpu_torch.utils.profiling")
    except ImportError:
        return None
    if not (hasattr(mod, "spans") and hasattr(mod, "counters")):
        return None
    return mod


def program_spans() -> list | None:
    """[(name, start µs, end µs)] of every closed span, on the clock of
    torch.profiler's events, or None without a recorder."""
    mod = _recorder()
    if mod is None:
        return None
    return [(s.name, s.start_ns / 1e3, s.end_ns / 1e3) for s in mod.spans()]


def counters() -> dict | None:
    """{name: count} of the recorder's counters, or None without one."""
    mod = _recorder()
    return None if mod is None else dict(mod.counters())


def last_span_s(name: str) -> float | None:
    """Seconds of the latest span called `name` (None: no such span or
    no recorder)."""
    spans = [s for s in program_spans() or () if s[0] == name]
    if not spans:
        return None
    _, s, e = max(spans, key=lambda x: x[1])
    return (e - s) / 1e6
