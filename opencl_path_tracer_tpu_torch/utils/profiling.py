"""Profiling helpers.

Port of `opencl_path_tracer_tpu/utils/profiling.py`. The reference's
only tracing is a 1 Hz printf meter (main.cpp:1230-1237). Here:

- `trace_profile(logdir)` records a `torch.profiler` trace of the
  enclosed block, every activity this build of PyTorch supports (the
  CUDA kernels' spans on a GPU build), and writes it under `logdir` as
  a Chrome trace (`trace_<ms since the epoch>_<pid>.json`; open it in
  Perfetto or chrome://tracing). It is the counterpart of the JAX
  package's `jax.profiler` trace for XProf.
- `device_timer(fn, *args)` is the JAX package's contract: wall-clock
  seconds a call, each call ending in one dependent scalar fetch built
  from the first element of every output tensor, so the clock waits for
  the device (CUDA launches return before their kernels finish).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from opencl_path_tracer_tpu_torch.utils.determinism import (
    tree_leaves_with_path,
)


@contextlib.contextmanager
def trace_profile(logdir: str):
    """Capture a torch.profiler trace of the enclosed block into a JSON
    file under `logdir` (created if missing); written when the block
    ends, also when it raises."""
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(
        logdir, f"trace_{int(time.time() * 1e3)}_{os.getpid()}.json")
    prof = torch.profiler.profile(
        activities=list(torch.profiler.supported_activities()))
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(path)


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
