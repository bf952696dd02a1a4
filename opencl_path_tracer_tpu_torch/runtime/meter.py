"""1 Hz performance meter.

Port of `opencl_path_tracer_tpu/runtime/meter.py`: the reference's
stdout meter (onIdle, main.cpp:1230-1237) with Samples, Samples/sec,
Render time ms, the real_time flag, Iterations and the elapsed seconds,
and Mrays/sec when the caller passes a ray count. Its line is the JAX
package's, character for character.
"""

from __future__ import annotations

import sys
import time


class PerfMeter:
    def __init__(self, interval: float = 1.0, stream=None) -> None:
        self.interval = interval
        self.stream = stream if stream is not None else sys.stderr
        self.reset()

    def reset(self) -> None:
        self._begin = time.monotonic()
        self._start = self._begin
        self._old_sample = 0
        self._old_rays = 0.0
        self.last_samples_per_sec = 0.0
        self.last_mrays_per_sec = 0.0

    def tick(self, current_sample: int, *, iterations: int = 1,
             real_time: bool = True, rays_traced: float = 0.0) -> bool:
        """Call once per frame; prints at most once per interval. Returns
        True when it printed a line."""
        now = time.monotonic()
        elapsed = now - self._begin
        if elapsed <= self.interval:
            return False
        dsamples = current_sample - self._old_sample
        self.last_samples_per_sec = dsamples / elapsed
        ms_per_sample = (elapsed / dsamples * 1000.0 if dsamples
                         else float("inf"))
        line = (f"Samples={current_sample:010d}  "
                f"Samples/sec={self.last_samples_per_sec:08.3f} "
                f"Render time={ms_per_sample:08.3f}ms  "
                f"real_time={int(real_time)}  "
                f"Iterations={iterations:02d}  "
                f"Elapsed seconds={now - self._start:f}")
        if rays_traced:
            drays = rays_traced - self._old_rays
            self.last_mrays_per_sec = drays / elapsed / 1e6
            line += f"  Mrays/sec={self.last_mrays_per_sec:08.2f}"
            self._old_rays = rays_traced
        print("\r" + line, end="", file=self.stream, flush=True)
        self._begin = now
        self._old_sample = current_sample
        return True
