"""Utilities: profiling, logging, determinism checks and device choice.

Port of `opencl_path_tracer_tpu/utils/`: `trace_profile` and
`device_timer` (`profiling.py`), `get_logger` (`logging.py`),
`check_deterministic` (`determinism.py`) and the scalar `prog.cl`
oracle (`oracle.py`, the tests' and the smoke's independent reference).
`device.py` (`resolve_device`) has no JAX counterpart.

`utils/constlift.py` has no counterpart: it rewrites a jitted JAX
function's jaxpr so that the scene arrays its closure captures enter as
arguments instead of literals embedded in the compiled module (whose
size otherwise grows with the scene). The port has no tracing compiler:
its closures hold device tensors that each launch reads by pointer, so
nothing grows with the scene.
"""

from opencl_path_tracer_tpu_torch.utils.determinism import check_deterministic
from opencl_path_tracer_tpu_torch.utils.logging import get_logger
from opencl_path_tracer_tpu_torch.utils.profiling import (
    device_timer, trace_profile,
)

__all__ = ["trace_profile", "device_timer", "get_logger",
           "check_deterministic"]
