"""Device discovery and multi-device rendering (`mesh.py`, `shard.py`,
the rank launcher `launch.py`)."""

from opencl_path_tracer_tpu_torch.parallel.mesh import (
    describe_devices, make_render_mesh,
)
from opencl_path_tracer_tpu_torch.parallel.shard import (
    gather_colors, make_sample_sharded_render, make_tiled_step,
    make_tiled_wavefront_step,
)

__all__ = [
    "describe_devices",
    "make_render_mesh",
    "make_tiled_step",
    "make_tiled_wavefront_step",
    "make_sample_sharded_render",
    "gather_colors",
]
