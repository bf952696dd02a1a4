"""Acceleration structures: the flat BVH format, its builders (the host
median tree, the device LBVH) and the walker; the Morton codes.

Port of `opencl_path_tracer_tpu/accel/__init__.py`."""

from opencl_path_tracer_tpu_torch.accel.types import BVH
from opencl_path_tracer_tpu_torch.accel.median_tree import build_median_tree
from opencl_path_tracer_tpu_torch.accel.lbvh import build_lbvh, morton3
from opencl_path_tracer_tpu_torch.accel.traverse import make_bvh_intersect

__all__ = [
    "BVH", "build_median_tree", "build_lbvh", "morton3",
    "make_bvh_intersect",
]
