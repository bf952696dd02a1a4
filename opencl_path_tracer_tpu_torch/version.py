"""Package version. Port of `opencl_path_tracer_tpu/version.py`."""

__version__ = "0.1.0"
