"""Device discovery.

Port of `describe_devices` of `opencl_path_tracer_tpu/parallel/mesh.py`:
the reference enumerates the OpenCL platforms and devices and dumps
their attributes at startup (list_info, main.cpp:389-455); here the
device table is PyTorch's CUDA devices, or the CPU when the caller asks
for it. `make_render_mesh` (several devices) is still to port
(ROADMAP.md queue 1, `parallel/mesh.py` + `parallel/shard.py`).
"""

from __future__ import annotations

import torch

from opencl_path_tracer_tpu_torch.utils.device import resolve_device


def describe_devices(verbose: bool = True, device=None) -> list[dict]:
    """One row per device: id, platform ('gpu' or 'cpu'), kind (the CUDA
    device name, or 'cpu'), process (0) and bytes_limit (the CUDA
    device's total memory, None for the CPU). Lists every CUDA device
    unless device='cpu'; raises when CUDA is asked for and no GPU is
    present."""
    dev = resolve_device(device)
    rows = []
    if dev.type == "cuda":
        for i in range(torch.cuda.device_count()):
            props = torch.cuda.get_device_properties(i)
            rows.append({"id": i, "platform": "gpu",
                         "kind": torch.cuda.get_device_name(i),
                         "process": 0, "bytes_limit": props.total_memory})
    else:
        rows.append({"id": 0, "platform": "cpu", "kind": "cpu",
                     "process": 0, "bytes_limit": None})
    if verbose:
        for row in rows:
            print(f"{row['id'] + 1}. Device: {row['kind']}"
                  f" (platform={row['platform']},"
                  f" process={row['process']})")
    return rows
