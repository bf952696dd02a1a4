"""Device discovery and the render mesh.

Port of `opencl_path_tracer_tpu/parallel/mesh.py`: the reference
enumerates the OpenCL platforms and devices and dumps their attributes
at startup (list_info, main.cpp:389-455), then picks platform[0] and
device[0] (main.cpp:466,476). Here the device table is PyTorch's CUDA
devices, or the CPU when the caller asks for it, and `make_render_mesh`
builds the 1-D `torch.distributed.device_mesh.DeviceMesh` that the
framebuffer or the sample batch shards along (`parallel/shard.py`).

The JAX package drives its mesh from one process; the port runs one
process per rank, PyTorch's idiom, which keeps each GPU's launches on a
host thread of its own: `parallel.launch.launch` starts the ranks (NCCL
on GPUs, one rank a GPU; gloo on the CPU) and the mesh spans the world
they form.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from opencl_path_tracer_tpu_torch.utils.device import resolve_device

RENDER_AXIS = "d"


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


def make_render_mesh(num_devices: int | None = None,
                     device_type: str | None = None):
    """The 1-D DeviceMesh over the initialized world, its one dimension
    named RENDER_AXIS. num_devices: None (or 0) takes the world; a count
    must equal the world's size (the JAX package slices its device list;
    here the launcher sizes the world). Raises outside a world
    (`parallel.launch.launch` starts one). device_type: the ranks'
    ('cuda' or 'cpu'); None takes 'cuda' where this process has
    initialized CUDA."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError(
            "make_render_mesh needs an initialized torch.distributed world: "
            "start the ranks with opencl_path_tracer_tpu_torch.parallel."
            "launch.launch (CLI: ptx-torch render --devices N)")
    world = dist.get_world_size()
    if num_devices and num_devices != world:
        raise ValueError(f"a mesh of {num_devices} devices asked for in a "
                         f"world of {world} ranks; launch {num_devices} ranks")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_initialized() else "cpu"
    return init_device_mesh(device_type, (world,),
                            mesh_dim_names=(RENDER_AXIS,))
