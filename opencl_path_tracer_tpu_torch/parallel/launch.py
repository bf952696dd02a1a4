"""Start a world of ranks for multi-device rendering.

No counterpart in `opencl_path_tracer_tpu` (one JAX process drives every
device of a `jax.sharding.Mesh`). The port runs one process per rank:
`launch(fn, world_size, args)` starts `world_size` processes with
`torch.multiprocessing.spawn`, each of which joins the world and calls
`fn(*args)`, and returns their return values in rank order.

- Rendezvous through a `file://` store in a fresh temporary directory,
  so no port is chosen.
- Rank k runs on `cuda:k` with NCCL, one rank a GPU, or on the CPU with
  gloo. The backend follows the device unless the caller names it: gloo
  on CUDA puts rank k on `cuda:(k mod the GPU count)`, which lets two
  ranks share one card (NCCL refuses that). No other backend is tried
  when one fails.
- On CUDA the kernels are built in this process before the ranks start
  (`ops/kernels/_build.py` renames each library into place), so the
  ranks load them and none runs `nvcc`.
- A rank's exception fails the launch: `spawn` ends the other ranks and
  raises it here, with the rank's traceback.

`fn` and `args` go to the ranks by pickling, so `fn` is a module-level
function; its return value comes back the same way, so it returns host
values (numbers, numpy arrays), not CUDA tensors.
"""

from __future__ import annotations

import os
import pickle
import tempfile

import torch
import torch.distributed as dist

from opencl_path_tracer_tpu_torch.utils.device import resolve_device

BACKENDS = ("nccl", "gloo")


def launch(fn, world_size: int, args=(), device=None,
           backend: str | None = None) -> list:
    """fn(*args) on each of world_size ranks, in one world; returns the
    ranks' return values, rank 0 first. device: 'cuda' (the default) or
    'cpu'; backend: 'nccl' or 'gloo', by default NCCL on CUDA and gloo on
    the CPU. Raises for NCCL on the CPU and for more NCCL ranks than
    GPUs."""
    dev = resolve_device(device)
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; the port has "
                         f"{BACKENDS}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("backend 'nccl' needs CUDA; the CPU ranks "
                             "run 'gloo'")
        if world_size > torch.cuda.device_count():
            raise ValueError(
                f"NCCL runs one rank a GPU: {world_size} ranks asked for, "
                f"{torch.cuda.device_count()} GPUs visible (name "
                "backend='gloo' to share a card)")
    if dev.type == "cuda":
        from opencl_path_tracer_tpu_torch.ops.kernels import _build
        _build.build()
    with tempfile.TemporaryDirectory(prefix="ptx-world-") as tmp:
        torch.multiprocessing.spawn(
            _rank_main, nprocs=world_size, join=True,
            args=(world_size, tmp, dev.type, backend, fn, tuple(args)))
        out = []
        for rank in range(world_size):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as fh:
                out.append(pickle.load(fh))
    return out


def _rank_main(rank: int, world_size: int, tmp: str, device_type: str,
               backend: str, fn, args) -> None:
    """One rank: its device, the world, fn, its result to tmp. The world
    is left as it is when fn raises: the process exits and spawn ends the
    others."""
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        torch.cuda.init()
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(tmp, "rendezvous"),
        world_size=world_size, rank=rank)
    result = fn(*args)
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(result, fh)
