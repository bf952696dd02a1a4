"""Build, load and launch the port's CUDA kernels.

No counterpart in `opencl_path_tracer_tpu` (Pallas compiles its kernels
inside `jax.jit`). Each source in `csrc/*.cu` is compiled by its own
`nvcc` process, all started together, into a shared library with a
plain C interface under `_build/`, named by a hash of the sources and
flags, and loaded with ctypes at first use; a source with several entry
points (march.cu, flat.cu, lazy.cu) is built once. Every entry point takes
device pointers, sizes and the CUDA stream, launches on that stream and
returns the launch's `cudaError_t`.

Nothing here runs at import time, and nothing falls back: a wrapper
given CUDA tensors launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

PKG_DIR = pathlib.Path(__file__).resolve().parents[2]
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "--fmad=false",
    "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

P, I, U, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
# Kernel name -> (source file, C symbol, argtypes).
KERNELS = {
    "minarg": ("minarg.cu", "ptx_minarg", [P, P, P, P, I, I, P]),
    # K1's two entries for the checks only: its first kernel (every pair
    # divided), and the kernel counting the pairs that reach the divide
    # and the edge tests.
    "minarg_simt": ("minarg.cu", "ptx_minarg_simt", [P, P, P, P, I, I, P]),
    "minarg_count": ("minarg.cu", "ptx_minarg_count",
                     [P, P, P, P, I, I, P, P]),
    "refine1": ("refine1.cu", "ptx_refine1", [P, P, P, P, P, P, P, P, I, I, P]),
    "spheres": ("spheres.cu", "ptx_spheres", [P, P, P, P, P, P, P, I, I, P]),
    "dense": ("dense.cu", "ptx_dense",
              [P, I, P, P, I, I, I, I, I, I, P, P]),
    "plucker_cand": ("plucker_cand.cu", "ptx_plucker_cand",
                     [P, I, P, P, P, I, I, I, I, P]),
    # K13a's two entries for the checks only: its first (float32-core)
    # kernel, and the kernel counting the edge tests its margin recomputes.
    "plucker_cand_simt": ("plucker_cand.cu", "ptx_plucker_cand_simt",
                          [P, I, P, P, P, I, I, I, P]),
    "plucker_cand_count": ("plucker_cand.cu", "ptx_plucker_cand_count",
                           [P, I, P, P, P, I, I, I, I, P, P]),
    "plucker_refine": ("plucker_refine.cu", "ptx_plucker_refine",
                       [P, I, P, P, P, I, I, P]),
    "fused_step": ("fused_step.cu", "ptx_fused_step",
                   [P, P, P, P, I, P, P, I, U, U, U, I, P]),
    # K21: the megakernel's fast-mode bounce, and its raygen.
    "bounce": ("bounce.cu", "ptx_bounce",
               [P] * 14 + [I] + [P] * 7 + [I, U, U, U, U, F, F, P]),
    "bounce_raygen": ("bounce.cu", "ptx_bounce_raygen",
                      [P, P, P, I, I, I, F, F, U, U, U, P]),
    "anyhit": ("anyhit.cu", "ptx_anyhit",
               [P, I, P, P, P, P, P, I, I, I, I, P]),
    # K7's two entries for the checks only: its first kernel (a group's
    # rows staged for the block), and the kernel counting the tests that
    # reach the divide, the sub-blocks its skip rule lets through, the
    # edge tests reached and the slab and box tests made.
    "anyhit_simt": ("anyhit.cu", "ptx_anyhit_simt",
                    [P, I, P, P, P, P, I, I, P]),
    "anyhit_count": ("anyhit.cu", "ptx_anyhit_count",
                     [P, I, P, P, P, P, P, I, I, I, I, P, P]),
    "tilecull": ("tilecull.cu", "ptx_tilecull",
                 [P, I, P, P, P, P, P, I, I, I, I, P]),
    # K6's two entries for the checks only, as K7's.
    "tilecull_simt": ("tilecull.cu", "ptx_tilecull_simt",
                      [P, I, P, P, P, P, I, I, P]),
    "tilecull_count": ("tilecull.cu", "ptx_tilecull_count",
                       [P, I, P, P, P, P, P, I, I, I, I, P, P]),
    "sphere_table": ("sphere_table.cu", "ptx_sphere_table",
                     [P, P, P, P, P, P, P, P, I, I, P]),
    # K3b's two entries for the checks only: its first kernel (every
    # (ray, sphere) pair), and the kernel counting the box tests made and
    # passed, the pairs whose disc it computed and those with disc > 0.
    "sphere_table_simt": ("sphere_table.cu", "ptx_sphere_table_simt",
                          [P, P, P, P, P, P, P, I, I, P]),
    "sphere_table_count": ("sphere_table.cu", "ptx_sphere_table_count",
                           [P, P, P, P, P, P, P, P, I, I, P, P]),
    "smooth_refine": ("smooth_refine.cu", "ptx_smooth_refine",
                      [P, P, P, P, P, P, P, P, P, P, I, I, P]),
    "pair_cand": ("pair_cand.cu", "ptx_pair_cand",
                  [P, P, P, P, I, I, I, I, I, P]),
    "pair_visit": ("pair_visit.cu", "ptx_pair_visit",
                   [P, P, P, P, P, P, I, I, I, I, I, P]),
    # K10's full form (five streams: t, the winner's normal, m * 2 + pend).
    "pair_visit_full": ("pair_visit.cu", "ptx_pair_visit_full",
                        [P, P, P, P, P, P, P, P, P, I, I, I, I, I, P]),
    # K10's two entries for the checks only: its first (float32-core)
    # kernel, and the kernel counting the edge tests its margin recomputes.
    "pair_visit_simt": ("pair_visit.cu", "ptx_pair_visit_simt",
                        [P, P, P, P, P, P, I, I, I, I, P]),
    "pair_visit_count": ("pair_visit.cu", "ptx_pair_visit_count",
                         [P, P, P, P, P, P, I, I, I, I, P, P]),
    "attr_fetch": ("attr_fetch.cu", "ptx_attr_fetch",
                   [P, P, P, P, P, P, I, I, P]),
    "pair_vpu": ("pair_vpu.cu", "ptx_pair_vpu",
                 [P, P, P, P, P, I, I, I, I, P]),
    # K12's two entries for the checks only: its first kernel (every
    # pair, triangle test), and the kernel counting the tests that reach
    # the divide, the sub-blocks its skip rule lets through and the edge
    # tests reached.
    "pair_vpu_simt": ("pair_vpu.cu", "ptx_pair_vpu_simt",
                      [P, P, P, P, I, I, I, P]),
    "pair_vpu_count": ("pair_vpu.cu", "ptx_pair_vpu_count",
                       [P, P, P, P, P, I, I, I, I, P, P]),
    "cluster": ("cluster.cu", "ptx_cluster",
                [P, P, P, P, P, P, P, I, I, I, I, I, I, P]),
    # K17's two entries for the checks only, as K7's.
    "cluster_simt": ("cluster.cu", "ptx_cluster_simt",
                     [P, P, P, P, P, P, I, I, I, I, I, P]),
    "cluster_count": ("cluster.cu", "ptx_cluster_count",
                      [P, P, P, P, P, P, P, I, I, I, I, I, I, P, P]),
    "group": ("group.cu", "ptx_group", [P, P, P, P, P, I, I, I, I, I, P]),
    # K16's two entries for the checks only, as K7's.
    "group_simt": ("group.cu", "ptx_group_simt",
                   [P, P, P, P, I, I, I, I, P]),
    "group_count": ("group.cu", "ptx_group_count",
                    [P, P, P, P, P, I, I, I, I, I, P, P]),
    "march": ("march.cu", "ptx_march", [P, P, P, P, P, P, I, I, I, I, P]),
    # K18's two entries for the checks only: its first (float32-core)
    # body, and the kernel counting the edge tests its margin recomputes.
    "march_simt": ("march.cu", "ptx_march_simt",
                   [P, P, P, P, P, P, I, I, I, I, P]),
    "march_count": ("march.cu", "ptx_march_count",
                    [P, P, P, P, P, P, I, I, I, I, P, P]),
    "materialize": ("materialize.cu", "ptx_materialize",
                    [P, P, P, P, P, P, I, I, I, P]),
    "flat_march": ("flat.cu", "ptx_flat",
                   [P, I, P, P, P, P, P, P, P, P, P, I, I, I, P]),
    # K19's two entries for the checks only: its first (float32-core,
    # one block per segment) kernel, and the kernel counting the edge
    # tests its margin recomputes.
    "flat_march_simt": ("flat.cu", "ptx_flat_simt",
                        [P, P, P, P, P, P, P, P, I, I, I, P]),
    "flat_march_count": ("flat.cu", "ptx_flat_count",
                         [P, I, P, P, P, P, P, P, P, P, P, I, I, I, P, P]),
    "lazy_march": ("lazy.cu", "ptx_lazy",
                   [P, P, P, P, P, P, P, P, P, I, I, I, I, I, P]),
    # K20's two entries for the checks only, as K19's.
    "lazy_march_simt": ("lazy.cu", "ptx_lazy_simt",
                        [P, P, P, P, P, P, P, P, P, I, I, I, I, I, P]),
    "lazy_march_count": ("lazy.cu", "ptx_lazy_count",
                         [P, P, P, P, P, P, P, P, P, I, I, I, I, I, P, P]),
    "minarg_fused": ("minarg_fused.cu", "ptx_minarg_fused",
                     [P, P, P, P, P, P, P, P, P, I, I, I, P]),
    # K14's two entries for the checks only, as K7's.
    "minarg_fused_simt": ("minarg_fused.cu", "ptx_minarg_fused_simt",
                          [P, P, P, P, P, P, P, I, I, P]),
    "minarg_fused_count": ("minarg_fused.cu", "ptx_minarg_fused_count",
                           [P, P, P, P, P, P, P, P, P, I, I, I, P, P]),
    "mxu": ("mxu.cu", "ptx_mxu", [P, P, P, P, I, I, I, P]),
    # K15's two entries for the checks only, as K7's.
    "mxu_simt": ("mxu.cu", "ptx_mxu_simt", [P, P, P, I, I, P]),
    "mxu_count": ("mxu.cu", "ptx_mxu_count", [P, P, P, P, I, I, I, P, P]),
}

# Launches per kernel since the last reset_launches(); each wrapper adds
# one where it launches its kernel and nowhere else.
launches = {name: 0 for name in KERNELS}

_lock = threading.Lock()
_loaded: dict[str, object] = {}
build_info: dict[str, object] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "csrc/ at first use and need the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> dict[str, pathlib.Path]:
    """Compile every source (in parallel) unless its library for this
    hash exists. Returns kernel name -> library path; records the build
    time and nvcc's register and shared-memory report (by source) in
    `build_info`."""
    digest = _digest()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    srcs = sorted({src for src, _, _ in KERNELS.values()})
    libs = {src: BUILD_DIR / f"lib{src[:-3]}_{digest}.so" for src in srcs}
    todo = [src for src, p in libs.items() if not p.exists()]
    t0 = time.perf_counter()
    if todo:
        nvcc = nvcc_path()
        procs = {}
        for src in todo:
            tmp = libs[src].with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / src)]
            procs[src] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for src, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src}:\n{out}")
            else:
                libs[src].with_suffix(".log").write_text(out)
                os.replace(tmp, libs[src])
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    build_info["seconds"] = time.perf_counter() - t0
    build_info["built"] = todo
    build_info["ptxas"] = {
        src: path.with_suffix(".log").read_text()
        for src, path in libs.items() if path.with_suffix(".log").exists()}
    return {name: libs[src] for name, (src, _, _) in KERNELS.items()}


def library(name: str):
    """The loaded ctypes function for kernel `name` (builds on first use)."""
    with _lock:
        if name not in _loaded:
            libs = build()
            for kname, path in libs.items():
                if kname in _loaded:
                    continue
                lib = ctypes.CDLL(str(path))
                fn = getattr(lib, KERNELS[kname][1])
                fn.argtypes = KERNELS[kname][2]
                fn.restype = ctypes.c_int
                _loaded[kname] = fn
        return _loaded[name]


def check(x: torch.Tensor, what: str, shape, dtype=torch.float32) -> None:
    """Raise unless x is a contiguous tensor of `dtype` whose shape
    matches `shape` (None matches any extent)."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{what} must be a tensor")
    if x.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {x.dtype}")
    if x.dim() != len(shape) or any(
            s is not None and s != e for s, e in zip(shape, x.shape)):
        raise ValueError(f"{what} has shape {tuple(x.shape)}, "
                         f"expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} is on {x.device}: CPU or CUDA only")


def check_rows(x: torch.Tensor, what: str, rows: int) -> None:
    """Raise unless x is a (rows, R) float32 tensor whose rows are each
    contiguous; the row stride is free, so a column slice of a wider
    pack passes and is read in place."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{what} must be a tensor")
    if x.dtype != torch.float32:
        raise TypeError(f"{what} must be torch.float32, got {x.dtype}")
    if x.dim() != 2 or x.shape[0] != rows:
        raise ValueError(f"{what} has shape {tuple(x.shape)}, expected "
                         f"({rows}, R)")
    if x.shape[1] > 1 and x.stride(1) != 1:
        raise ValueError(f"{what} must have contiguous rows")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} is on {x.device}: CPU or CUDA only")


def launch(name: str, *args) -> None:
    """Launch kernel `name` on the current stream. Tensor arguments pass
    as device pointers, None as a null pointer, floats as floats and ints
    as ints. Raises on a non-zero cudaError_t."""
    fn = library(name)
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    stream = torch.cuda.current_stream(dev).cuda_stream
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor)
              else a if a is None or isinstance(a, float) else int(a)
              for a in args]
    err = fn(*c_args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")
    launches[name] += 1
