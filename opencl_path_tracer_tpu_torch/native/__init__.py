"""ctypes bindings for the native host runtime (C++).

Port of `opencl_path_tracer_tpu/native/__init__.py`: `available`,
`load_obj_native` (objloader.cpp, the twin of `io/obj.py`'s loader) and
`build_median_tree_native` (bvh_builder.cpp, the twin of
`accel/median_tree.py`'s split='median'). The sources are the port's own
copies beside this file (bvh_builder.cpp adapted so its tree equals the
Python builder's bit for bit; its header says how). They are compiled
at first use with `g++ -O3 -fPIC -std=c++17 -shared` (no -march=native:
the library does not depend on the machine that built it) into
`_build/`, named by a hash of the sources and flags, as
`ops/kernels/_build.py` names the CUDA libraries. A failed build raises
with the compiler's output; nothing falls back to Python.
`available()` is False only where there is no g++.
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

import numpy as np

from opencl_path_tracer_tpu_torch.accel.types import BVH, finalize_bvh

HERE = pathlib.Path(__file__).resolve().parent
SOURCES = ("objloader.cpp", "bvh_builder.cpp")
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]
BUILD_DIR = HERE.parent / "_build"
build_info = {"seconds": 0.0}
_LIB = None
_lock = threading.Lock()


def available() -> bool:
    """Whether the library can be built here (a g++ on PATH)."""
    return shutil.which("g++") is not None


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in SOURCES:
        h.update((HERE / src).read_bytes())
    return BUILD_DIR / f"libptx_native_{h.hexdigest()[:16]}.so"


def _build(path: pathlib.Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("the native library needs g++, which is not on "
                           "PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, "-o", str(tmp), *(str(HERE / s) for s in SOURCES)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build the native library:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    build_info["seconds"] = time.perf_counter() - t0


def _load():
    global _LIB
    with _lock:
        if _LIB is not None:
            return _LIB
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        P, I = ctypes.c_void_p, ctypes.c_int
        IP = ctypes.POINTER(ctypes.c_int)
        lib.ptx_load_obj.restype = P
        lib.ptx_load_obj.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.ptx_mesh_error.restype = ctypes.c_char_p
        lib.ptx_mesh_error.argtypes = [P]
        lib.ptx_mesh_counts.argtypes = [P] + [IP] * 5
        lib.ptx_mesh_vertices.argtypes = [P, P]
        lib.ptx_shape_tri_count.restype = I
        lib.ptx_shape_tri_count.argtypes = [P, I]
        lib.ptx_shape_name.restype = ctypes.c_char_p
        lib.ptx_shape_name.argtypes = [P, I]
        lib.ptx_shape_indices.argtypes = [P, I, P, P]
        lib.ptx_material_name.restype = ctypes.c_char_p
        lib.ptx_material_name.argtypes = [P, I]
        lib.ptx_material.argtypes = [P, I, P, P]
        lib.ptx_mesh_free.argtypes = [P]
        lib.ptx_build_bvh.restype = P
        lib.ptx_build_bvh.argtypes = [P, P, P, I, I]
        lib.ptx_bvh_counts.argtypes = [P] + [IP] * 3
        lib.ptx_bvh_data.argtypes = [P, P, P, P]
        lib.ptx_bvh_free.argtypes = [P]
        _LIB = lib
        return lib


def load_obj_native(path: str, mtl_dir: str | None = None):
    """Native twin of io.obj.load_obj: (attrib, shapes, materials) with the
    same dataclasses, filled as the JAX package's native loader fills them:
    the vertices (no normals or texture coordinates), each shape's name,
    vertex indices and material ids, and the materials' name, Kd, Ks, Ke,
    Ns and the reference's Kn, Kk and Tp."""
    from opencl_path_tracer_tpu_torch.io.obj import Attrib, MtlMaterial, Shape

    lib = _load()
    handle = lib.ptx_load_obj(str(path).encode(),
                              (mtl_dir or "").encode() or None)
    try:
        err = lib.ptx_mesh_error(handle).decode()
        if err:
            raise FileNotFoundError(err)
        counts = [ctypes.c_int() for _ in range(5)]
        lib.ptx_mesh_counts(handle, *(ctypes.byref(x) for x in counts))
        nv, _, _, nshapes, nmats = (x.value for x in counts)
        verts = np.zeros((nv, 3), np.float32)
        if nv:
            lib.ptx_mesh_vertices(handle, verts.ctypes.data)
        attrib = Attrib(vertices=verts,
                        normals=np.zeros((0, 3), np.float32),
                        texcoords=np.zeros((0, 2), np.float32))
        shapes = []
        for s in range(nshapes):
            t = lib.ptx_shape_tri_count(handle, s)
            vidx = np.zeros(3 * t, np.int32)
            mids = np.zeros(t, np.int32)
            if t:
                lib.ptx_shape_indices(handle, s, vidx.ctypes.data,
                                      mids.ctypes.data)
            shapes.append(Shape(
                name=lib.ptx_shape_name(handle, s).decode(),
                vertex_indices=vidx,
                normal_indices=np.full(3 * t, -1, np.int32),
                texcoord_indices=np.full(3 * t, -1, np.int32),
                num_face_vertices=np.full(t, 3, np.int32),
                material_ids=mids))
        materials = []
        for i in range(nmats):
            fbuf = np.zeros(16, np.float32)
            ibuf = np.zeros(4, np.int32)
            lib.ptx_material(handle, i, fbuf.ctypes.data, ibuf.ctypes.data)
            m = MtlMaterial(
                name=lib.ptx_material_name(handle, i).decode(),
                diffuse=tuple(float(x) for x in fbuf[0:3]),
                specular=tuple(float(x) for x in fbuf[3:6]),
                emission=tuple(float(x) for x in fbuf[6:9]),
                shininess=float(fbuf[15]))
            if ibuf[1]:
                m.unknown_parameter["Kn"] = " ".join(
                    repr(float(x)) for x in fbuf[9:12])
            if ibuf[2]:
                m.unknown_parameter["Kk"] = " ".join(
                    repr(float(x)) for x in fbuf[12:15])
            if ibuf[3]:
                m.unknown_parameter["Tp"] = str(int(ibuf[0]))
            materials.append(m)
        return attrib, shapes, materials
    finally:
        lib.ptx_mesh_free(handle)


def build_median_tree_native(tris, *, leaf_size: int = 4) -> BVH:
    """Native twin of accel.median_tree.build_median_tree (split='median'):
    the same BVH, bit for bit, on the triangles' device."""
    lib = _load()
    r1, r2, r3 = (x.cpu().numpy().astype(np.float64)
                  for x in (tris.r1, tris.r2, tris.r3))
    lo = np.ascontiguousarray(np.minimum(np.minimum(r1, r2), r3))
    hi = np.ascontiguousarray(np.maximum(np.maximum(r1, r2), r3))
    mid = np.ascontiguousarray((r1 + r2 + r3) / 3.0)
    handle = lib.ptx_build_bvh(lo.ctypes.data, hi.ctypes.data,
                               mid.ctypes.data, r1.shape[0], leaf_size)
    try:
        nn, pt, dep = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        lib.ptx_bvh_counts(handle, ctypes.byref(nn), ctypes.byref(pt),
                           ctypes.byref(dep))
        nodes = np.zeros((nn.value, 8), np.float32)
        order = np.zeros(pt.value, np.int32)
        pad = np.zeros(pt.value, np.uint8)
        lib.ptx_bvh_data(handle, nodes.ctypes.data, order.ctypes.data,
                         pad.ctypes.data)
        return finalize_bvh(nodes, order.astype(np.int64), pad.astype(bool),
                            tris, depth=dep.value, leaf_size=leaf_size)
    finally:
        lib.ptx_bvh_free(handle)
