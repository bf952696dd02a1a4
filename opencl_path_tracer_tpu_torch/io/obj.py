"""Wavefront OBJ and MTL loader.

Port of `opencl_path_tracer_tpu/io/obj.py` (pure Python there too):
`Attrib`, `Shape`, `MtlMaterial`, `load_mtl` and `load_obj`, in place of
the reference's vendored tinyobjloader (tiny_obj_loader.h, read at
main.cpp:552-617). The data keeps tinyobj's shape: Attrib{vertices,
normals, texcoords}, Shape{name, indices, num_face_vertices,
material_ids}, and MtlMaterial with the standard MTL fields plus the
`unknown_parameter` map that carries the reference's own keys
(main.cpp:568-571):

    Kn  per-channel refractive index  (3 floats)
    Kk  per-channel extinction        (3 floats)
    Tp  material type                 (int: 0 diffuse, 1 specular,
                                       2 refractive, 3 emitter)

tinyobj's behaviour where the reference depends on it:
  * faces with more than three corners are fan-triangulated, and the
    original corner counts are kept in num_face_vertices;
  * shapes split on 'o'/'g' lines; faces before any usemtl get
    material id -1;
  * negative OBJ indices count back from the current vertex count.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class Attrib:
    vertices: np.ndarray   # (V, 3) float32
    normals: np.ndarray    # (VN, 3) float32
    texcoords: np.ndarray  # (VT, 2) float32


@dataclasses.dataclass
class Shape:
    name: str
    # flattened per-face-vertex indices into attrib arrays; -1 = absent
    vertex_indices: np.ndarray    # (F*3,) int32 (triangulated)
    normal_indices: np.ndarray    # (F*3,) int32
    texcoord_indices: np.ndarray  # (F*3,) int32
    num_face_vertices: np.ndarray # (orig_faces,) int32
    material_ids: np.ndarray      # (F,) int32 per triangulated face


@dataclasses.dataclass
class MtlMaterial:
    name: str = ""
    ambient: tuple = (0.0, 0.0, 0.0)
    diffuse: tuple = (0.0, 0.0, 0.0)
    specular: tuple = (0.0, 0.0, 0.0)
    transmittance: tuple = (0.0, 0.0, 0.0)
    emission: tuple = (0.0, 0.0, 0.0)
    shininess: float = 1.0
    ior: float = 1.0
    dissolve: float = 1.0
    illum: int = 0
    diffuse_texname: str = ""
    unknown_parameter: dict = dataclasses.field(default_factory=dict)


def _floats(parts, n):
    vals = [float(x) for x in parts[:n]]
    while len(vals) < n:
        vals.append(0.0)
    return tuple(vals)


def load_mtl(path: str) -> list[MtlMaterial]:
    """Parse a .mtl file (tiny_obj_loader.h LoadMtl equivalent,
    tiny_obj_loader.h:328,938). Unrecognized keys land in
    unknown_parameter as raw strings, like tinyobj."""
    mats: list[MtlMaterial] = []
    cur: MtlMaterial | None = None
    known = {
        "Ka": ("ambient", 3), "Kd": ("diffuse", 3), "Ks": ("specular", 3),
        "Kt": ("transmittance", 3), "Tf": ("transmittance", 3),
        "Ke": ("emission", 3),
    }
    with open(path, "r", errors="replace") as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            key, rest = parts[0], parts[1:]
            if key == "newmtl":
                cur = MtlMaterial(name=" ".join(rest))
                mats.append(cur)
                continue
            if cur is None:
                continue
            if key in known:
                attr, n = known[key]
                setattr(cur, attr, _floats(rest, n))
            elif key == "Ns":
                cur.shininess = float(rest[0])
            elif key == "Ni":
                cur.ior = float(rest[0])
            elif key in ("d",):
                cur.dissolve = float(rest[0])
            elif key == "Tr":
                cur.dissolve = 1.0 - float(rest[0])
            elif key == "illum":
                cur.illum = int(rest[0])
            elif key == "map_Kd":
                cur.diffuse_texname = " ".join(rest)
            else:
                # Custom keys (Kn/Kk/Tp) ride here, raw-string valued,
                # exactly how the reference reads them (main.cpp:568-571).
                cur.unknown_parameter[key] = " ".join(rest)
    return mats


def _parse_index(token: str, counts):
    """'v', 'v/vt', 'v//vn', 'v/vt/vn' with negative-index support."""
    vals = [-1, -1, -1]
    for i, piece in enumerate(token.split("/")[:3]):
        if piece:
            idx = int(piece)
            vals[i] = idx - 1 if idx > 0 else counts[i] + idx
    return vals


def load_obj(path: str, mtl_dir: str | None = None):
    """Parse an OBJ file.

    Returns (attrib, shapes, materials) mirroring tinyobj::LoadObj
    (tiny_obj_loader.h:302,1349). Raises FileNotFoundError / ValueError on
    unreadable input (the reference exits on load failure, main.cpp:560 —
    callers decide)."""
    if mtl_dir is None:
        mtl_dir = os.path.dirname(path)

    vertices: list = []
    normals: list = []
    texcoords: list = []
    materials: list[MtlMaterial] = []
    mat_name_to_id: dict[str, int] = {}

    shapes: list[Shape] = []
    cur_name = ""
    cur_v: list = []
    cur_n: list = []
    cur_t: list = []
    cur_nfv: list = []
    cur_mids: list = []
    cur_mat = -1

    def flush():
        nonlocal cur_v, cur_n, cur_t, cur_nfv, cur_mids
        if cur_v:
            shapes.append(Shape(
                name=cur_name,
                vertex_indices=np.asarray(cur_v, np.int32),
                normal_indices=np.asarray(cur_n, np.int32),
                texcoord_indices=np.asarray(cur_t, np.int32),
                num_face_vertices=np.asarray(cur_nfv, np.int32),
                material_ids=np.asarray(cur_mids, np.int32),
            ))
        cur_v, cur_n, cur_t, cur_nfv, cur_mids = [], [], [], [], []

    with open(path, "r", errors="replace") as fh:
        for line in fh:
            if line.endswith("\\\n"):  # line continuation
                line = line[:-2] + " "
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            key, rest = parts[0], parts[1:]
            if key == "v":
                vertices.append(_floats(rest, 3))
            elif key == "vn":
                normals.append(_floats(rest, 3))
            elif key == "vt":
                texcoords.append(_floats(rest, 2))
            elif key == "f":
                counts = (len(vertices), len(texcoords), len(normals))
                idx = [_parse_index(tok, counts) for tok in rest]
                if len(idx) < 3:
                    continue
                cur_nfv.append(len(idx))
                # Fan triangulation (reference assumes already-triangular
                # faces; fan is the tinyobj triangulate=true behavior).
                for k in range(1, len(idx) - 1):
                    for j in (0, k, k + 1):
                        v, t, n = idx[j]
                        cur_v.append(v)
                        cur_t.append(t)
                        cur_n.append(n)
                    cur_mids.append(cur_mat)
            elif key in ("o", "g"):
                flush()
                cur_name = " ".join(rest)
            elif key == "usemtl":
                name = " ".join(rest)
                cur_mat = mat_name_to_id.get(name, -1)
            elif key == "mtllib":
                for mtl_name in rest:
                    mtl_path = os.path.join(mtl_dir, mtl_name)
                    if os.path.exists(mtl_path):
                        for m in load_mtl(mtl_path):
                            mat_name_to_id[m.name] = len(materials)
                            materials.append(m)
            # s (smoothing), l (lines), p (points) ignored.
    flush()

    attrib = Attrib(
        vertices=np.asarray(vertices, np.float32).reshape(-1, 3),
        normals=np.asarray(normals, np.float32).reshape(-1, 3),
        texcoords=np.asarray(texcoords, np.float32).reshape(-1, 2),
    )
    return attrib, shapes, materials
