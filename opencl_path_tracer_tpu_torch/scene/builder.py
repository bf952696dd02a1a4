"""Scene assembly: the host-side builder.

Port of `opencl_path_tracer_tpu/scene/builder.py` (the reference's
`class Scene`, main.cpp:363-742): add_material (:532), add_triangle
(:529) with optional corner normals and texture coordinates, add_obj
(:552) with `_shape_normals` and the `map_Kd` auto-load, end_obj (:536),
add_texture and set_material_texture, with the upload_* calls
(:618-634) collapsed into `build()`, which also assembles the vertex
attributes and the texture atlas (`core.textures.TexturesSoA`).

OBJ import keeps the reference's semantics (main.cpp:552-617): the X
axis is flipped on load (:598); each vertex is rotated about x by pitch,
then about y by yaw, then scaled, then translated (:602-606); MTL
materials take the custom keys Kn, Kk and Tp (:568-571); per-face
material ids are offset by the running material count (:562, :613); and
every OBJ shape closes an object (:615).
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

from opencl_path_tracer_tpu_torch.core.geometry import REF_PI, TrianglesSoA
from opencl_path_tracer_tpu_torch.core.materials import (
    MaterialsSoA, make_material, stack_materials,
)
from opencl_path_tracer_tpu_torch.core.spheres import SpheresSoA
from opencl_path_tracer_tpu_torch.core.textures import TexturesSoA
from opencl_path_tracer_tpu_torch.io.image import read_png
from opencl_path_tracer_tpu_torch.io.obj import load_obj
from opencl_path_tracer_tpu_torch.ops.shading import (
    VertexAttribs, build_vertex_attribs, compute_vertex_normals,
)


def _np_rot_x(v: np.ndarray, deg: float) -> np.ndarray:
    a = np.float32(deg) / np.float32(180.0) * REF_PI
    c, s = np.float32(np.cos(a)), np.float32(np.sin(a))
    out = v.copy()
    out[:, 1] = v[:, 1] * c - v[:, 2] * s
    out[:, 2] = v[:, 1] * s + v[:, 2] * c
    return out


def _np_rot_y(v: np.ndarray, deg: float) -> np.ndarray:
    a = np.float32(deg) / np.float32(180.0) * REF_PI
    c, s = np.float32(np.cos(a)), np.float32(np.sin(a))
    out = v.copy()
    out[:, 0] = v[:, 0] * c + v[:, 2] * s
    out[:, 2] = -v[:, 0] * s + v[:, 2] * c
    return out


@dataclasses.dataclass
class Scene:
    """Triangles and materials as structure-of-arrays tensors, the
    per-object [from, to) triangle ranges, optional analytic spheres,
    optional vertex attributes (present when any triangle carried
    corner normals or texture coordinates; smooth shading and textures
    read them) and optional image textures (present when any image was
    added; the textured intersector samples them)."""

    tris: TrianglesSoA
    mats: MaterialsSoA
    object_ranges: np.ndarray
    spheres: SpheresSoA | None = None
    attribs: VertexAttribs | None = None
    textures: TexturesSoA | None = None

    @property
    def num_triangles(self) -> int:
        return self.tris.count

    @property
    def num_objects(self) -> int:
        return len(self.object_ranges)

    def to(self, device) -> "Scene":
        return Scene(
            tris=self.tris.to(device), mats=self.mats.to(device),
            object_ranges=self.object_ranges,
            spheres=None if self.spheres is None else self.spheres.to(device),
            attribs=None if self.attribs is None else self.attribs.to(device),
            textures=(None if self.textures is None
                      else self.textures.to(device)),
        )


class SceneBuilder:
    def __init__(self) -> None:
        self._r1: list[np.ndarray] = []
        self._r2: list[np.ndarray] = []
        self._r3: list[np.ndarray] = []
        self._mati: list[int] = []
        self._materials: list[dict] = []
        self._object_ranges: list[tuple[int, int]] = []
        self._vn: list = []
        self._uv: list = []
        self._tri_shift = 0
        self._sph_c: list[np.ndarray] = []
        self._sph_r: list[float] = []
        self._sph_m: list[int] = []
        self._textures: list[np.ndarray] = []
        self._mat_texi: dict[int, int] = {}

    def add_material(self, kd, ks, emission, N, K, shininess, type) -> int:
        """Returns the new material index (main.cpp:532-535)."""
        self._materials.append(
            make_material(kd, ks, emission, N, K, shininess, type))
        return len(self._materials) - 1

    def add_material_row(self, row: dict) -> int:
        self._materials.append(row)
        return len(self._materials) - 1

    def add_triangle(self, r1, r2, r3, mati: int, vn=None, uv=None) -> None:
        """vn: optional (3, 3) corner shading normals (row k at corner
        r{k+1}); None shades this triangle with its face normal, the
        reference's only mode. uv: optional (3, 2) corner texture
        coordinates."""
        self._r1.append(np.asarray(r1, np.float32))
        self._r2.append(np.asarray(r2, np.float32))
        self._r3.append(np.asarray(r3, np.float32))
        self._mati.append(int(mati))
        self._vn.append(None if vn is None
                        else np.asarray(vn, np.float32).reshape(3, 3))
        self._uv.append(None if uv is None
                        else np.asarray(uv, np.float32).reshape(3, 2))

    def add_texture(self, img) -> int:
        """Register a texture image (top-down (H, W, 3), uint8 or float in
        [0, 1]); returns its index. set_material_texture binds it."""
        self._textures.append(np.asarray(img))
        return len(self._textures) - 1

    def set_material_texture(self, mati: int, texi: int) -> None:
        """Bind texture `texi` to material `mati`: a textured render
        multiplies its kd by the bilinear sample at the hit's UV."""
        if not 0 <= mati < len(self._materials):
            raise ValueError(f"no material {mati}")
        if not 0 <= texi < len(self._textures):
            raise ValueError(f"no texture {texi}")
        self._mat_texi[mati] = texi

    def add_analytic_sphere(self, center, radius: float, mati: int) -> None:
        self._sph_c.append(np.asarray(center, np.float32))
        self._sph_r.append(float(radius))
        self._sph_m.append(int(mati))

    def end_obj(self) -> None:
        """Close the current object (main.cpp:536-551)."""
        n = len(self._r1)
        if n > self._tri_shift:
            self._object_ranges.append((self._tri_shift, n))
            self._tri_shift = n

    def add_obj(self, path: str, pos, scale, pitch: float = 0.0,
                yaw: float = 0.0, smooth_normals: bool = False) -> None:
        """Load an OBJ with the reference's transforms (main.cpp:552-617).

        smooth_normals=True attaches corner shading normals: the file's
        `vn` when every corner has one (transformed by the inverse
        transpose of the vertex transform), otherwise area-weighted
        normals of each shape's mesh welded by vertex index. False keeps
        the reference's face-normal shading. Texture coordinates ride
        along whenever the file has them, and each MTL `map_Kd` is loaded
        and bound (`_load_material_texture`)."""
        attrib, shapes, materials = load_obj(path)
        mat_offset = len(self._materials)
        for m in materials:
            # The reference's own keys (main.cpp:568-571); a missing one
            # raises, like its unchecked map::at.
            kn = tuple(float(x)
                       for x in m.unknown_parameter["Kn"].split()[:3])
            kk = tuple(float(x)
                       for x in m.unknown_parameter["Kk"].split()[:3])
            tp = int(m.unknown_parameter["Tp"].split()[0])
            mati = self.add_material(kd=m.diffuse, ks=m.specular,
                                     emission=m.emission, N=kn, K=kk,
                                     shininess=m.shininess, type=tp)
            if m.diffuse_texname:
                self._load_material_texture(mati, m.diffuse_texname, path)
        pos = np.asarray(pos, np.float32)
        scale = np.asarray(scale, np.float32)
        for shape in shapes:
            v = attrib.vertices[shape.vertex_indices].copy()  # (F*3, 3)
            v[:, 0] = -v[:, 0]  # X flip (main.cpp:598)
            v = _np_rot_x(v, pitch)
            v = _np_rot_y(v, yaw)
            v = v * scale[None, :] + pos[None, :]
            vn = (self._shape_normals(attrib, shape, pitch, yaw, scale, v)
                  if smooth_normals else None)
            uv = None
            ti = shape.texcoord_indices
            if attrib.texcoords.shape[0] and (ti >= 0).all():
                uv = attrib.texcoords[ti].reshape(-1, 3, 2)
            v = v.reshape(-1, 3, 3)
            mids = mat_offset + shape.material_ids
            for f in range(v.shape[0]):
                self.add_triangle(v[f, 0], v[f, 1], v[f, 2], int(mids[f]),
                                  vn=None if vn is None else vn[f],
                                  uv=None if uv is None else uv[f])
            self.end_obj()  # per shape (main.cpp:615)

    def _load_material_texture(self, mati: int, texname: str,
                               obj_path: str) -> None:
        """Load an MTL map_Kd image, resolved against the OBJ's directory,
        and bind it. PNG only (`io.image.read_png`); a missing or non-PNG
        file warns on stderr and leaves the material untextured."""
        p = texname
        if not os.path.isabs(p):
            p = os.path.join(os.path.dirname(os.path.abspath(obj_path)), p)
        if not os.path.exists(p) or not p.lower().endswith(".png"):
            print(f"# WARNING: map_Kd {texname!r}: "
                  + ("not found" if not os.path.exists(p)
                     else "only PNG is supported")
                  + " — material renders untextured", file=sys.stderr)
            return
        self.set_material_texture(mati, self.add_texture(read_png(p)))

    @staticmethod
    def _shape_normals(attrib, shape, pitch, yaw, scale,
                       v_transformed) -> np.ndarray:
        """(F, 3, 3) corner shading normals of one OBJ shape.

        File `vn` (when every corner has one) goes through the inverse
        transpose of v' = S R F v: the flip F and the rotations R apply
        as they are, the diagonal scale divides; then renormalised.
        Otherwise the normals are area-weighted over the shape's
        transformed vertices, welded by the OBJ vertex index."""
        ni = shape.normal_indices
        if attrib.normals.shape[0] and (ni >= 0).all():
            n = attrib.normals[ni].copy()           # (F*3, 3)
            n[:, 0] = -n[:, 0]                      # X flip
            n = _np_rot_x(n, pitch)
            n = _np_rot_y(n, yaw)
            n = n / np.where(scale != 0.0, scale, 1.0)[None, :]
        else:
            vi = shape.vertex_indices
            # Rows the shape never touches stay 0 and are never gathered.
            verts = np.zeros((int(vi.max()) + 1, 3), np.float32)
            verts[vi] = v_transformed
            n = compute_vertex_normals(verts, vi.reshape(-1, 3))[vi]
        norm = np.linalg.norm(n, axis=1, keepdims=True)
        n = np.where(norm > 0.0, n / np.where(norm > 0.0, norm, 1.0), 0.0)
        return n.reshape(-1, 3, 3).astype(np.float32)

    def build(self, device="cpu") -> Scene:
        """Upload everything to `device` (main.cpp:618-634)."""
        self.end_obj()
        if not self._r1:
            raise ValueError("scene has no triangles")
        tris = TrianglesSoA.build(
            np.stack(self._r1), np.stack(self._r2), np.stack(self._r3),
            np.asarray(self._mati, np.int32),
        ).to(device)
        spheres = None
        if self._sph_c:
            spheres = SpheresSoA.build(
                np.stack(self._sph_c), np.asarray(self._sph_r),
                np.asarray(self._sph_m), device=device,
            )
        attribs = None
        if any(vn is not None for vn in self._vn) or any(
                uv is not None for uv in self._uv):
            zero3 = np.zeros((3, 3), np.float32)
            vn = np.stack([z if z is not None else zero3 for z in self._vn])
            zero2 = np.zeros((3, 2), np.float32)
            uv = np.stack([z if z is not None else zero2 for z in self._uv])
            attribs = build_vertex_attribs(
                np.stack(self._r1), np.stack(self._r2), np.stack(self._r3),
                vn[:, 0], vn[:, 1], vn[:, 2], uv1=uv[:, 0], uv2=uv[:, 1],
                uv3=uv[:, 2], device=device)
        textures = None
        if self._textures:
            mt = np.full(len(self._materials), -1, np.int32)
            for mi, ti in self._mat_texi.items():
                mt[mi] = ti
            textures = TexturesSoA.build(self._textures, mt, device=device)
        return Scene(
            tris=tris, mats=stack_materials(self._materials, device=device),
            object_ranges=np.asarray(self._object_ranges, np.int64),
            spheres=spheres, attribs=attribs, textures=textures,
        )
