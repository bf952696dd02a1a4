"""Scene assembly: the host-side builder.

Port of `opencl_path_tracer_tpu/scene/builder.py` (the reference's
`class Scene`, main.cpp:363-742): add_material (:532), add_triangle
(:529), end_obj (:536), with the upload_* calls (:618-634) collapsed
into `build()`. OBJ loading (`add_obj`), vertex attributes and textures
are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from opencl_path_tracer_tpu_torch.core.geometry import TrianglesSoA
from opencl_path_tracer_tpu_torch.core.materials import (
    MaterialsSoA, make_material, stack_materials,
)
from opencl_path_tracer_tpu_torch.core.spheres import SpheresSoA


@dataclasses.dataclass
class Scene:
    """Triangles and materials as structure-of-arrays tensors, the
    per-object [from, to) triangle ranges, and optional analytic
    spheres."""

    tris: TrianglesSoA
    mats: MaterialsSoA
    object_ranges: np.ndarray
    spheres: SpheresSoA | None = None

    @property
    def num_triangles(self) -> int:
        return self.tris.count

    def to(self, device) -> "Scene":
        return Scene(
            tris=self.tris.to(device), mats=self.mats.to(device),
            object_ranges=self.object_ranges,
            spheres=None if self.spheres is None else self.spheres.to(device),
        )


class SceneBuilder:
    def __init__(self) -> None:
        self._r1: list[np.ndarray] = []
        self._r2: list[np.ndarray] = []
        self._r3: list[np.ndarray] = []
        self._mati: list[int] = []
        self._materials: list[dict] = []
        self._object_ranges: list[tuple[int, int]] = []
        self._tri_shift = 0
        self._sph_c: list[np.ndarray] = []
        self._sph_r: list[float] = []
        self._sph_m: list[int] = []

    def add_material(self, kd, ks, emission, N, K, shininess, type) -> int:
        """Returns the new material index (main.cpp:532-535)."""
        self._materials.append(
            make_material(kd, ks, emission, N, K, shininess, type))
        return len(self._materials) - 1

    def add_material_row(self, row: dict) -> int:
        self._materials.append(row)
        return len(self._materials) - 1

    def add_triangle(self, r1, r2, r3, mati: int) -> None:
        self._r1.append(np.asarray(r1, np.float32))
        self._r2.append(np.asarray(r2, np.float32))
        self._r3.append(np.asarray(r3, np.float32))
        self._mati.append(int(mati))

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
        return Scene(
            tris=tris, mats=stack_materials(self._materials, device=device),
            object_ranges=np.asarray(self._object_ranges, np.int64),
            spheres=spheres,
        )
