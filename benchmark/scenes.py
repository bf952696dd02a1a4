"""A configuration's scene and camera as plain numpy arrays.

The configuration file (`configs/<name>.json`) states the scene as data:
material rows in the reference's constructor terms (kd, ks, emission,
complex IOR N and K, shininess, type; main.cpp:92-112) and objects made
of triangles or of tessellated UV spheres (lat x lon, as the reference's
OBJ spheres). This module turns that into triangle vertex arrays, the
per-triangle material ids and the object boundaries, and the pinhole
camera's basis (main.cpp:306-348). Both sides of the benchmark take
these same arrays: the program through its scene builder, the reference
directly. Nothing here imports the program.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

REF_PI = np.float32(3.141593)     # the reference's host pi (main.cpp:48)
BASE_EYE = np.array([500.0, 500.0, -1299.037842], np.float32)


@dataclasses.dataclass(frozen=True)
class SceneArrays:
    """v: (T, 3, 3) float32 corners; mat: (T,) int32 material ids;
    objects: [(from, to)] triangle ranges; materials: the config's rows."""

    v: np.ndarray
    mat: np.ndarray
    objects: list
    materials: list

    @property
    def num_triangles(self) -> int:
        return int(self.v.shape[0])


def sphere_mesh(center, radius: float, lat: int, lon: int) -> np.ndarray:
    """UV-sphere triangles, (T, 3, 3) float32: rings of `lon` vertices at
    `lat` + 1 latitudes, single fans at the poles."""
    cx, cy, cz = center
    ring = []
    for i in range(lat + 1):
        phi = math.pi * i / lat
        ring.append([
            (cx + radius * math.sin(phi) * math.cos(2.0 * math.pi * j / lon),
             cy + radius * math.cos(phi),
             cz + radius * math.sin(phi) * math.sin(2.0 * math.pi * j / lon))
            for j in range(lon)
        ])
    tris = []
    for i in range(lat):
        for j in range(lon):
            j2 = (j + 1) % lon
            a, b = ring[i][j], ring[i][j2]
            c, d = ring[i + 1][j], ring[i + 1][j2]
            if i != 0:
                tris.append((a, b, c))
            if i != lat - 1:
                tris.append((b, d, c))
    return np.asarray(tris, np.float32)


def build_scene(cfg: dict) -> SceneArrays:
    """The configuration's triangles in file order, one object per entry
    of cfg['objects']."""
    verts, mats, objects = [], [], []
    for obj in cfg["objects"]:
        start = sum(len(v) for v in verts)
        for *corners, m in obj.get("triangles", []):
            verts.append(np.asarray(corners, np.float32)[None])
            mats.append(np.full(1, m, np.int32))
        for s in obj.get("spheres", []):
            t = sphere_mesh(s["center"], s["radius"], s["lat"], s["lon"])
            verts.append(t)
            mats.append(np.full(t.shape[0], s["material"], np.int32))
        end = sum(len(v) for v in verts)
        if end > start:
            objects.append((start, end))
    return SceneArrays(v=np.concatenate(verts), mat=np.concatenate(mats),
                       objects=objects, materials=list(cfg["materials"]))


def _rot(v: np.ndarray, deg: float, ix: int, iy: int, sign: float):
    """Rotation in the (ix, iy) plane by degrees, float32 as the host
    does it (main.cpp:47-70)."""
    a = np.float32(np.float32(deg) / np.float32(180.0)) * REF_PI
    c, s = np.float32(math.cos(float(a))), np.float32(math.sin(float(a)))
    out = v.astype(np.float32).copy()
    x, y = v[ix], v[iy]
    out[ix] = x * c - sign * y * s
    out[iy] = sign * x * s + y * c
    return out


def camera(cfg: dict) -> dict:
    """eye, lookat, up * (H/2), right * (W/2) as float32 (3,) arrays, and
    the screen size: the reference's camera (main.cpp:306-348), its
    basis rotated by pitch about x, then by yaw about y."""
    c = cfg["camera"]
    w, h = cfg["width"], cfg["height"]
    axes = np.eye(3, dtype=np.float32)
    basis = []
    for v in (axes[1], axes[0], axes[2]):          # up, right, ahead
        v = _rot(v, c["pitch"], 1, 2, 1.0)         # about x
        v = _rot(v, c["yaw"], 2, 0, 1.0)           # about y: x' = x c + z s
        basis.append(v)
    up, right, ahead = basis
    up_len = np.float32(h) / np.float32(2.0)
    right_len = np.float32(w) / np.float32(2.0)
    fov = np.float32(np.float32(np.float32(c["fov"]) / np.float32(2.0))
                     / np.float32(180.0)) * REF_PI
    ahead_len = right_len / np.float32(math.tan(float(fov)))
    eye = BASE_EYE + np.asarray(c["shift"], np.float32)
    return dict(eye=eye, lookat=(eye + ahead * ahead_len).astype(np.float32),
                up=(up * up_len).astype(np.float32),
                right=(right * right_len).astype(np.float32),
                width=w, height=h)
