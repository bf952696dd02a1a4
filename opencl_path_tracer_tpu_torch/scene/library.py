"""Built-in scenes.

Port of the Cornell-box part of `opencl_path_tracer_tpu/scene/library.py`:
the commented-out reference scene (main.cpp:793-816) with its ten
material archetypes (:751-762), two spheres either tessellated like the
reference's OBJ spheres (main.cpp:1002,1009) or analytic, the emissive
sphere that can replace the lamp quad, the many-light scene and the
camera preset. The other library scenes come with later slices.
"""

from __future__ import annotations

import math

import numpy as np

from opencl_path_tracer_tpu_torch.core.camera import make_camera
from opencl_path_tracer_tpu_torch.core.materials import reference_archetypes
from opencl_path_tracer_tpu_torch.scene.builder import Scene, SceneBuilder

# Archetype indices (main.cpp:751-762).
LAMP, SUN = 0, 1
WHITE_DIFFUSE, RED_DIFFUSE, GREEN_DIFFUSE = 2, 3, 4
PURPLE_SPECULAR, BLACK_SPECULAR = 5, 6
CHROMIUM, GOLD, GLASS = 7, 8, 9


def cornell_box(*, with_spheres: bool = True, analytic_spheres: bool = False,
                sphere_lamp: bool = False, sphere_res: tuple = (12, 18),
                device="cpu") -> Scene:
    """Cornell-style box in reference coordinates: x in [-100, 1100],
    y in [0, 1000], red left / green right / white elsewhere, lamp quad
    at y = 999.9. analytic_spheres=True swaps the tessellated spheres
    for exact quadrics at the same centers, radii and materials.
    sphere_lamp=True swaps the lamp quad for an emissive analytic sphere
    (the LAMP material) below the ceiling, the scene of NEE's cone
    sampler."""
    b = SceneBuilder()
    for row in reference_archetypes():
        b.add_material_row(row)
    if sphere_lamp:
        b.add_analytic_sphere((500.0, 840.0, 500.0), 120.0, LAMP)
    else:
        # Lamp (main.cpp:765-766).
        b.add_triangle((300.0, 999.9, 700.0), (300.0, 999.9, 300.0),
                       (700.0, 999.9, 700.0), LAMP)
        b.add_triangle((700.0, 999.9, 700.0), (300.0, 999.9, 300.0),
                       (700.0, 999.9, 300.0), LAMP)
    _add_cornell_walls(b)
    b.end_obj()
    if with_spheres and analytic_spheres:
        b.add_analytic_sphere((250.0, 180.0, 500.0), 180.0, CHROMIUM)
        b.add_analytic_sphere((720.0, 160.0, 350.0), 160.0, GLASS)
    elif with_spheres:
        lat, lon = sphere_res
        add_sphere(b, (250.0, 180.0, 500.0), 180.0, CHROMIUM, lat, lon)
        add_sphere(b, (720.0, 160.0, 350.0), 160.0, GLASS, lat, lon)
        b.end_obj()
    return b.build(device=device)


def _add_cornell_walls(b: SceneBuilder) -> None:
    """The five wall quads of main.cpp:794-815 (floor shrunk to the box)."""
    w = [
        # Front, +z (main.cpp:794-795).
        ((-100.0, 0.0, 1000.0), (-100.0, 1000.0, 1000.0),
         (1100.0, 1000.0, 1000.0), WHITE_DIFFUSE),
        ((1100.0, 1000.0, 1000.0), (1100.0, 0.0, 1000.0),
         (-100.0, 0.0, 1000.0), WHITE_DIFFUSE),
        # Left red (main.cpp:798-799).
        ((-100.0, 0.0, 1000.0), (-100.0, 0.0, -1000.0),
         (-100.0, 1000.0, 1000.0), RED_DIFFUSE),
        ((-100.0, 1000.0, 1000.0), (-100.0, 0.0, -1000.0),
         (-100.0, 1000.0, -1000.0), RED_DIFFUSE),
        # Right green (main.cpp:802-803).
        ((1100.0, 1000.0, 1000.0), (1100.0, 0.0, -1000.0),
         (1100.0, 0.0, 1000.0), GREEN_DIFFUSE),
        ((1100.0, 1000.0, -1000.0), (1100.0, 0.0, -1000.0),
         (1100.0, 1000.0, 1000.0), GREEN_DIFFUSE),
        # Ceiling (main.cpp:806-807).
        ((-100.0, 1000.0, 1000.0), (-100.0, 1000.0, -1000.0),
         (1100.0, 1000.0, 1000.0), WHITE_DIFFUSE),
        ((1100.0, 1000.0, 1000.0), (-100.0, 1000.0, -1000.0),
         (1100.0, 1000.0, -1000.0), WHITE_DIFFUSE),
        # Floor (main.cpp:814-815).
        ((-10000.0, 0.0, -10000.0), (-10000.0, 0.0, 10000.0),
         (10000.0, 0.0, 10000.0), WHITE_DIFFUSE),
        ((10000.0, 0.0, 10000.0), (10000.0, 0.0, -10000.0),
         (-10000.0, 0.0, -10000.0), WHITE_DIFFUSE),
    ]
    for r1, r2, r3, mat in w:
        b.add_triangle(r1, r2, r3, mat)


def many_light_scene(count: int = 64, seed: int = 0, device="cpu") -> Scene:
    """The Cornell walls, the two analytic receiver spheres and `count`
    small emissive analytic spheres scattered through the box, in four
    lamp materials: the scene of NEE's 'distance' select. The centres
    and radii come from numpy's default_rng(seed) in the JAX package's
    order, so they match it bit for bit."""
    rs = np.random.default_rng(seed)
    b = SceneBuilder()
    for row in reference_archetypes():
        b.add_material_row(row)
    tints = [(120.0, 100.0, 80.0), (40.0, 80.0, 140.0),
             (140.0, 50.0, 40.0), (70.0, 130.0, 60.0)]
    lamp_mats = [b.add_material((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), em,
                                (0.0, 0.0, 0.0), (0.0, 0.0, 0.0), 0, 3)
                 for em in tints]
    _add_cornell_walls(b)
    b.end_obj()
    b.add_analytic_sphere((250.0, 180.0, 500.0), 180.0, CHROMIUM)
    b.add_analytic_sphere((720.0, 160.0, 350.0), 160.0, GLASS)
    for i in range(count):
        c = (float(rs.uniform(-40.0, 1040.0)),
             float(rs.uniform(120.0, 960.0)),
             float(rs.uniform(-600.0, 940.0)))
        rad = float(rs.uniform(10.0, 22.0))
        b.add_analytic_sphere(c, rad, lamp_mats[i % len(lamp_mats)])
    return b.build(device=device)


def cornell_camera(width: int, height: int, device="cpu"):
    """Camera preset for cornell_box: fov 60, yaw 0, pitch 0, no shift
    (main.cpp:33-35,40)."""
    return make_camera(width, height, fov=60.0, yaw=0.0, pitch=0.0,
                       shift=(0.0, 0.0, 0.0), device=device)


def sphere_mesh(center, radius: float, lat: int = 12, lon: int = 18):
    """UV-sphere triangles: (T, 3, 3) float32 vertex array."""
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
            a, bb = ring[i][j], ring[i][j2]
            c, d = ring[i + 1][j], ring[i + 1][j2]
            if i != 0:
                tris.append((a, bb, c))
            if i != lat - 1:
                tris.append((bb, d, c))
    return np.asarray(tris, np.float32)


def add_sphere(b: SceneBuilder, center, radius: float, mat: int,
               lat: int = 12, lon: int = 18) -> None:
    """A tessellated sphere with face-normal shading."""
    for t in sphere_mesh(center, radius, lat, lon):
        b.add_triangle(t[0], t[1], t[2], mat)
