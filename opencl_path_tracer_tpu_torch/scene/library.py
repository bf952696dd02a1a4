"""Built-in scenes.

Port of `opencl_path_tracer_tpu/scene/library.py`: the Cornell box, the
commented-out reference scene (main.cpp:793-816) with its ten material archetypes (:751-762), two
spheres tessellated like the reference's OBJ spheres (main.cpp:1002,1009),
with face or analytic vertex normals, or analytic quadrics; the emissive
sphere that can replace the lamp quad; the many-light scene; the
reference's default scene of onInitialization (main.cpp:745-1017: a
ground plane, the archetypes and seven OBJ models); a sphere OBJ writer
for models that are missing; the 100k-triangle stress scene (BASELINE
config 4); and the two camera presets.
"""

from __future__ import annotations

import math
import os

import numpy as np

from opencl_path_tracer_tpu_torch.core.camera import make_camera
from opencl_path_tracer_tpu_torch.core.materials import reference_archetypes
from opencl_path_tracer_tpu_torch.scene.builder import Scene, SceneBuilder

# Archetype indices (main.cpp:751-762).
LAMP, SUN = 0, 1
WHITE_DIFFUSE, RED_DIFFUSE, GREEN_DIFFUSE = 2, 3, 4
PURPLE_SPECULAR, BLACK_SPECULAR = 5, 6
CHROMIUM, GOLD, GLASS = 7, 8, 9


def _add_quad(b: SceneBuilder, v0, v1, v2, v3, mat: int) -> None:
    b.add_triangle(v0, v1, v2, mat)
    b.add_triangle(v2, v3, v0, mat)


def _add_archetypes(b: SceneBuilder) -> None:
    for row in reference_archetypes():
        b.add_material_row(row)


def cornell_box(*, with_spheres: bool = True, analytic_spheres: bool = False,
                smooth_spheres: bool = False, sphere_lamp: bool = False,
                sphere_res: tuple = (12, 18), device="cpu") -> Scene:
    """Cornell-style box in reference coordinates: x in [-100, 1100],
    y in [0, 1000], red left / green right / white elsewhere, lamp quad
    at y = 999.9. analytic_spheres=True swaps the tessellated spheres
    for exact quadrics at the same centers, radii and materials.
    smooth_spheres=True keeps the tessellation and attaches the analytic
    vertex normals, for smooth shading. sphere_lamp=True swaps the lamp
    quad for an emissive analytic sphere (the LAMP material) below the
    ceiling, the scene of NEE's cone sampler."""
    if analytic_spheres and smooth_spheres:
        raise ValueError(
            "analytic_spheres and smooth_spheres are mutually exclusive: "
            "quadrics have exact normals already (no tessellation to "
            "smooth)")
    b = SceneBuilder()
    _add_archetypes(b)
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
        add_sphere(b, (250.0, 180.0, 500.0), 180.0, CHROMIUM, lat, lon,
                   smooth=smooth_spheres)
        add_sphere(b, (720.0, 160.0, 350.0), 160.0, GLASS, lat, lon,
                   smooth=smooth_spheres)
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
    _add_archetypes(b)
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
               lat: int = 12, lon: int = 18, smooth: bool = False) -> None:
    """A tessellated sphere. smooth=True attaches the exact analytic
    normal (corner - center) / radius at every corner; False keeps the
    reference's face-normal shading."""
    c = np.asarray(center, np.float32)
    for t in sphere_mesh(center, radius, lat, lon):
        vn = (t - c[None, :]) / np.float32(radius) if smooth else None
        b.add_triangle(t[0], t[1], t[2], mat, vn=vn)


def write_sphere_obj(path: str, *, radius: float = 1.0, lat: int = 16,
                     lon: int = 24, mtl: dict | None = None) -> None:
    """Write a sphere OBJ, and its MTL with the custom Kn/Kk/Tp keys, as a
    stand-in for a model file that is missing."""
    verts: list = []
    vmap: dict = {}
    faces = []
    for t in sphere_mesh((0.0, 0.0, 0.0), radius, lat, lon):
        idx = []
        for v in t:
            key = tuple(np.round(v, 6))
            if key not in vmap:
                vmap[key] = len(verts) + 1
                verts.append(key)
            idx.append(vmap[key])
        faces.append(idx)
    mtl = mtl or dict(name="gold", Kd=(0, 0, 0), Ks=(0, 0, 0),
                      Ke=(0, 0, 0), Ns=0.0, Kn=(0.17, 0.35, 1.50),
                      Kk=(3.1, 2.7, 1.9), Tp=1)
    mtl_path = os.path.splitext(path)[0] + ".mtl"
    with open(mtl_path, "w") as fh:
        fh.write(f"newmtl {mtl['name']}\n")
        for k in ("Kd", "Ks", "Ke", "Kn", "Kk"):
            fh.write(f"{k} {' '.join(str(x) for x in mtl[k])}\n")
        fh.write(f"Ns {mtl['Ns']}\nTp {mtl['Tp']}\n")
    with open(path, "w") as fh:
        fh.write(f"mtllib {os.path.basename(mtl_path)}\n")
        fh.write("o sphere\n")
        for v in verts:
            fh.write(f"v {v[0]} {v[1]} {v[2]}\n")
        fh.write(f"usemtl {mtl['name']}\n")
        for f in faces:
            fh.write(f"f {f[0]} {f[1]} {f[2]}\n")


# The add_Obj calls of main.cpp:1002-1010: file, translate, scale, pitch,
# yaw, and the material and radius factor of the tessellated sphere that
# stands in for a missing file.
REFERENCE_OBJS = (
    ("lsphere.obj", (0, 1000, -50), (200, 200, 200), 0, 0, LAMP, 1.0),
    ("chair.obj", (50, 0, -150), (190, 190, 190), 0, 0, PURPLE_SPECULAR,
     0.9),
    ("egg.obj", (-350, 330, -400), (0.5, 0.5, 0.5), 0, 0, PURPLE_SPECULAR,
     160.0),
    ("dragon.obj", (-670, 330, -410), (10, 10, 10), 0, 50, GLASS, 15.0),
    ("Wineglass.obj", (-300, 330, -270), (1, 1, 1), 0, 0, GLASS, 90.0),
    ("sphere.obj", (-490, 377, -400), (100, 100, 100), 0, 0, GOLD, 1.0),
    ("glass-table.obj", (-200, 0, -200), (500, 500, 500), 0, 0, GLASS, 0.6),
)


def reference_scene(models_dir: str | None = None, smooth: bool = False,
                    analytic: bool = False, device="cpu") -> Scene:
    """The default scene of onInitialization (main.cpp:745-1017): the
    huge ground plane, the ten archetypes and seven OBJ models
    (main.cpp:1002-1010) read from models_dir. A missing model is
    replaced by a tessellated sphere at its position and scale, so the
    scene always loads (the reference exits, main.cpp:560).

    smooth=True builds vertex shading normals for every model (OBJ vn
    or computed, `SceneBuilder._shape_normals`; analytic for the sphere
    stand-ins). analytic=True swaps the two sphere models, lsphere (the
    emissive lamp, scaled 200) and sphere (the gold ball, scaled 100),
    for exact quadrics at the same centres, radii and materials; it
    assumes unit-sphere model files, as the repo's are."""
    b = SceneBuilder()
    _add_archetypes(b)
    # Ground plane (main.cpp:814-816).
    b.add_triangle((-10000.0, 0.0, -10000.0), (-10000.0, 0.0, 10000.0),
                   (10000.0, 0.0, 10000.0), WHITE_DIFFUSE)
    b.add_triangle((10000.0, 0.0, 10000.0), (10000.0, 0.0, -10000.0),
                   (-10000.0, 0.0, -10000.0), WHITE_DIFFUSE)
    b.end_obj()
    # A unit-sphere model sits at its translate with its uniform scale
    # as the radius (the X flip and the scale leave the origin there).
    analytic_spheres = {"lsphere.obj": LAMP, "sphere.obj": GOLD}
    for name, pos, scale, pitch, yaw, fallback_mat, fb_rad in REFERENCE_OBJS:
        if analytic and name in analytic_spheres:
            b.add_analytic_sphere(pos, float(scale[0]),
                                  analytic_spheres[name])
            continue
        path = os.path.join(models_dir, name) if models_dir else None
        if path and os.path.exists(path):
            b.add_obj(path, pos, scale, pitch, yaw, smooth_normals=smooth)
        else:
            r = fb_rad * float(np.mean(scale))
            add_sphere(b, center=pos, radius=max(r, 40.0), mat=fallback_mat,
                       lat=10, lon=16, smooth=smooth)
            b.end_obj()
    return b.build(device=device)


def stress_scene(num_tris: int = 100_000, seed: int = 0,
                 analytic: bool = False, smooth: bool = False,
                 device="cpu") -> Scene:
    """BASELINE.json config 4 (library.py:325-406): the Cornell shell (no
    spheres), a back wall at z = -2000 with the tube to it sealed, and a
    grid of tessellated spheres (16 x 24, 720 triangles each) in seven
    materials, as many as `num_tris` allows: 20 + 138 x 720 = 99,380
    triangles at the default. The centres, radii and materials come from
    numpy's default_rng(seed) in the JAX package's order. analytic=True
    builds the same spheres as exact quadrics (20 triangles, 138
    spheres); smooth=True attaches the analytic vertex normals."""
    b = SceneBuilder()
    _add_archetypes(b)
    base = cornell_box(with_spheres=False).tris
    r1, r2, r3 = (getattr(base, f).numpy() for f in ("r1", "r2", "r3"))
    mi = base.mati.numpy()
    for i in range(r1.shape[0]):
        b.add_triangle(r1[i], r2[i], r3[i], int(mi[i]))
    b.add_triangle((-100.0, 0.0, -2000.0), (1100.0, 1000.0, -2000.0),
                   (-100.0, 1000.0, -2000.0), WHITE_DIFFUSE)
    b.add_triangle((1100.0, 1000.0, -2000.0), (-100.0, 0.0, -2000.0),
                   (1100.0, 0.0, -2000.0), WHITE_DIFFUSE)
    _add_quad(b, (-100.0, 0.0, -2000.0), (-100.0, 0.0, -1000.0),
              (-100.0, 1000.0, -1000.0), (-100.0, 1000.0, -2000.0),
              RED_DIFFUSE)
    _add_quad(b, (1100.0, 0.0, -2000.0), (1100.0, 1000.0, -2000.0),
              (1100.0, 1000.0, -1000.0), (1100.0, 0.0, -1000.0),
              GREEN_DIFFUSE)
    _add_quad(b, (-100.0, 1000.0, -2000.0), (-100.0, 1000.0, -1000.0),
              (1100.0, 1000.0, -1000.0), (1100.0, 1000.0, -2000.0),
              WHITE_DIFFUSE)
    b.end_obj()

    lat, lon = 16, 24
    per_sphere = 2 * lat * lon - 2 * lon  # caps are single fans
    count = max(1, (num_tris - r1.shape[0]) // per_sphere)
    grid = int(np.ceil(count ** (1 / 3)))
    rs = np.random.default_rng(seed)
    mats_cycle = [WHITE_DIFFUSE, RED_DIFFUSE, GREEN_DIFFUSE, CHROMIUM,
                  GOLD, GLASS, PURPLE_SPECULAR]
    n_added = 0
    for gx in range(grid):
        for gy in range(grid):
            for gz in range(grid):
                if n_added >= count:
                    break
                c = (150.0 + 700.0 * gx / max(grid - 1, 1)
                     + rs.uniform(-30, 30),
                     120.0 + 700.0 * gy / max(grid - 1, 1)
                     + rs.uniform(-30, 30),
                     150.0 + 700.0 * gz / max(grid - 1, 1)
                     + rs.uniform(-30, 30))
                radius = rs.uniform(40.0, 70.0)
                mat = mats_cycle[n_added % len(mats_cycle)]
                if analytic:
                    b.add_analytic_sphere(c, radius, mat)
                else:
                    add_sphere(b, center=c, radius=radius, mat=mat,
                               lat=lat, lon=lon, smooth=smooth)
                n_added += 1
    b.end_obj()
    return b.build(device=device)


def reference_camera(width: int, height: int, device="cpu"):
    """The reference's live camera defaults (main.cpp:30-39)."""
    return make_camera(width, height, fov=75.0, yaw=-13.800002 - 50,
                       pitch=5.599997 + 10,
                       shift=(265.055481, 162.305969, 360.414001),
                       device=device)
