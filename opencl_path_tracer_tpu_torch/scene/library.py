"""Built-in scenes.

Port of `opencl_path_tracer_tpu/scene/library.py`: the Cornell box, the
commented-out reference scene (main.cpp:793-816) with its ten material archetypes (:751-762), two
spheres tessellated like the reference's OBJ spheres (main.cpp:1002,1009),
with face or analytic vertex normals, or analytic quadrics; the emissive
sphere that can replace the lamp quad; the many-light scene; the
reference's default scene of onInitialization (main.cpp:745-1017: a
ground plane, the archetypes and seven OBJ models); a sphere OBJ writer
for models that are missing; the 100k-triangle stress scene (BASELINE
config 4); and the two camera presets. `write_textured_room` and
`textured_room` (no counterpart in the JAX package) write and load an
OBJ + MTL scene with PNG `map_Kd` textures, the textured renders' scene.
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


# write_textured_room's box (world coordinates): it holds both camera
# presets' eyes, (500, 500, -1299) and the reference's (765, 662, -939).
ROOM_LO, ROOM_HI = (-500.0, 0.0, -1500.0), (1500.0, 1200.0, 1000.0)
ROOM_UV = (-1.5, 2.5)      # the walls' texture coordinates, both axes
ROOM_GRID = 64             # quads per side of the grid floor
ROOM_SPHERE = ((500.0, 250.0, 200.0), 200.0)   # textured_room(sphere=True)
ROOM_SEED = 0              # numpy seed of the two maps


def write_textured_room(dirpath: str, *, grid: bool = False) -> str:
    """Write a closed textured room as room.obj + room.mtl + two PNGs
    (seeded by ROOM_SEED) into `dirpath`; returns the OBJ's path. The
    walls' `vt` span ROOM_UV on both axes (repeat wrap). Materials, in MTL order: 'wall_a'
    (floor, back and front walls; a 256 x 256 map), 'wall_b' (left and
    right walls; a 48 x 80 map, so the atlas pads; each map seeded
    colour cells of 16 x 16 texels with noise), 'plain' (the ceiling;
    its map_Kd names a file that does not exist, so loading it warns and
    leaves it untextured) and 'lamp' (an emissive quad below the
    ceiling). grid=True adds 'floor': a ROOM_GRID x ROOM_GRID quad floor
    just above the room's (2 * 64 * 64 = 8,192 more triangles) with its
    own copy of the 256 x 256 map. OBJ x is negated, since add_obj flips
    it back."""
    from opencl_path_tracer_tpu_torch.io.image import write_png
    rs = np.random.default_rng(ROOM_SEED)
    for name, (h, w) in (("tex_a.png", (256, 256)), ("tex_b.png", (48, 80))):
        # Seeded colour cells of 16 x 16 texels, with texel noise.
        cells = rs.integers(0, 224, (h // 16 + 1, w // 16 + 1, 3))
        img = cells.repeat(16, 0).repeat(16, 1)[:h, :w]
        img = img + rs.integers(0, 32, (h, w, 3))
        write_png(os.path.join(dirpath, name), img.astype(np.uint8))
    mats = [("wall_a", "0.8 0.8 0.8", "0 0 0", "0", "tex_a.png"),
            ("wall_b", "0.7 0.7 0.7", "0 0 0", "0", "tex_b.png"),
            ("plain", "0.6 0.6 0.6", "0 0 0", "0", "missing.png"),
            ("lamp", "0 0 0", "20 18 15", "3", None)]
    if grid:
        mats.append(("floor", "0.8 0.8 0.8", "0 0 0", "0", "tex_a.png"))
    with open(os.path.join(dirpath, "room.mtl"), "w") as fh:
        for name, kd, ke, tp, tex in mats:
            fh.write(f"newmtl {name}\nKd {kd}\nKs 0 0 0\nKe {ke}\nNs 1\n"
                     f"Kn 1 1 1\nKk 0 0 0\nTp {tp}\n")
            if tex:
                fh.write(f"map_Kd {tex}\n")
    verts: list = []
    uvs: list = []
    faces: list = []   # (material, (v, vt) x 3)

    def quad(mat, corners, uv):
        base_v, base_t = len(verts), len(uvs)
        verts.extend(corners)
        uvs.extend(uv)
        for a, b, c in ((0, 1, 2), (0, 2, 3)):
            faces.append((mat, [(base_v + k + 1, base_t + k + 1)
                                for k in (a, b, c)]))

    (x0, y0, z0), (x1, y1, z1) = ROOM_LO, ROOM_HI
    lo, hi = ROOM_UV
    wall_uv = [(lo, lo), (hi, lo), (hi, hi), (lo, hi)]
    for mat, corners in (
            ("wall_a", [(x0, y0, z0), (x1, y0, z0), (x1, y0, z1),
                        (x0, y0, z1)]),                       # floor
            ("wall_a", [(x0, y0, z1), (x1, y0, z1), (x1, y1, z1),
                        (x0, y1, z1)]),                       # back
            ("wall_a", [(x0, y0, z0), (x0, y1, z0), (x1, y1, z0),
                        (x1, y0, z0)]),                       # front
            ("wall_b", [(x0, y0, z0), (x0, y0, z1), (x0, y1, z1),
                        (x0, y1, z0)]),                       # left
            ("wall_b", [(x1, y0, z0), (x1, y1, z0), (x1, y1, z1),
                        (x1, y0, z1)]),                       # right
            ("plain", [(x0, y1, z0), (x0, y1, z1), (x1, y1, z1),
                       (x1, y1, z0)])):                       # ceiling
        quad(mat, corners, wall_uv)
    ly = y1 - 10.0
    quad("lamp", [(200.0, ly, -500.0), (800.0, ly, -500.0),
                  (800.0, ly, 300.0), (200.0, ly, 300.0)], wall_uv)
    if grid:
        n, gy = ROOM_GRID, y0 + 1.0
        xs = np.linspace(x0 + 20.0, x1 - 20.0, n + 1)
        zs = np.linspace(z0 + 20.0, z1 - 20.0, n + 1)
        us = np.linspace(lo, hi, n + 1)
        for i in range(n):
            for j in range(n):
                quad("floor", [(xs[i], gy, zs[j]), (xs[i + 1], gy, zs[j]),
                               (xs[i + 1], gy, zs[j + 1]),
                               (xs[i], gy, zs[j + 1])],
                     [(us[i], us[j]), (us[i + 1], us[j]),
                      (us[i + 1], us[j + 1]), (us[i], us[j + 1])])
    path = os.path.join(dirpath, "room.obj")
    with open(path, "w") as fh:
        fh.write("mtllib room.mtl\no room\n")
        fh.writelines(f"v {-x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in verts)
        fh.writelines(f"vt {u:.6f} {v:.6f}\n" for u, v in uvs)
        cur = None
        for mat, corners in faces:
            if mat != cur:
                fh.write(f"usemtl {mat}\n")
                cur = mat
            fh.write("f " + " ".join(f"{v}/{t}" for v, t in corners) + "\n")
    return path


def textured_room(dirpath: str, *, grid: bool = False, sphere: bool = False,
                  device="cpu") -> Scene:
    """`write_textured_room`'s scene loaded through SceneBuilder.add_obj
    (the map_Kd auto-load and read_png run, and the missing map warns);
    sphere=True adds the analytic sphere ROOM_SPHERE with the textured
    material 'wall_a', whose winners must sample as exactly 1.0."""
    b = SceneBuilder()
    b.add_obj(write_textured_room(dirpath, grid=grid),
              pos=(0, 0, 0), scale=(1, 1, 1))
    if sphere:
        b.add_analytic_sphere(ROOM_SPHERE[0], ROOM_SPHERE[1], 0)
    return b.build(device=device)
