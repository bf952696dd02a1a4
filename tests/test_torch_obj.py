"""OBJ/MTL loading and the scenes built from it, in the port
(`io/obj.py`, `scene/builder.py::add_obj`, `scene/library.py`) against
the JAX package on the CPU: the parsed data, the transformed vertices,
the vertex attributes and the triangle constants are equal bit for bit
(the same host arithmetic in numpy and float64)."""

import pathlib

import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.io import obj as jobj
from opencl_path_tracer_tpu.scene import builder as jbuilder
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch.io import obj
from opencl_path_tracer_tpu_torch.scene import builder, library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

MODELS = pathlib.Path(__file__).resolve().parent / "assets" / "models"
NAMES = sorted(p.name for p in MODELS.glob("*.obj"))
# Face counts of the seven models (each with its MTL, no vn, no vt).
FACES = {"Wineglass.obj": 480, "chair.obj": 72, "dragon.obj": 352,
         "egg.obj": 352, "glass-table.obj": 60, "lsphere.obj": 168,
         "sphere.obj": 352}

SMALL_OBJ = """mtllib small.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
f 1/1/1 2/2/1 3/3/1
o second
usemtl red
f -4/-4/-1 -3/-3/-1 -2/-2/-1 -1/-1/-1
g third
usemtl blue
f 1//1 3//1 4//1
"""
SMALL_MTL = """newmtl red
Kd 0.8 0.1 0.1
Ks 0.2 0.2 0.2
Ke 0 0 0
Ns 40
Ni 1.5
d 0.5
illum 2
Kn 1.5 1.5 1.5
Kk 0 0 0
Tp 0
newmtl blue
Kd 0.1 0.1 0.8
Tr 0.25
Kn 0.17 0.35 1.5
Kk 3.1 2.7 1.9
Tp 1
"""


def _assert_parsed_equal(got, ref):
    ga, gs, gm = got
    ra, rs, rm = ref
    for f in ("vertices", "normals", "texcoords"):
        assert np.array_equal(getattr(ga, f), getattr(ra, f)), f
    assert len(gs) == len(rs)
    for a, b in zip(gs, rs):
        assert a.name == b.name
        for f in ("vertex_indices", "normal_indices", "texcoord_indices",
                  "num_face_vertices", "material_ids"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert [vars(m) for m in gm] == [vars(m) for m in rm]


def _assert_scene_equal(ps, js):
    assert ps.num_triangles == js.num_triangles
    for f in ("r1", "r2", "r3", "n", "c0", "m1", "d1", "m2", "d2", "m3",
              "d3"):
        a = getattr(ps.tris, f).numpy()
        assert np.array_equal(a.view(np.uint32),
                              np.asarray(getattr(js.tris, f)).view(
                                  np.uint32)), f
    assert np.array_equal(ps.tris.mati.numpy(), np.asarray(js.tris.mati))
    assert np.array_equal(ps.object_ranges, js.object_ranges)
    assert ps.mats.count == int(np.asarray(js.mats.type).shape[0])
    for f in ("kd", "ks", "emission", "f0"):
        for a, b in zip(getattr(ps.mats, f), getattr(js.mats, f)):
            assert np.array_equal(a.numpy(), np.asarray(b)), f
    for f in ("n", "shininess", "type"):
        assert np.array_equal(getattr(ps.mats, f).numpy(),
                              np.asarray(getattr(js.mats, f))), f
    if js.attribs is None:
        assert ps.attribs is None
    else:
        assert np.array_equal(ps.attribs.packed.numpy().view(np.uint32),
                              np.asarray(js.attribs.packed).view(np.uint32))
        for f in ("uv1", "uv2", "uv3"):
            for a, b in zip(getattr(ps.attribs, f), getattr(js.attribs, f)):
                assert np.array_equal(a.numpy(), np.asarray(b)), f
    if js.spheres is None:
        assert ps.spheres is None
    else:
        assert np.array_equal(ps.spheres.rad.numpy(),
                              np.asarray(js.spheres.rad))


@pytest.mark.parametrize("name", NAMES)
def test_load_obj_and_mtl_match_jax(name):
    path = str(MODELS / name)
    got = obj.load_obj(path)
    _assert_parsed_equal(got, jobj.load_obj(path))
    attrib, shapes, mats = got
    assert sum(s.material_ids.size for s in shapes) == FACES[name]
    assert attrib.normals.shape == (0, 3) and attrib.texcoords.shape == (0, 2)
    assert len(mats) == 1 and {"Kn", "Kk", "Tp"} <= set(
        mats[0].unknown_parameter)
    mtl = str(MODELS / name.replace(".obj", ".mtl"))
    assert [vars(m) for m in obj.load_mtl(mtl)] == [
        vars(m) for m in jobj.load_mtl(mtl)]


def test_load_obj_vn_vt_negative_indices(tmp_path):
    """A quad fan-triangulated from negative indices, vt and vn, shapes
    split on o and g, faces before any usemtl at material -1, the MTL's
    standard keys and its Kn/Kk/Tp."""
    (tmp_path / "small.obj").write_text(SMALL_OBJ)
    (tmp_path / "small.mtl").write_text(SMALL_MTL)
    path = str(tmp_path / "small.obj")
    got = obj.load_obj(path)
    _assert_parsed_equal(got, jobj.load_obj(path))
    attrib, shapes, mats = got
    assert [s.name for s in shapes] == ["", "second", "third"]
    assert shapes[0].material_ids.tolist() == [-1]
    quad = shapes[1]
    assert quad.num_face_vertices.tolist() == [4]
    assert quad.vertex_indices.tolist() == [0, 1, 2, 0, 2, 3]
    assert quad.texcoord_indices.tolist() == [0, 1, 2, 0, 2, 3]
    assert quad.normal_indices.tolist() == [0] * 6
    assert quad.material_ids.tolist() == [0, 0]
    assert shapes[2].texcoord_indices.tolist() == [-1, -1, -1]
    assert shapes[2].material_ids.tolist() == [1]
    red, blue = mats
    assert (red.diffuse, red.shininess, red.ior, red.dissolve, red.illum) \
        == ((0.8, 0.1, 0.1), 40.0, 1.5, 0.5, 2)
    assert blue.dissolve == 0.75 and blue.unknown_parameter["Tp"] == "1"


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_add_obj_matches_jax(name, smooth):
    """Each model under its own add_Obj transform (main.cpp:1002-1010):
    vertices, face constants and, with smooth normals, the attribute
    rows equal to JAX's."""
    spec = next(s for s in library.REFERENCE_OBJS if s[0] == name)
    _, pos, scale, pitch, yaw = spec[:5]
    pb, jb = builder.SceneBuilder(), jbuilder.SceneBuilder()
    for b in (pb, jb):
        b.add_obj(str(MODELS / name), pos, scale, pitch, yaw,
                  smooth_normals=smooth)
    ps, js = pb.build(), jb.build()
    assert ps.num_triangles == FACES[name]
    _assert_scene_equal(ps, js)
    assert (ps.attribs is not None) == smooth


def test_add_obj_file_normals_and_uvs(tmp_path):
    """File vn go through the inverse transpose of the vertex transform
    (x flip, nonuniform scale (1, 4, 1)): (0, 1, 1)/sqrt(2) becomes
    (0, 0.25, 1)/|.|; vt ride along; pitch and yaw rotate."""
    (tmp_path / "q.obj").write_text(
        "v -1 -1 0\nv 1 -1 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 0 1\n"
        "vn 0 0.7071 0.7071\nf 1/1/1 2/2/1 3/3/1\n")
    scenes = []
    for mod in (builder, jbuilder):
        b = mod.SceneBuilder()
        b.add_material((1, 1, 1), (0, 0, 0), (0, 0, 0), (1, 1, 1),
                       (0, 0, 0), 1.0, 0)
        b.add_obj(str(tmp_path / "q.obj"), pos=(0, 0, 0), scale=(1, 4, 1),
                  smooth_normals=True)
        b.add_obj(str(tmp_path / "q.obj"), pos=(5, 1, 2), scale=(2, 2, 2),
                  pitch=30.0, yaw=-40.0, smooth_normals=True)
        scenes.append(b.build())
    ps, js = scenes
    _assert_scene_equal(ps, js)
    n = torch.stack(ps.attribs.n1, -1).numpy()
    expect = np.float32([0.0, 0.25, 1.0])
    np.testing.assert_allclose(n[0], expect / np.linalg.norm(expect),
                               atol=1e-5)
    assert ps.attribs.uv2[0][0] == 1.0 and ps.attribs.uv3[1][0] == 1.0


@pytest.mark.parametrize("kw,tris,spheres", [
    (dict(), 1838, 0), (dict(smooth=True), 1838, 0),
    (dict(smooth=True, analytic=True), 1318, 2)])
def test_reference_scene_matches_jax(kw, tris, spheres):
    """The reference's default scene from the repo's seven models: 2
    ground triangles + 1,836 model triangles (docs/BENCHMARKS.md:347);
    analytic swaps lsphere (168) and sphere (352) for two quadrics."""
    ps = library.reference_scene(str(MODELS), **kw)
    js = jlib.reference_scene(str(MODELS), **kw)
    assert ps.num_triangles == tris
    assert (0 if ps.spheres is None else ps.spheres.count) == spheres
    _assert_scene_equal(ps, js)
    cam, jcam = library.reference_camera(64, 36), jlib.reference_camera(64, 36)
    for f in ("eye", "lookat", "up", "right"):
        assert np.array_equal(getattr(cam, f).numpy(),
                              np.asarray(getattr(jcam, f))), f


def test_reference_scene_stand_ins_and_sphere_obj(tmp_path):
    """Without models every one is a tessellated stand-in sphere; a sphere
    OBJ written by write_sphere_obj is byte-equal to JAX's and loads."""
    _assert_scene_equal(library.reference_scene(None, smooth=True),
                        jlib.reference_scene(None, smooth=True))
    library.write_sphere_obj(str(tmp_path / "a.obj"), lat=6, lon=8)
    jlib.write_sphere_obj(str(tmp_path / "b.obj"), lat=6, lon=8)
    for ext in (".obj", ".mtl"):
        a = (tmp_path / f"a{ext}").read_text()
        assert a.replace("a.mtl", "b.mtl") == (tmp_path / f"b{ext}").read_text()
    b = builder.SceneBuilder()
    b.add_obj(str(tmp_path / "a.obj"), (0, 0, 0), (1, 1, 1))
    assert b.build().num_triangles == 2 * 6 * 8 - 2 * 8


def test_map_kd_raises(tmp_path, capsys):
    """An MTL map_Kd no longer raises: it loads (textures are ported). A
    missing file warns as the JAX package's builder does and leaves the
    material untextured; a PNG binds to its material."""
    from opencl_path_tracer_tpu_torch.io.image import write_png
    (tmp_path / "t.obj").write_text("mtllib t.mtl\nv 0 0 0\nv 1 0 0\n"
                                    "v 0 1 0\nusemtl tex\nf 1 2 3\n")
    (tmp_path / "t.mtl").write_text("newmtl tex\nKd 1 1 1\nmap_Kd wood.png\n"
                                    "Kn 1 1 1\nKk 0 0 0\nTp 0\n")
    scenes = []
    for b in (builder.SceneBuilder(), jbuilder.SceneBuilder()):
        b.add_obj(str(tmp_path / "t.obj"), (0, 0, 0), (1, 1, 1))
        scenes.append(b.build())
        assert "map_Kd 'wood.png': not found" in capsys.readouterr().err
    assert scenes[0].textures is None and scenes[1].textures is None
    write_png(str(tmp_path / "wood.png"), np.full((2, 3, 3), 128, np.uint8))
    b = builder.SceneBuilder()
    b.add_obj(str(tmp_path / "t.obj"), (0, 0, 0), (1, 1, 1))
    tex = b.build().textures
    assert capsys.readouterr().err == ""
    assert tex.mat_texi.tolist() == [0] and tex.count == 1
    assert (tex.hm, tex.wm) == (2, 3)
    assert torch.equal(tex.atlas[:, :3],
                       torch.full((6, 3), np.float32(128) / np.float32(255)))


def test_smooth_cornell_and_quad_match_jax():
    """cornell_box(smooth_spheres=True) carries the analytic corner
    normals, refuses analytic_spheres with it, and _add_quad adds the
    JAX package's two triangles."""
    _assert_scene_equal(
        library.cornell_box(with_spheres=True, smooth_spheres=True),
        jlib.cornell_box(with_spheres=True, smooth_spheres=True))
    with pytest.raises(ValueError, match="mutually exclusive"):
        library.cornell_box(analytic_spheres=True, smooth_spheres=True)
    quads = []
    for mod, lib in ((builder, library), (jbuilder, jlib)):
        b = mod.SceneBuilder()
        lib._add_archetypes(b)
        lib._add_quad(b, (0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0), 2)
        quads.append(b.build())
    _assert_scene_equal(*quads)


def test_reference_zero_area_triangles_keep_jax_normals():
    """The reference scene's zero-area triangles (float64 area 0), all in
    Wineglass.obj: the fused cross product leaves most of them a unit
    face normal, in JAX and in the port bit for bit, which lets K1's
    exact test accept a thin strip through each (ROADMAP.md queue 3)."""
    ps = library.reference_scene(str(MODELS))
    js = jlib.reference_scene(str(MODELS))
    r1, r2, r3 = (getattr(ps.tris, f).double() for f in ("r1", "r2", "r3"))
    zero = torch.linalg.cross(r2 - r1, r3 - r1).norm(dim=1) == 0.0
    idx = torch.nonzero(zero).flatten().numpy()
    glass = next(r for r in ps.object_ranges if r[1] - r[0] == 480)
    assert len(idx) == 20 and ((idx >= glass[0]) & (idx < glass[1])).all()
    n = ps.tris.n.numpy()[idx]
    assert np.array_equal(n, np.asarray(js.tris.n)[idx])
    unit = np.linalg.norm(n, axis=1)
    assert int((unit == 1.0).sum()) == 16 and int((unit == 0.0).sum()) == 4
