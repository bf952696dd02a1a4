"""Image textures in the port against the JAX package on the CPU:
`core.textures.TexturesSoA.build` (the atlas arrays), `kd_scale` (the
bilinear repeat-wrap sample), the builder's texture binding and its
refusals, the MTL `map_Kd` auto-load with its missing-file warning, and
the interop round trip.

`kd_scale` is bit-equal to the JAX package's op-by-op evaluation
(`jax.disable_jit()`) on every lane, NaN in the same places; XLA's jit
contracts the bilinear blend into fused multiply-adds, which moves about
17 % of its lanes by an ulp, so the jitted result is held to the
goldens' rtol 1e-4 (measured: at most 1.9e-6 relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.core import textures as jtex
from opencl_path_tracer_tpu.scene import builder as jbuilder
from opencl_path_tracer_tpu_torch import interop
from opencl_path_tracer_tpu_torch.core import textures
from opencl_path_tracer_tpu_torch.io.image import write_png
from opencl_path_tracer_tpu_torch.scene import builder, library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)


def _images(seed=0):
    """uint8, float, grey (H, W) and RGBA images of four sizes: the
    atlas pads to the largest height and width."""
    rs = np.random.default_rng(seed)
    return [rs.integers(0, 256, (16, 16, 3), dtype=np.uint8),
            rs.random((5, 7, 3)).astype(np.float32),
            rs.random((3, 9)).astype(np.float32),
            rs.integers(0, 256, (6, 4, 4), dtype=np.uint8)]


def _assert_tex_equal(p, j):
    for k in range(3):
        np.testing.assert_array_equal(p.atlas[:, k].numpy(),
                                      np.asarray(j.atlas[k]))
    assert not p.atlas[:, 3].any()
    for f in ("height", "width", "mat_texi"):
        np.testing.assert_array_equal(getattr(p, f).numpy(),
                                      np.asarray(getattr(j, f)))
    assert (p.hm, p.wm, p.count) == (j.hm, j.wm, j.count)


@pytest.mark.parametrize("which", [[0], [1], [2], [3], [0, 1, 2, 3]])
def test_build_matches_jax(which):
    imgs = [_images()[i] for i in which]
    mt = np.asarray([-1] + list(range(len(imgs))), np.int32)
    _assert_tex_equal(textures.TexturesSoA.build(imgs, mt),
                      jtex.TexturesSoA.build(imgs, mt))


def test_build_refuses_no_image():
    with pytest.raises(ValueError, match=">= 1 image"):
        textures.TexturesSoA.build([], [])


def _lanes(n_mats, n_tex, seed=1):
    """(mati, s, t, ok) over the hazards: repeat wrap (s, t in [-3, 3)),
    integer coordinates, t = -tiny (s - floor(s) rounds to 1.0, so x1
    wraps to 0), texel centres, NaN and inf coordinates, unbound
    materials and ok = False lanes."""
    rs = np.random.default_rng(seed)
    n = 2048
    s = rs.uniform(-3, 3, n).astype(np.float32)
    t = rs.uniform(-3, 3, n).astype(np.float32)
    s[:64] = np.round(s[:64])
    t[64:128] = -1e-30
    s[128:160] = -np.float32(1e-8)
    s[160:168] = np.nan
    t[168:176] = np.inf
    s[176:240] = (rs.integers(0, 16, 64) + 0.5) / 16
    t[176:240] = (rs.integers(0, 16, 64) + 0.5) / 16
    mati = rs.integers(0, n_mats, n).astype(np.int32)
    ok = rs.random(n) < 0.9
    mt = rs.integers(-1, n_tex, n_mats).astype(np.int32)
    mt[0] = 0
    return mati, s, t, ok, mt


@pytest.mark.parametrize("n_mats", [1, 6, 64, 70])
def test_kd_scale_bit_equal_to_jax(n_mats):
    """Bit-equal to JAX op by op; 70 materials take the gather past
    _select_small's 64-row chain."""
    imgs = _images()
    mati, s, t, ok, mt = _lanes(n_mats, len(imgs))
    jt = jtex.TexturesSoA.build(imgs, mt)
    pt = textures.TexturesSoA.build(imgs, mt)
    args = (mati, s, t, ok)
    with jax.disable_jit():
        ref = jtex.kd_scale(jt, *(jnp.asarray(a) for a in args))
    jitted = jax.jit(jtex.kd_scale)(jt, *(jnp.asarray(a) for a in args))
    got = textures.kd_scale(pt, *(torch.from_numpy(a) for a in args))
    for k in range(3):
        g = got[k].numpy()
        np.testing.assert_array_equal(g, np.asarray(ref[k]))
        np.testing.assert_allclose(g, np.asarray(jitted[k]), rtol=1e-4,
                                   atol=0)
        # Unbound or not-ok lanes are exactly 1; NaN only from NaN input.
        texi = mt[mati]
        assert (g[(texi < 0) | ~ok] == 1.0).all()
        nan_in = ~np.isfinite(s) | ~np.isfinite(t)
        assert not np.isnan(g[~nan_in]).any()
        assert np.isnan(g[nan_in & ok & (texi >= 0)]).all()


def test_kd_scale_texel_centres_and_wrap():
    """A texel's centre reproduces it; s and s + 1 (repeat wrap) and
    t = -tiny against t = 1 sample the same value."""
    img = np.random.default_rng(3).random((5, 7, 3)).astype(np.float32)
    tex = textures.TexturesSoA.build([img], [0])
    ys, xs = np.meshgrid(np.arange(5), np.arange(7), indexing="ij")
    s = torch.from_numpy(((xs.ravel() + 0.5) / 7).astype(np.float32))
    t = torch.from_numpy(((ys.ravel() + 0.5) / 5).astype(np.float32))
    z = torch.zeros(35, dtype=torch.int32)
    ok = torch.ones(35, dtype=torch.bool)
    got = torch.stack(textures.kd_scale(tex, z, s, t, ok), -1).numpy()
    np.testing.assert_allclose(got, img[::-1].reshape(-1, 3), atol=1e-6)
    again = textures.kd_scale(tex, z, s + 1.0, t - 2.0, ok)
    for k in range(3):
        np.testing.assert_allclose(again[k].numpy(), got[:, k], atol=1e-6)


def test_interop_roundtrip():
    imgs = _images()
    mt = np.asarray([0, -1, 3, 2, 1], np.int32)
    jt = jtex.TexturesSoA.build(imgs, mt)
    pt = interop.textures_from_numpy(
        **{f: getattr(jt, f) for f in ("atlas", "height", "width",
                                       "mat_texi", "hm", "wm")})
    _assert_tex_equal(pt, jt)
    back = interop.textures_to_numpy(pt)
    jt2 = jtex.TexturesSoA(atlas=tuple(jnp.asarray(c) for c in back["atlas"]),
                           height=jnp.asarray(back["height"]),
                           width=jnp.asarray(back["width"]),
                           mat_texi=jnp.asarray(back["mat_texi"]),
                           hm=back["hm"], wm=back["wm"])
    _assert_tex_equal(pt, jt2)
    moved = pt.to("cpu")
    assert torch.equal(moved.atlas, pt.atlas) and moved.hm == pt.hm


@pytest.mark.parametrize("mati,texi,match", [(1, 0, "no material 1"),
                                             (0, 1, "no texture 1"),
                                             (-1, 0, "no material -1")])
def test_builder_refusals_match_jax(mati, texi, match):
    for b in (builder.SceneBuilder(), jbuilder.SceneBuilder()):
        b.add_material((1, 1, 1), (0, 0, 0), (0, 0, 0), (1, 1, 1),
                       (0, 0, 0), 1.0, 0)
        b.add_texture(np.zeros((2, 2, 3), np.float32))
        with pytest.raises(ValueError, match=match):
            b.set_material_texture(mati, texi)


def _quad(b, img):
    m = b.add_material((1, 1, 1), (0, 0, 0), (0, 0, 0), (1, 1, 1),
                       (0, 0, 0), 1.0, 0)
    b.add_material((0.5, 0.5, 0.5), (0, 0, 0), (0, 0, 0), (1, 1, 1),
                   (0, 0, 0), 1.0, 0)
    b.add_triangle((-1, -1, 5), (1, -1, 5), (-1, 1, 5), m,
                   uv=((0, 0), (1, 0), (0, 1)))
    b.add_triangle((1, -1, 5), (1, 1, 5), (-1, 1, 5), 1)
    b.set_material_texture(m, b.add_texture(img))
    return b.build()


def test_builder_binding_matches_jax():
    img = _images()[0]
    p, j = _quad(builder.SceneBuilder(), img), _quad(jbuilder.SceneBuilder(),
                                                    img)
    _assert_tex_equal(p.textures, j.textures)
    assert p.textures.mat_texi.tolist() == [0, -1]
    moved = p.to("cpu")
    assert torch.equal(moved.textures.atlas, p.textures.atlas)
    assert builder.SceneBuilder().add_texture(img) == 0
    plain = builder.SceneBuilder()
    plain.add_material((1, 1, 1), (0, 0, 0), (0, 0, 0), (1, 1, 1),
                       (0, 0, 0), 1.0, 0)
    plain.add_triangle((0, 0, 5), (1, 0, 5), (0, 1, 5), 0)
    assert plain.build().textures is None


@pytest.mark.parametrize("grid", [False, True])
def test_map_kd_autoload_and_warning_match_jax(grid, tmp_path, capsys):
    """write_textured_room's OBJ through both builders: the same atlas
    and bindings, the missing map's warning once each, the same
    triangles and UVs."""
    path = library.write_textured_room(str(tmp_path), grid=grid)
    p, j = builder.SceneBuilder(), jbuilder.SceneBuilder()
    p.add_obj(path, (0, 0, 0), (1, 1, 1))
    p_err = capsys.readouterr().err
    j.add_obj(path, (0, 0, 0), (1, 1, 1))
    j_err = capsys.readouterr().err
    assert p_err == j_err
    assert p_err.count("'missing.png': not found") == 1
    assert "untextured" in p_err
    ps, js = p.build(), j.build()
    _assert_tex_equal(ps.textures, js.textures)
    assert ps.textures.mat_texi.tolist() == (
        [0, 1, -1, -1, 2] if grid else [0, 1, -1, -1])
    assert (ps.textures.hm, ps.textures.wm) == (256, 256)
    assert ps.num_triangles == js.num_triangles == (
        14 + 2 * library.ROOM_GRID ** 2 if grid else 14)
    np.testing.assert_array_equal(ps.attribs.packed.numpy(),
                                  np.asarray(js.attribs.packed))
    for name in ("uv1", "uv2", "uv3"):
        for k in range(2):
            np.testing.assert_array_equal(
                getattr(ps.attribs, name)[k].numpy(),
                np.asarray(getattr(js.attribs, name)[k]))
    uv = torch.stack([ps.attribs.uv1[0], ps.attribs.uv2[0]])
    lo, hi = library.ROOM_UV
    assert float(uv.min()) == lo and float(uv.max()) == hi


def test_map_kd_non_png_warns_and_loads_png(tmp_path, capsys):
    """A map_Kd that exists but is not PNG warns as JAX's does; a PNG in
    a subdirectory resolves against the OBJ's directory."""
    (tmp_path / "maps").mkdir()
    img = np.random.default_rng(4).integers(0, 256, (4, 6, 3), np.uint8)
    write_png(str(tmp_path / "maps" / "a.png"), img)
    (tmp_path / "b.jpg").write_bytes(b"not a png")
    (tmp_path / "q.mtl").write_text(
        "newmtl a\nKd 1 1 1\nKn 1 1 1\nKk 0 0 0\nTp 0\nmap_Kd maps/a.png\n"
        "newmtl b\nKd 1 1 1\nKn 1 1 1\nKk 0 0 0\nTp 0\nmap_Kd b.jpg\n")
    (tmp_path / "q.obj").write_text(
        "mtllib q.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 0 1\n"
        "usemtl a\nf 1/1 2/2 3/3\nusemtl b\nf 1/1 3/3 2/2\n")
    scenes = []
    for b in (builder.SceneBuilder(), jbuilder.SceneBuilder()):
        b.add_obj(str(tmp_path / "q.obj"), (0, 0, 0), (1, 1, 1))
        scenes.append(b.build())
        err = capsys.readouterr().err
        assert "'b.jpg': only PNG is supported" in err
    _assert_tex_equal(scenes[0].textures, scenes[1].textures)
    np.testing.assert_array_equal(
        scenes[0].textures.atlas[:6, :3].numpy(),
        img[::-1][0].astype(np.float32) / 255.0)
