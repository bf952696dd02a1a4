"""The port's native host runtime (`opencl_path_tracer_tpu_torch/native`:
its own copies of the OBJ loader and the tree builder, built with g++ at
first use): `load_obj_native` against the port's `io/obj.py` and the JAX
package's `load_obj_native` on every model in tests/assets/models (the
fields the native loader fills: vertices, shape names, vertex indices and
material ids, the materials' name, Kd, Ks, Ke, Ns, Kn, Kk and Tp);
`build_median_tree_native` bit-equal to the port's Python
`build_median_tree` (split='median'); a source that does not compile
raising with the compiler's output, not falling back. Skips where there
is no g++."""

import pathlib

import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu import native as jnative
from opencl_path_tracer_tpu_torch import native
from opencl_path_tracer_tpu_torch.accel import build_median_tree
from opencl_path_tracer_tpu_torch.core.geometry import TrianglesSoA
from opencl_path_tracer_tpu_torch.io.obj import load_obj
from opencl_path_tracer_tpu_torch.scene import library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

MODELS = sorted(pathlib.Path("tests/assets/models").glob("*.obj"))


@pytest.fixture(autouse=True)
def _needs_gxx():
    if not native.available():
        pytest.skip("no g++ on PATH: the native library cannot be built")


def _same_obj(a, b):
    (va, sa, ma), (vb, sb, mb) = a, b
    np.testing.assert_array_equal(va.vertices, vb.vertices)
    assert [s.name for s in sa] == [s.name for s in sb]
    for x, y in zip(sa, sb):
        np.testing.assert_array_equal(x.vertex_indices, y.vertex_indices)
        np.testing.assert_array_equal(x.material_ids, y.material_ids)
    assert len(ma) == len(mb)
    for x, y in zip(ma, mb):
        assert x.name == y.name
        for f in ("diffuse", "specular", "emission"):
            np.testing.assert_array_equal(np.float32(getattr(x, f)),
                                          np.float32(getattr(y, f)))
        assert np.float32(x.shininess) == np.float32(y.shininess)
        for key in ("Kn", "Kk", "Tp"):
            assert (key in x.unknown_parameter) == (key in y.unknown_parameter)
            if key in x.unknown_parameter:
                np.testing.assert_array_equal(
                    np.float32(x.unknown_parameter[key].split()),
                    np.float32(y.unknown_parameter[key].split()))


@pytest.mark.parametrize("path", MODELS, ids=lambda p: p.stem)
def test_load_obj_native_matches_python_and_jax(path):
    mine = native.load_obj_native(str(path))
    _same_obj(mine, load_obj(str(path)))
    if jnative.available():
        _same_obj(mine, jnative.load_obj_native(str(path)))
    assert mine[0].vertices.shape[0] > 0


def test_load_obj_native_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        native.load_obj_native(str(tmp_path / "none.obj"))


@pytest.mark.parametrize("scene", ["random", "cornell", "stress"])
def test_native_tree_bit_equal_to_python(scene):
    if scene == "random":
        rs = np.random.default_rng(6)
        v = (rs.uniform(-10, 10, (1000, 1, 3))
             + rs.normal(size=(1000, 3, 3)) * 0.6).astype(np.float32)
        tris = TrianglesSoA.build(v[:, 0], v[:, 1], v[:, 2],
                                  np.arange(1000, dtype=np.int32) % 7)
    elif scene == "cornell":
        tris = library.cornell_box(with_spheres=True).tris
    else:
        tris = library.stress_scene(1200).tris
    a = native.build_median_tree_native(tris)
    b = build_median_tree(tris)
    for f in ("nodes", "tri_pack", "tri_n", "tri_mati"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert (a.depth, a.leaf_size) == (b.depth, b.leaf_size)


def test_broken_source_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with g++'s output."""
    for src in native.SOURCES:
        (tmp_path / src).write_text((native.HERE / src).read_text())
    (tmp_path / "bvh_builder.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "HERE", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*bvh_builder"):
        native.build_median_tree_native(library.cornell_box().tris)
    assert not list((tmp_path / "_build").glob("*.so"))
