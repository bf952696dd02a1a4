"""The port's multi-device rendering (`parallel/`) against the JAX
package's `parallel/shard.py`, on the CPU: twins of tests/test_parallel.py.

One gloo world of 2 ranks (and one of 4 for the subset mesh) runs every
scenario of `tests/torch_world.py` once, in a module fixture; each test
reads its scenario's numpy results. The JAX references run on the
conftest's virtual 8-device CPU mesh, sliced with make_render_mesh(2)
(or 4), at the same 16x4 frame.

Tolerances. Between the port's sharded and single-device runs the
results are torch.equal: the ranks run the same op-by-op code on
disjoint rows. Against JAX's sharded steps, integer state (Lehmer
states, samples, pixel ids, bounces, inside) is exactly equal; JAX runs
them jitted through shard_map, where XLA contracts multiplies and adds
into FMAs, so floats are not bit-equal. The probe on these inputs: the
colors within 3.6e-7 relative (held to rtol 1e-6), ray directions
within 1 ulp of 1.0 (atol 2.4e-7), ray origins within 2.44e-4 in a
1000-unit box (atol 5e-4), prev_pdf within 1.9e-7 relative (rtol 1e-6);
with the sphere lamp's NEE, whose cone sample JAX's jit contracts too,
3 of 192 colour values lie between 1e-4 and 2.6e-4 relative, at most
1.75e-5 absolute (held to the goldens' rtol 1e-4 with atol 2e-5;
tests/test_torch_nee.py holds the same sampler to atol 5e-5). JAX's own
tests under `jax.disable_jit()` would remove the FMAs, but its shard_map
runs op by op then far slower than the suite's limit allows.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.models import megakernel as jmk
from opencl_path_tracer_tpu.models import wavefront as jwf
from opencl_path_tracer_tpu.ops import envmap as jenv
from opencl_path_tracer_tpu.ops import intersect as jis
from opencl_path_tracer_tpu.ops import nee as jnee
from opencl_path_tracer_tpu.ops.pallas.sorted_intersect import (
    make_pair_intersect as jpair,
)
from opencl_path_tracer_tpu.parallel import (
    make_render_mesh as jmesh, make_sample_sharded_render as jsample,
    make_tiled_step as jtiled, make_tiled_wavefront_step as jtiled_wf,
)
from opencl_path_tracer_tpu.parallel import shard as jshard_mod
from opencl_path_tracer_tpu.parallel.shard import (
    shard_state as jshard, shard_wavefront_state as jshard_wf,
)
from opencl_path_tracer_tpu.runtime.engine import make_intersect_fn as jmake
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch import interop
from opencl_path_tracer_tpu_torch.models import megakernel
from opencl_path_tracer_tpu_torch.ops import rng
from opencl_path_tracer_tpu_torch.parallel import (
    describe_devices, make_render_mesh, shard,
)
from opencl_path_tracer_tpu_torch.scene import library

import torch_world as tw

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

W, H, N = tw.W, tw.H, tw.W * tw.H
NAMES = ("mesh", "tiled", "sample", "4k", "wf_parity", "wf_fast", "pair",
         "nee_sphere", "env_nee")
FLOAT_V3 = ("colors", "ray_p", "ray_d", "cur_color")
INTS = ("samples", "pixel", "rng_state", "bounce", "inside")
# name -> (rtol, atol) of a float field against JAX (the module docstring).
JAX_TOL = {"colors": (1e-6, 0.0), "cur_color": (1e-6, 0.0),
           "ray_p": (1e-6, 5e-4), "ray_d": (0.0, 2.4e-7),
           "prev_pdf": (1e-6, 0.0)}
NEE_COLOR_TOL = (1e-4, 2e-5)


@pytest.fixture(scope="module")
def world():
    """rank -> scenario -> result, one world of 2 ranks."""
    return tw.launch_world(NAMES, 2)


@pytest.fixture(scope="module")
def world4():
    return tw.launch_world(("subset",), 4)


def _rows(world, name, field=None):
    """The ranks' rows of a sharded result, concatenated in rank order."""
    parts = [r[name] if field is None else r[name][field] for r in world]
    return np.concatenate(parts)


def _wf_rows(world, name):
    """The ranks' wavefront lanes (numpy, V3 fields stacked to (N, 3)),
    concatenated in rank order."""
    out = {}
    for f, v in world[0][name]["lanes"].items():
        if f == "step":
            out[f] = v
            continue
        parts = [r[name]["lanes"][f] for r in world]
        out[f] = (np.concatenate([np.stack(p, -1) for p in parts])
                  if isinstance(v, tuple) else np.concatenate(parts))
    return out


def _jax_fields(st):
    return {f: (np.stack([np.asarray(c) for c in getattr(st, f)], -1)
                if isinstance(getattr(st, f), tuple)
                else np.asarray(getattr(st, f)))
            for f in FLOAT_V3 + INTS + ("prev_pdf",)}


def _against_jax(port, jax_st, color_tol=None):
    """Integer state exactly, floats within JAX_TOL (colors within
    color_tol where given)."""
    ref = _jax_fields(jax_st)
    for f in INTS:
        np.testing.assert_array_equal(port[f].astype(ref[f].dtype), ref[f],
                                      err_msg=f)
    for f in FLOAT_V3 + ("prev_pdf",):
        rtol, atol = JAX_TOL[f]
        if color_tol is not None and f in ("colors", "cur_color"):
            rtol, atol = color_tol
        np.testing.assert_allclose(port[f], ref[f], rtol=rtol, atol=atol,
                                   err_msg=f)


def _single(name):
    st = tw.lanes_np(tw.wf_single(name))
    return {f: (np.stack(v, -1) if isinstance(v, tuple) else v)
            for f, v in st.items()}


def _equal_single(port, name):
    ref = _single(name)
    for f, v in ref.items():
        np.testing.assert_array_equal(port[f], v, err_msg=f)


def test_mesh_over_the_world(world):
    """make_render_mesh spans the world (2 ranks, axis 'd', each rank its
    coordinate) and refuses another count; outside a world it raises and
    names the launcher. The JAX mesh it stands for: 2 of the 8 virtual
    devices."""
    assert len(jax.devices()) == 8
    assert jmesh(2).devices.size == 2
    for rank, r in enumerate(world):
        m = r["mesh"]
        assert (m["rank"], m["size"], m["names"]) == (rank, 2, ("d",))
        assert m["axis"] == "d"
        assert "a mesh of 3 devices asked for in a world of 2" in m["refused"]
    with pytest.raises(RuntimeError, match="parallel.launch.launch"):
        make_render_mesh(2)
    rows = describe_devices(verbose=False, device="cpu")
    assert [r["platform"] for r in rows] == ["cpu"]


def test_tiled_step_matches_single_device_parity(world):
    """3 tiled parity samples: colors and Lehmer states torch.equal to the
    single-device render (and to the gathered frame on every rank), the
    meter the global mean within rtol 1e-5; against JAX's make_tiled_step
    the Lehmer states exactly, the colors within rtol 1e-6."""
    scene = library.cornell_box(with_spheres=False)
    ref = megakernel.render(library.cornell_camera(W, H), scene.mats,
                            intersect_fn=tw.bruteforce(scene), num_pixels=N,
                            iterations=3, spp=3, mode="parity", device="cpu")
    colors = _rows(world, "tiled", "colors")
    rng_state = _rows(world, "tiled", "rng")
    np.testing.assert_array_equal(colors, megakernel.colors_array(ref).numpy())
    np.testing.assert_array_equal(rng_state, ref.rng_state.numpy())
    for r in world:
        assert r["tiled"]["sample"] == 3
        np.testing.assert_array_equal(r["tiled"]["gathered"], colors)
        np.testing.assert_allclose(r["tiled"]["lums"][-1], colors.mean(),
                                   rtol=1e-5)

    js = jlib.cornell_box(with_spheres=False)
    mesh = jmesh(2)
    step = jtiled(jlib.cornell_camera(W, H), js.mats, mesh,
                  intersect_fn=functools.partial(jis.first_intersect,
                                                 tris=js.tris),
                  iterations=3, mode="parity")
    st = jshard(jmk.init_state(N, 1), mesh)
    for _ in range(3):
        st, lum = step(st)
    np.testing.assert_array_equal(rng_state.astype(np.uint32),
                                  np.asarray(st.rng_state))
    np.testing.assert_allclose(
        colors, np.stack([np.asarray(c) for c in st.colors], -1),
        rtol=1e-6, atol=0)
    np.testing.assert_allclose(world[0]["tiled"]["lums"][-1], float(lum),
                               rtol=1e-6)


def test_sample_sharded_render_equals_single_device(world):
    """Rank k renders samples k, k + 2, ... of key 11: the union is the
    sample set of a single-device 8-sample fast render, so the frames
    agree to reassociation (JAX's rtol 2e-5, atol 2e-6); against JAX's
    make_sample_sharded_render within rtol 1e-6; the same frame on both
    ranks."""
    img = world[0]["sample"]
    np.testing.assert_array_equal(world[1]["sample"], img)
    scene = library.cornell_box(with_spheres=False)
    ref = megakernel.render(library.cornell_camera(W, H), scene.mats,
                            intersect_fn=tw.bruteforce(scene), num_pixels=N,
                            iterations=3, spp=8, mode="fast", key=rng.key(11),
                            device="cpu")
    assert img.shape == (N, 3)
    np.testing.assert_allclose(img, megakernel.colors_array(ref).numpy(),
                               rtol=2e-5, atol=2e-6)
    js = jlib.cornell_box(with_spheres=False)
    render = jsample(jlib.cornell_camera(W, H), js.mats, jmesh(2),
                     intersect_fn=functools.partial(jis.first_intersect,
                                                    tris=js.tris),
                     iterations=3, num_pixels=N, samples_per_device=4,
                     key=jax.random.key(11))
    np.testing.assert_allclose(img, np.asarray(render()), rtol=1e-6, atol=0)


def _jax_wavefront(name, steps):
    """JAX's make_tiled_wavefront_step on 2 devices for a wavefront
    scenario of torch_world.wf_case."""
    key = jax.random.key(5)
    fast = dict(mode="fast", key=key)
    par = dict(mode="parity")
    if name in ("wf_parity", "wf_fast"):
        js = jlib.cornell_box(with_spheres=False)
        isect, iters = functools.partial(jis.first_intersect,
                                         tris=js.tris), 3
        init_kw = step_kw = par if name == "wf_parity" else fast
    elif name == "pair":
        js = jlib.stress_scene(1200)
        isect, iters = jpair(js.tris, interpret=True, **tw.PAIR_KW), 2
        init_kw = step_kw = par
    elif name == "nee_sphere":
        js = jlib.cornell_box(with_spheres=False, sphere_lamp=True)
        isect, iters = jmake(js, "bruteforce"), 3
        init_kw = fast
        step_kw = dict(fast, nee=jnee.build_emitter_table(js.tris, js.mats,
                                                          js.spheres))
    else:
        js = jlib.cornell_box(with_spheres=False)
        isect, iters = jmake(js, "bruteforce"), 3
        init_kw = fast
        step_kw = dict(fast, env=jenv.build_envmap(
            jenv.sun_sky(res=(64, 32)), sample_res=(32, 16), nee=True))
    cam = jlib.cornell_camera(W, H)
    mesh = jmesh(2)
    st = jshard_wf(jwf.init_wavefront(cam, N, seed=1, **init_kw), mesh)
    step = jtiled_wf(cam, js.mats, mesh, intersect_fn=isect,
                     iterations=iters, **step_kw)
    for _ in range(steps):
        st, lum = step(st)
    return st, float(lum)


def test_tiled_wavefront_with_pair_mxu_backend(world):
    """The pair intersector (mxu, thin, sort; stress_scene(1200)) inside
    the tiled wavefront: torch.equal to the single-device steps, and
    against JAX's (interpret-mode kernels) as the module docstring says."""
    port = _wf_rows(world, "pair")
    _equal_single(port, "pair")
    _against_jax(port, _jax_wavefront("pair", 2)[0])


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_tiled_wavefront_matches_single_device(world, mode):
    """5 tiled wavefront steps at 3 bounces: every lane field torch.equal
    to the single-device steps (fast mode through the ranks' lane
    offsets), the meter the global mean within rtol 1e-5, and against
    JAX's sharded steps."""
    name = "wf_" + mode
    port = _wf_rows(world, name)
    _equal_single(port, name)
    np.testing.assert_allclose(world[0][name]["lum"], port["colors"].mean(),
                               rtol=1e-5)
    st, lum = _jax_wavefront(name, 5)
    _against_jax(port, st)
    np.testing.assert_allclose(world[1][name]["lum"], lum, rtol=1e-6)


def test_tiled_step_on_subset_mesh(world4):
    """A world of 4 ranks (JAX: make_render_mesh(4) of its 8): one parity
    sample on 16x16; the counter at 1, a finite meter, the tiles equal to
    the single-device sample and, against JAX's, the Lehmer states
    exactly and the colors within rtol 1e-6."""
    w = h = 16
    assert [r["subset"]["size"] for r in world4] == [4] * 4
    for r in world4:
        assert r["subset"]["sample"] == 1
        assert np.isfinite(r["subset"]["lum"])
    colors = _rows(world4, "subset", "colors")
    scene = library.cornell_box(with_spheres=False)
    ref = megakernel.render(library.cornell_camera(w, h), scene.mats,
                            intersect_fn=tw.bruteforce(scene),
                            num_pixels=w * h, iterations=2, spp=1,
                            mode="parity", device="cpu")
    np.testing.assert_array_equal(colors, megakernel.colors_array(ref).numpy())
    js = jlib.cornell_box(with_spheres=False)
    mesh = jmesh(4)
    st, lum = jtiled(jlib.cornell_camera(w, h), js.mats, mesh,
                     intersect_fn=functools.partial(jis.first_intersect,
                                                    tris=js.tris),
                     iterations=2, mode="parity")(
        jshard(jmk.init_state(w * h, 1), mesh))
    assert int(st.sample) == 1
    np.testing.assert_array_equal(
        _rows(world4, "subset", "rng").astype(np.uint32),
        np.asarray(st.rng_state))
    np.testing.assert_allclose(
        colors, np.stack([np.asarray(c) for c in st.colors], -1),
        rtol=1e-6, atol=0)
    np.testing.assert_allclose(world4[0]["subset"]["lum"], float(lum),
                               rtol=1e-6)


def test_tiled_wavefront_sphere_emitter_nee_matches_single_device(world):
    """NEE with a sphere emitter, fast mode, 4 steps: torch.equal to the
    single-device steps; against JAX's, the colors within rtol 1e-4 and
    atol 2e-5 (the module docstring)."""
    port = _wf_rows(world, "nee_sphere")
    _equal_single(port, "nee_sphere")
    _against_jax(port, _jax_wavefront("nee_sphere", 4)[0],
                 color_tol=NEE_COLOR_TOL)


def test_tiled_wavefront_4k_partition(world):
    """tests/test_parallel.py's 4K shape check, cut to the partition: each
    of 2 ranks holds a contiguous tile of 4,147,200 of 3840 x 2160 pixel
    ids, their all_gather is the frame in order, and the meter over 4K
    lanes of ones is 1. (The JAX test traces 8.29M lanes; a port step at
    that size on the CPU would take the suite's time and memory.)"""
    for rank, r in enumerate(world):
        p = r["4k"]
        assert p["lanes"] == 3840 * 2160 // 2
        assert p["first"] == rank * p["lanes"]
        assert p["last"] == (rank + 1) * p["lanes"] - 1
        assert p["gathered"] and p["lum"] == 1.0


def test_tiled_wavefront_envmap_nee_matches_single_device(world):
    """The environment map with its NEE gather, fast mode, 4 steps:
    torch.equal to the single-device steps, and against JAX's."""
    port = _wf_rows(world, "env_nee")
    _equal_single(port, "env_nee")
    _against_jax(port, _jax_wavefront("env_nee", 4)[0])


def test_shard_spec_sort_and_split_match_jax():
    """wavefront_state_spec names JAX's placements (every lane field on
    the render axis, the step replicated), and the rank-local sort and
    split give each rank the rows of JAX's make_shard_sort_open_first and
    make_shard_split over 2 devices (permutations: bit for bit)."""
    spec = shard.wavefront_state_spec()
    jspec = jshard_mod.wavefront_state_spec()
    assert spec.replicated == ("step",)
    for f in spec.lane:
        p = getattr(jspec, f)
        assert (p[0] if isinstance(p, tuple) else p) == jax.sharding.\
            PartitionSpec("d"), f
    assert jspec.step == jax.sharding.PartitionSpec()
    st = tw.wf_single("wf_parity")
    open_mask = st.samples < int(st.samples.float().mean())
    jst = interop.wavefront_state_to_numpy(st)
    jst = jwf.WavefrontState(**{
        f: (tuple(jax.numpy.asarray(c) for c in v) if isinstance(v, tuple)
            else (jax.numpy.asarray(v, jax.numpy.uint32) if f == "step"
                  else jax.numpy.asarray(v)))
        for f, v in jst.items()})
    mesh = jmesh(2)
    jsorted = jshard_mod.make_shard_sort_open_first(mesh)(
        jshard_wf(jst, mesh), jax.numpy.asarray(open_mask.numpy()))
    jhead, jtail = jshard_mod.make_shard_split(mesh, 8)(jsorted)
    half = N // 2
    heads, tails = [], []
    for rank in range(2):
        rows = slice(rank * half, (rank + 1) * half)
        mine = dataclasses.replace(st, **{
            f: (tuple(c[rows] for c in getattr(st, f))
                if isinstance(getattr(st, f), tuple) else getattr(st, f)[rows])
            for f in spec.lane})
        srt = shard.make_shard_sort_open_first(None)(mine, open_mask[rows])
        head, tail = shard.make_shard_split(None, 8)(srt)
        heads.append(interop.wavefront_state_to_numpy(head))
        tails.append(interop.wavefront_state_to_numpy(tail))
    for parts, ref in ((heads, jhead), (tails, jtail)):
        for f in spec.lane:
            got = parts[0][f]
            if isinstance(got, tuple):
                for k in range(3):
                    np.testing.assert_array_equal(
                        np.concatenate([p[f][k] for p in parts]),
                        np.asarray(getattr(ref, f)[k]), err_msg=f)
            else:
                np.testing.assert_array_equal(
                    np.concatenate([p[f] for p in parts]).astype(
                        np.asarray(getattr(ref, f)).dtype),
                    np.asarray(getattr(ref, f)), err_msg=f)
