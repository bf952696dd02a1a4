"""The engine's and the CLI's sharded paths (`RenderEngine` with devices
!= 1, `ptx-torch render --devices N`) on the CPU: twins of the JAX
engine's tests (tests/test_runtime.py's multi-device tests,
tests/test_adaptive.py's mesh-sharded adaptive render,
tests/test_envlight.py's tiled step) in one gloo world of 2 ranks
(`tests/torch_world.py`), against the port's single-device engine and
the JAX package.

Over 2 ranks the parity megakernel, the wavefront in both modes and the
adaptive render without NEE are torch.equal to one device. The fast
megakernel is not, in JAX either: each tile keys its draws on its first
pixel id, so each rank's rows are held to `trace_sample(ids=offset)` on
that tile in one process, and to JAX's make_tiled_step within the
tolerance of tests/test_torch_parallel.py's module docstring for NEE
(JAX's jit contracts the NEE arithmetic into FMAs)."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu import cli as jcli
from opencl_path_tracer_tpu.io import checkpoint as jcheckpoint
from opencl_path_tracer_tpu.models import megakernel as jmk
from opencl_path_tracer_tpu.ops import nee as jnee
from opencl_path_tracer_tpu.parallel import (
    make_render_mesh as jmesh, make_tiled_step as jtiled,
)
from opencl_path_tracer_tpu.parallel.shard import shard_state as jshard
from opencl_path_tracer_tpu.runtime.engine import make_intersect_fn as jmake
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch import cli
from opencl_path_tracer_tpu_torch.config import RenderConfig
from opencl_path_tracer_tpu_torch.io.image import read_png
from opencl_path_tracer_tpu_torch.models import megakernel, wavefront
from opencl_path_tracer_tpu_torch.runtime import engine

import torch_world as tw

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

EN = tw.EW * tw.EH
NAMES = ("engine_mega", "engine_fast_tiles", "engine_wavefront:parity",
         "engine_wavefront:fast", "engine_adaptive", "engine_errors")


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("world"))


@pytest.fixture(scope="module")
def world(tmp):
    return tw.launch_world(NAMES, 2, tmp)


def _single(spp=4, progress=False, **kw):
    eng = tw.make_engine(1, **kw)
    eng.render(spp, progress=progress)
    return eng


def test_engine_devices2_megakernel_equals_single(world):
    """devices=2, parity: 4 samples torch.equal to one device's image on
    both ranks; the world's rays (after the render's all_reduce) and the
    meter's estimate (its calibration all_reduce'd, after the first
    sample) equal one device's."""
    one = _single(progress=True)
    img = one.image(apply_tonemap=False)
    for r in world:
        m = r["engine_mega"]
        np.testing.assert_array_equal(m["image"], img)
        assert m["rays"] == one.rays_traced
        assert m["est"] == one.estimated_rays(4)
    assert [r["engine_mega"]["rank"] for r in world] == [0, 1]


def test_engine_frame_refuses_the_mesh(world):
    for r in world:
        assert "single-device" in r["engine_mega"]["frame"]


def test_engine_checkpoint_resumes_across_device_counts(world, tmp):
    """A single-device checkpoint resumed on 2 ranks and a 2-rank one
    resumed on one device both finish as the uninterrupted single-device
    render; the 2-rank file holds the gathered state, array for array the
    single-device file's, in the JAX package's format (its loader reads
    it). The display frame over the mesh is to_uint8 of the gathered
    image (display_u8_device is None, as in the JAX engine)."""
    one = _single()
    img = one.image(apply_tonemap=False)
    for r in world:
        np.testing.assert_array_equal(r["engine_mega"]["resumed"], img)
        np.testing.assert_array_equal(r["engine_mega"]["display"],
                                      one.display_u8())
        assert r["engine_mega"]["display_device"] is None
    back = tw.make_engine(1)
    back.load(os.path.join(tmp, "mega2.npz"))
    assert back.state.sample == 2
    back.render(2, progress=False)
    np.testing.assert_array_equal(back.image(apply_tonemap=False), img)
    jst2, meta2 = jcheckpoint.load_checkpoint(os.path.join(tmp, "mega2.npz"))
    jst1, _ = jcheckpoint.load_checkpoint(os.path.join(tmp, "mega1.npz"))
    assert meta2["model"] == "megakernel" and int(jst2.sample) == 2
    for a, b in zip(jst2.colors, jst1.colors):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(jst2.rng_state),
                                  np.asarray(jst1.rng_state))


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_engine_devices2_wavefront_equals_single(world, tmp, mode):
    """devices=2, the wavefront: 3 samples torch.equal to one device's
    image, the floor 3, the steps and the world's rays one device's; its
    2-sample checkpoint resumes on one device and 1 more sample gives one
    device's render(2) then render(1) (in fast mode not render(3): the
    cap of 2 idles lanes, and the draws key on the step counter)."""
    one = _single(3, model="wavefront", mode=mode)
    img = one.image(apply_tonemap=False)
    for r in world:
        w = r[f"engine_wavefront:{mode}"]
        np.testing.assert_array_equal(w["image"], img)
        assert w["floor"] == 3 and w["steps"] == one.steps_run
        assert w["rays"] == one.rays_traced
    back = tw.make_engine(1, model="wavefront", mode=mode)
    back.load(os.path.join(tmp, f"wf_{mode}2.npz"))
    assert back._sample_host == 2
    back.render(1, progress=False)
    ref = _single(2, model="wavefront", mode=mode)
    ref.render(1, progress=False)
    np.testing.assert_array_equal(back.image(apply_tonemap=False),
                                  ref.image(apply_tonemap=False))


def test_engine_divisibility_and_count_errors(world):
    """Inside a world: 15x3 = 45 pixels do not divide over 2 ranks (the
    JAX engine's message), and devices=3 in a world of 2 is refused."""
    for r in world:
        e = r["engine_errors"]
        assert e["divide"] == ("15x3 = 45 pixels must divide evenly over "
                               "2 devices")
        assert "a mesh of 3 devices asked for in a world of 2" in e["count"]


def test_engine_devices_outside_a_world_and_negative():
    """devices=-1 is refused by validate() (the JAX message); devices=2 in
    a process outside a world raises and names the launcher."""
    with pytest.raises(ValueError, match=r"devices must be >= 0 \(0 = all\)"):
        RenderConfig(devices=-1).validate()
    with pytest.raises(RuntimeError, match="parallel.launch.launch"):
        tw.make_engine(2)


def test_engine_adaptive_mesh_matches_single_device(world, monkeypatch):
    """tests/test_adaptive.py's mesh-sharded adaptive render on 2 ranks
    (parity, no NEE, the bucket floor at 32 in each rank): colors and
    samples by pixel torch.equal to the single-device adaptive render;
    each rank's bucket halved at least once; the samples between 2 and 12
    and not all equal; the state split evenly across the ranks."""
    monkeypatch.setattr(engine, "ADAPTIVE_MIN_BUCKET", 32)
    one = tw.make_engine(1, width=32, height=16, model="wavefront", spp=12)
    one.render_adaptive(0.25, max_spp=12, min_spp=2, progress=False)
    colors = wavefront.colors_by_pixel(one.state, 32 * 16).numpy()
    smp = np.zeros(32 * 16, np.int32)
    smp[one.state.pixel.numpy()] = one.state.samples.numpy()
    got = np.zeros(32 * 16, np.int32)
    for r in world:
        a = r["engine_adaptive"]
        np.testing.assert_array_equal(a["colors"], colors)
        assert a["buckets"][0] == 256 and len(set(a["buckets"])) > 1
        assert a["floor"] == one._sample_host
        assert a["pixel"].shape == (256,)
        got[a["pixel"]] = a["samples"]
    np.testing.assert_array_equal(got, smp)
    assert smp.min() >= 2 and smp.max() <= 12 and smp.min() < smp.max()
    # the gathered state is the ranks' lanes in rank order
    whole = world[0]["engine_adaptive"]["whole"]["pixel"]
    np.testing.assert_array_equal(
        whole, np.concatenate([r["engine_adaptive"]["pixel"] for r in world]))


def test_engine_fast_megakernel_tiles(world):
    """devices=2, fast mode with NEE, 2 samples: each rank's tile equals
    trace_sample(ids=its first pixel id) on that tile in one process, and
    JAX's make_tiled_step (2 devices) within rtol 1e-4, atol 2e-5."""
    half = EN // 2
    eng = tw.make_engine(1, mode="fast", nee=True)
    full = megakernel.init_state(EN, 1)
    cam = eng.camera
    ref = []
    for rank in range(2):
        rows = slice(rank * half, (rank + 1) * half)
        st = dataclasses.replace(
            full, colors=tuple(c[rows].clone() for c in full.colors),
            rng_state=full.rng_state[rows].clone())
        for _ in range(2):
            st = megakernel.trace_sample(
                cam, eng.scene.mats, st, intersect_fn=eng.intersect_fn,
                iterations=3, mode="fast", key=eng.key, nee=eng.nee,
                ids=rank * half)
        ref.append(megakernel.colors_array(st).numpy())
        np.testing.assert_array_equal(world[rank]["engine_fast_tiles"],
                                      ref[-1])
    js = jlib.cornell_box(with_spheres=True)
    mesh = jmesh(2)
    jcam = jlib.cornell_camera(tw.EW, tw.EH)
    step = jtiled(jcam, js.mats, mesh, intersect_fn=jmake(js, "bruteforce"),
                  iterations=3, mode="fast", key=jax.random.key(1),
                  nee=jnee.build_emitter_table(js.tris, js.mats, js.spheres))
    st = jshard(jmk.init_state(EN, 1), mesh)
    for _ in range(2):
        st, _lum = step(st)
    np.testing.assert_allclose(
        np.concatenate(ref), np.stack([np.asarray(c) for c in st.colors], -1),
        rtol=1e-4, atol=2e-5)


def _cli_args(out, devices, *extra):
    return ["render", "--scene", "cornell", "--size", f"{tw.EW}x{tw.EH}",
            "--spp", "2", "--iters", "3", "--mode", "parity", "--accel",
            "bruteforce", "--devices", str(devices), "--out", out, *extra]


def test_cli_render_devices(tmp_path, capfd):
    """`ptx-torch render --devices 2 --device cpu --mode parity` (2 gloo
    ranks; rank 0 prints and writes) writes the PNG that --devices 1
    writes, byte for byte, and its checkpoint; JAX's `ptx render --devices
    2` (2 of its 8 virtual devices, jitted) writes one within 1 of 255 of
    it (the jit's FMAs move a colour by an ulp, which can cross a
    quantisation step). --devices 0 with --device cpu and --dispersion
    with --devices are refused."""
    a, b, c = (str(tmp_path / f"{k}.png") for k in "abc")
    ck = str(tmp_path / "ck.npz")
    assert cli.main(_cli_args(a, 2, "--device", "cpu", "--checkpoint",
                              ck)) == 0
    err = capfd.readouterr().err
    assert err.count(f"wrote {a}") == 1 and "2 x cpu" in err
    assert cli.main(_cli_args(b, 1, "--device", "cpu")) == 0
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert jcli.main(_cli_args(c, 2)) == 0
    diff = np.abs(read_png(a).astype(int) - read_png(c).astype(int))
    assert diff.max() <= 1
    st, meta = jcheckpoint.load_checkpoint(ck)
    assert meta["model"] == "megakernel" and int(st.sample) == 2
    with pytest.raises(SystemExit, match="--devices 0 is every visible GPU"):
        cli.main(_cli_args(a, 0, "--device", "cpu"))
    with pytest.raises(SystemExit, match="does not compose with --devices"):
        cli.main(_cli_args(a, 2, "--device", "cpu", "--model", "wavefront",
                           "--dispersion", "30"))
