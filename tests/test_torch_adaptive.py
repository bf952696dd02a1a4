"""Adaptive sampling in the port against the JAX package on the CPU:
the stop rule and the Welford update, `models.wavefront.render_adaptive`
(parity and fast mode, compaction on and off), the engine's
`render_adaptive`, `adaptive_prediction` and `render_adaptive_auto`, and
the CLI's `--adaptive`.

The port's wavefront step rounds as the JAX package's does op by op;
inside `jax.jit` XLA's CPU backend contracts multiply-adds (the step's
fold, `_luminance`) and approximates 1/sqrt in the camera rays. So the
bit-for-bit comparisons run JAX under `jax.disable_jit()`, with JAX's
XLA `first_intersect` against the port's plain one ('bruteforce'), on
the triangle Cornell box at a depth where one step is bit-equal in the
two packages (2 bounces in parity mode, 1 in fast mode; deeper paths
meet the glass sphere, where the packages differ by an ulp, as in
tests/test_torch_wavefront.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu import config as jconfig
from opencl_path_tracer_tpu.models import wavefront as jwf
from opencl_path_tracer_tpu.ops import intersect as jisect
from opencl_path_tracer_tpu.runtime import engine as jengine
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch import cli, interop
from opencl_path_tracer_tpu_torch.config import CameraConfig, RenderConfig
from opencl_path_tracer_tpu_torch.core import fp
from opencl_path_tracer_tpu_torch.models import wavefront
from opencl_path_tracer_tpu_torch.ops import rng
from opencl_path_tracer_tpu_torch.runtime import engine
from opencl_path_tracer_tpu_torch.scene import library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

W = H = 16
CAM = dict(fov=60.0, yaw=0.0, pitch=0.0, shift=(0.0, 0.0, 0.0))


def _scenes():
    js = jlib.cornell_box(with_spheres=True)
    ps = library.cornell_box(with_spheres=True)
    return (js, functools.partial(jisect.first_intersect, tris=js.tris),
            ps, engine.make_intersect_fn(ps, "bruteforce"))


def _by_pixel(pixel, values):
    out = np.zeros(W * H, np.asarray(values).dtype)
    out[np.asarray(pixel)] = np.asarray(values)
    return out


def _to_jax(st):
    f = interop.wavefront_state_to_numpy(st)
    return jwf.WavefrontState(**{
        k: (tuple(jnp.asarray(c) for c in v) if isinstance(v, tuple)
            else jnp.asarray(v, jnp.uint32) if k == "step"
            else jnp.asarray(v)) for k, v in f.items()})


def test_converged_mask_equals_jax():
    """A hypothesis property on seeded arrays: the port's mask and
    luminance equal JAX's op by op, and jitted JAX's luminance is
    fma(c, z, fma(a, x, b * y)) (the probe behind the module's note)."""
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies

    @hypothesis.settings(max_examples=40, deadline=None, derandomize=True)
    @hypothesis.given(seed=st.integers(0, 2**32 - 1),
                      tol=st.floats(1e-3, 0.5), min_samples=st.integers(0, 9))
    def check(seed, tol, min_samples):
        r = np.random.default_rng(seed)
        n = 512
        samples = r.integers(0, 24, n).astype(np.int32)
        scale = r.choice(np.float32([1e-3, 0.1, 1.0, 30.0]), (3, n))
        cols = tuple((r.random(n) * scale[k]).astype(np.float32)
                     for k in range(3))
        lum = (r.random(n) ** 3).astype(np.float32)
        mean = (0.2126 * cols[0] + 0.7152 * cols[1] + 0.0722 * cols[2])
        # m2 near the threshold, so that rounding decides some lanes.
        rhs = (tol * (mean + 0.05)) ** 2 * samples * (samples - 1.0)
        m2 = np.where(r.random(n) < 0.5, rhs, lum).astype(np.float32)
        m2 = np.where(r.random(n) < 0.25,
                      np.nextafter(m2, np.float32(np.inf)), m2)
        # XLA's CPU backend treats subnormal inputs as zero and torch does
        # not: no subnormal M2 (one would need a pixel whose luminances
        # differ by less than 1e-19).
        m2 = np.where(m2 < np.finfo(np.float32).tiny, 0, m2).astype(
            np.float32)
        pcols = tuple(torch.from_numpy(c) for c in cols)
        got = wavefront.converged_mask(torch.from_numpy(samples), pcols,
                                       torch.from_numpy(m2), tol,
                                       min_samples)
        jcols = tuple(jnp.asarray(c) for c in cols)
        with jax.disable_jit():
            ref = jwf.converged_mask(jnp.asarray(samples), jcols,
                                     jnp.asarray(m2), tol, min_samples)
            jlum = jwf._luminance(jcols)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(wavefront._luminance(pcols).numpy(),
                                      np.asarray(jlum))
        a, b, c = (torch.tensor(v, dtype=torch.float32)
                   for v in wavefront._LUM)
        fused = fp.fma(c, pcols[2], fp.fma(a, pcols[0], b * pcols[1]))
        np.testing.assert_array_equal(
            fused.numpy(), np.asarray(jax.jit(jwf._luminance)(jcols)))

    check()


@pytest.mark.parametrize("mode,iters", [("parity", 2), ("fast", 1)])
def test_welford_step_equals_jax(mode, iters):
    """Adaptive steps from one state: lum_m2, samples, colors and the
    Lehmer states equal JAX's bit for bit, and idle lanes stay idle."""
    js, jis, ps, pis = _scenes()
    jcam, pcam = jlib.cornell_camera(W, H), library.cornell_camera(W, H)
    pst = wavefront.init_wavefront(pcam, W * H, mode=mode, key=rng.key(3))
    kw = dict(iterations=iters, mode=mode, max_samples=9,
              variance_tol=0.1, min_samples=3)
    for s in range(8):
        jst = _to_jax(pst)
        pst = wavefront.wavefront_step(pcam, ps.mats, pst, intersect_fn=pis,
                                       key=rng.key(3), **kw)
        with jax.disable_jit():
            jst = jwf.wavefront_step(jcam, js.mats, jst, intersect_fn=jis,
                                     key=jax.random.key(3), **kw)
        for name in ("lum_m2", "samples", "rng_state"):
            np.testing.assert_array_equal(
                getattr(pst, name).numpy().astype(
                    np.asarray(getattr(jst, name)).dtype),
                np.asarray(getattr(jst, name)), err_msg=f"{s}: {name}")
        for k in range(3):
            np.testing.assert_array_equal(pst.colors[k].numpy(),
                                          np.asarray(jst.colors[k]))
    assert float(pst.lum_m2.max()) > 0
    done = wavefront.converged_mask(pst.samples, pst.colors, pst.lum_m2,
                                    0.1, 3)
    assert bool(done.any()) and bool((pst.samples < 9).any())


@pytest.mark.parametrize("mode,iters,cap", [("parity", 2, 16),
                                            ("fast", 1, 32)])
def test_render_adaptive_equals_jax(mode, iters, cap):
    """models.wavefront.render_adaptive, compaction on, equals JAX's bit
    for bit: colors, samples and M2 by pixel, and the lane order that
    compaction left (fast draws key on lane position)."""
    js, jis, ps, pis = _scenes()
    kw = dict(num_pixels=W * H, iterations=iters, tol=0.1, max_spp=cap,
              min_spp=2, mode=mode, seed=1, min_bucket=32)
    p = wavefront.render_adaptive(library.cornell_camera(W, H), ps.mats,
                                  intersect_fn=pis, device="cpu", **kw)
    with jax.disable_jit():
        j = jwf.render_adaptive(jlib.cornell_camera(W, H), js.mats,
                                intersect_fn=jis, **kw)
    np.testing.assert_array_equal(p.pixel.numpy(), np.asarray(j.pixel))
    np.testing.assert_array_equal(wavefront.colors_by_pixel(p, W * H).numpy(),
                                  jwf.colors_by_pixel(j, W * H))
    np.testing.assert_array_equal(p.samples.numpy(), np.asarray(j.samples))
    np.testing.assert_array_equal(p.lum_m2.numpy(), np.asarray(j.lum_m2))
    assert int(p.step) == int(j.step)
    # It compacted (the lanes moved) and adapted (spp varies).
    assert not np.array_equal(p.pixel.numpy(), np.arange(W * H))
    smp = p.samples.numpy()
    assert smp.min() >= 2 and smp.max() <= cap and smp.min() < smp.max()


@pytest.mark.parametrize("nee", [False, True])
def test_compaction_on_equals_off_in_parity(nee):
    """Parity mode without NEE: compaction on == off, bit for bit, at
    full depth. With NEE the gather's draws key on lane position, so
    compaction changes them (in JAX too); the render still adapts within
    its bounds."""
    kw = (dict(with_spheres=True, analytic_spheres=True, sphere_lamp=True)
          if nee else dict(with_spheres=True))
    scene = library.cornell_box(**kw)
    cam = library.cornell_camera(W, H)
    run = functools.partial(
        wavefront.render_adaptive, cam, scene.mats,
        intersect_fn=engine.make_intersect_fn(scene), num_pixels=W * H,
        iterations=3, tol=0.25, max_spp=12, min_spp=2, mode="parity",
        seed=1, min_bucket=32, device="cpu",
        nee=(engine.build_emitter_table(scene.tris, scene.mats,
                                        scene.spheres) if nee else None))
    a, b = run(compact=True), run(compact=False)
    sa = _by_pixel(a.pixel, a.samples)
    sb = _by_pixel(b.pixel, b.samples)
    assert not np.array_equal(a.pixel.numpy(), np.arange(W * H))
    assert sa.min() >= 2 and sa.max() <= 12 and sa.min() < sa.max()
    ca = wavefront.colors_by_pixel(a, W * H)
    cb = wavefront.colors_by_pixel(b, W * H)
    if nee:
        assert torch.isfinite(ca).all() and not torch.equal(ca, cb)
        return
    assert torch.equal(ca, cb)
    np.testing.assert_array_equal(sa, sb)


def test_state_split_concat_and_sort():
    cam = library.cornell_camera(4, 4)
    st = wavefront.init_wavefront(cam, 16, mode="parity")
    st = st.replace(samples=torch.arange(16, dtype=torch.int32), step=7)
    open_ = torch.tensor([i % 3 == 0 for i in range(16)])
    s = wavefront.sort_open_first(st, open_)
    want = [0, 3, 6, 9, 12, 15, 1, 2, 4, 5, 7, 8, 10, 11, 13, 14]
    assert s.samples.tolist() == want and s.pixel.tolist() == want
    assert torch.equal(s.ray_d[1], st.ray_d[1][want]) and s.step == 7
    head, tail = wavefront.state_split(s, 6)
    assert head.lanes == 6 and tail.lanes == 10 and tail.step == 7
    back = wavefront.state_concat([head.replace(step=9), tail])
    assert back.step == 9 and torch.equal(back.rng_state, s.rng_state)
    assert torch.equal(back.colors[2], s.colors[2])
    # 1080p's bucket ladder: eight halvings, the last to 8,100 (half of
    # it would be below min_bucket).
    sizes, b = [], 1920 * 1080
    while (t := wavefront.compact_target(b, b // 2, 4096)) < b:
        sizes.append(t)
        b = t
    assert sizes[0] == 1_036_800 and sizes[-1] == 8100 and len(sizes) == 8
    assert wavefront.compact_target(1920 * 1080, 1, 4096) == 8100
    assert wavefront.compact_target(8100, 1, 32) == 2025  # odd: stops


def _engines(model="wavefront", iters=2, **kw):
    js, jis, ps, _ = _scenes()
    jcfg = jconfig.RenderConfig(width=W, height=H, iterations=iters,
                                mode="parity", model=model,
                                camera=jconfig.CameraConfig(**CAM), **kw)
    pcfg = RenderConfig(width=W, height=H, iterations=iters, mode="parity",
                        model=model, accel="bruteforce",
                        camera=CameraConfig(**CAM), **kw)
    return (jengine.RenderEngine(js, jcfg, intersect_fn=jis),
            engine.RenderEngine(ps, pcfg, device="cpu"))


def test_engine_render_adaptive_equals_jax(monkeypatch):
    """The engine's adaptive render in parity mode equals the JAX
    engine's: the same samples by pixel, colors within 1e-6 (the JAX
    engine evaluates its steps through `lift_consts`' jaxpr, which rounds
    a few values an ulp away from its model's op-by-op steps: 15 of 768
    in a fixed 4-spp render). And it equals the port's
    `models.wavefront.render_adaptive` bit for bit (the same cadence and,
    with the bucket floor lowered to the model's min_bucket of 32, the
    same compaction), which test_render_adaptive_equals_jax holds to
    JAX's model."""
    monkeypatch.setattr(engine, "ADAPTIVE_MIN_BUCKET", 32)
    je, pe = _engines()
    pe.render_adaptive(0.1, max_spp=16, min_spp=2)
    p = pe.state
    ps = library.cornell_box(with_spheres=True)
    m = wavefront.render_adaptive(
        library.cornell_camera(W, H), ps.mats, intersect_fn=pe.intersect_fn,
        num_pixels=W * H, iterations=2, tol=0.1, max_spp=16, min_spp=2,
        mode="parity", seed=1, min_bucket=32, device="cpu")
    assert torch.equal(wavefront.colors_by_pixel(p, W * H),
                       wavefront.colors_by_pixel(m, W * H))
    np.testing.assert_array_equal(_by_pixel(p.pixel, p.samples),
                                  _by_pixel(m.pixel, m.samples))
    with jax.disable_jit():
        je.render_adaptive(0.1, max_spp=16, min_spp=2, progress=False)
    np.testing.assert_array_equal(_by_pixel(p.pixel, p.samples),
                                  _by_pixel(je.state.pixel, je.state.samples))
    np.testing.assert_allclose(pe.image(apply_tonemap=False),
                               je.image(apply_tonemap=False), rtol=1e-6,
                               atol=0)
    assert pe._sample_host == je._sample_host == int(p.samples.min())
    assert pe.adaptive_buckets[0] == W * H
    assert len(set(pe.adaptive_buckets)) > 1   # it compacted


def test_adaptive_prediction_and_auto_decision_equal_jax():
    """adaptive_prediction on one state equals JAX's (host float64, the
    same numbers), and render_adaptive_auto makes the JAX engine's
    decision on the same scene, with its prediction to 1e-6."""
    je, pe = _engines()
    pe.render_adaptive(0.05, max_spp=4, min_spp=4)
    je.state = _to_jax(pe.state)
    for tol, cap in ((0.05, 32), (0.3, 16), (0.01, 64)):
        assert pe.adaptive_prediction(tol, cap, 4) == \
            je.adaptive_prediction(tol, cap, 4)
    je, pe = _engines()
    got = pe.render_adaptive_auto(max_spp=10, tol=0.3, min_spp=3)
    with jax.disable_jit():
        ref = je.render_adaptive_auto(max_spp=10, tol=0.3, min_spp=3,
                                      progress=False)
    assert got[0] == ref[0]
    np.testing.assert_allclose(got[1:], ref[1:], rtol=1e-6)
    assert int(pe.state.samples.min()) == int(pe.state.samples.max()) == 10


def test_engine_refusals_and_bars():
    assert (engine.ADAPTIVE_MIN_PREDICTED_SPEEDUP,
            engine.ADAPTIVE_MAX_ZERO_VAR_FRAC,
            engine.ADAPTIVE_OVERHEAD_FACTOR) == (
        jengine.ADAPTIVE_MIN_PREDICTED_SPEEDUP,
        jengine.ADAPTIVE_MAX_ZERO_VAR_FRAC,
        jengine.ADAPTIVE_OVERHEAD_FACTOR)
    _, pe = _engines(model="megakernel")
    with pytest.raises(ValueError, match="needs model='wavefront'"):
        pe.render_adaptive(0.1, max_spp=4)


@pytest.mark.parametrize("adaptive", ["0.2", "auto"])
def test_cli_adaptive(adaptive, tmp_path, capsys):
    out = tmp_path / "a.png"
    rc = cli.main(["render", "--scene", "cornell", "--size", "16x12",
                   "--spp", "6", "--iters", "2", "--model", "wavefront",
                   "--adaptive", adaptive, "--adaptive-tol", "0.3",
                   "--min-spp", "2", "--device", "cpu", "--out", str(out)])
    assert rc == 0 and out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    err = capsys.readouterr().err
    assert "adaptive: spp min" in err
    assert ("adaptive auto ->" in err) == (adaptive == "auto")


@pytest.mark.parametrize("args,match", [
    (["--adaptive", "0.1"], "wavefront"),
    (["--adaptive", "garbage", "--model", "wavefront"],
     "tolerance or 'auto'")])
def test_cli_adaptive_refusals(args, match, tmp_path):
    with pytest.raises(SystemExit, match=match):
        cli.main(["render", "--size", "8x8", "--spp", "2", "--device",
                  "cpu", "--out", str(tmp_path / "x.png")] + args)
