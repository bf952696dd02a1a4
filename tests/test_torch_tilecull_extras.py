"""The tilecull presort, the auto accel's host predictor and the engine's
re-pick in the port, against the JAX package on the CPU.

- `_presort_perm` equals the JAX package's interpret-mode permutation's
  first R entries (its pad lanes sort last) in both modes, with
  directions of +0.0 and -0.0; `make_tilecull_intersect(presort=...)`
  gives Hits and ids bit-equal to presort='none' and to the JAX
  package's interpret-mode intersector with the same presort; an
  unknown mode raises JAX's ValueError.
- `estimate_tile_need_fraction` == JAX's on the anchors of
  tests/test_tilecull.py (cornell at 5 and 1 bounces, reference from the
  Cornell preset at 1536x864, the dense cornell at n_tiles=8, which keeps
  it quick), and `auto_small_accel` at 0.55 picks as JAX's on their
  fractions and at both ends of its range.
- `make_intersect_fn(cam=...)` asks the predictor only on CUDA; the
  engine's `_maybe_repick_accel` builds one intersector per depth, is
  called by frame and render in both models and never replaces an
  injected intersector (enabled by hand on the CPU, the intersector's
  builds counted through a monkeypatch). A smooth untextured path whose
  pick is 'minarg' above 4,096 triangles takes 'pairwin' (the JAX engine
  passes 'minarg' on, and its smooth minarg refuses it: a divergence on
  purpose, ROADMAP.md queue 3).
- Its card twin is tests/test_torch_cuda.py::test_twenty_first_slice_*
  (the engine's pick on the card, the re-pick after a depth change, the
  presorted K6 torch.equal to 'none')."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.core.geometry import TrianglesSoA as JTris
from opencl_path_tracer_tpu.core.types import Rays as JRays
from opencl_path_tracer_tpu.ops.pallas import tilecull_kernel as jtk
from opencl_path_tracer_tpu.runtime import engine as jengine
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch.config import CameraConfig, RenderConfig
from opencl_path_tracer_tpu_torch.core.geometry import TrianglesSoA
from opencl_path_tracer_tpu_torch.core.types import Rays
from opencl_path_tracer_tpu_torch.ops.kernels import tilecull_kernel as tk
from opencl_path_tracer_tpu_torch.runtime import engine
from opencl_path_tracer_tpu_torch.scene import library as plib

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

MODELS = os.path.join(os.path.dirname(__file__), "assets", "models")
CORNELL_CAM = CameraConfig(fov=60.0, yaw=0.0, pitch=0.0,
                           shift=(0.0, 0.0, 0.0))


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _soup(t, seed=0, spread=10.0):
    rs = np.random.default_rng(seed)
    centers = rs.uniform(-spread, spread, size=(t, 1, 3))
    v = (centers + rs.normal(size=(t, 3, 3)) * 0.6).astype(np.float32)
    mati = np.arange(t, dtype=np.int32) % 7
    return (JTris.build(v[:, 0], v[:, 1], v[:, 2], mati),
            TrianglesSoA.build(v[:, 0], v[:, 1], v[:, 2], mati))


def _rays(n, seed, tris=None):
    """Random rays, a tenth axis-aligned with signed zeros on the other
    axes, and given tris half of the rest aimed near a centroid."""
    rs = np.random.default_rng(seed)
    p = rs.uniform(-12.0, 12.0, size=(n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    if tris is not None:
        cen = (tris.r1 + tris.r2 + tris.r3).numpy() / 3.0
        a = np.arange(n // 10, n // 10 + (n - n // 10) // 2)
        d[a] = cen[rs.integers(0, cen.shape[0], a.size)] - p[a]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    k = n // 10
    d[:k] = rs.choice(np.float32([0.0, -0.0]), size=(k, 3))
    d[np.arange(k), rs.integers(0, 3, size=k)] = rs.choice([-1.0, 1.0], k)
    return (JRays(p=tuple(jnp.asarray(p[:, k]) for k in range(3)),
                  d=tuple(jnp.asarray(d[:, k]) for k in range(3))),
            Rays(p=tuple(torch.from_numpy(p[:, k].copy()) for k in range(3)),
                 d=tuple(torch.from_numpy(d[:, k].copy())
                         for k in range(3))))


def _box(tris, gs):
    """The morton key's box as make_tilecull_intersect takes it."""
    _, _, boxes, _ = tk.build_groups(tris, gs)
    bx = np.asarray(boxes, np.float64)
    lo, hi = bx[:, 0, :].min(axis=0), bx[:, 1, :].max(axis=0)
    return (tuple(float(v) for v in lo),
            tuple(float(v) for v in 1.0 / np.maximum(hi - lo, 1e-12)))


@pytest.mark.parametrize("mode", ["octant", "morton"])
@pytest.mark.parametrize("n", [700, 5000])
def test_presort_perm_equals_jax(mode, n):
    jt, pt = _soup(300, seed=2)
    jr, pr = _rays(n, seed=n, tris=pt)
    lo, inv = _box(pt, 32)
    rpad = -(-n // 1024) * 1024
    ref = np.asarray(jtk._presort_perm(jr, n, rpad, mode, lo, inv))
    assert (ref[:n] < n).all() and (ref[n:] >= n).all()
    got = tk._presort_perm(pr, mode, lo, inv)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref[:n])
    # Signed zeros sort by their sign bit's comparison with 0: both >= 0.
    zero = (pr.d[0] == 0.0) & torch.signbit(pr.d[0])
    assert bool(zero.any())


@pytest.mark.parametrize("presort", ["octant", "morton"])
def test_presorted_tilecull_equals_none_and_jax(presort):
    jt, pt = _soup(200, seed=3)
    jr, pr = _rays(600, seed=4, tris=pt)
    origin = (0.0, 0.0, -30.0)
    h0, ids0 = tk.make_tilecull_intersect(pt, gs=32, with_ids=True,
                                          origin=origin)(pr)
    h1, ids1 = tk.make_tilecull_intersect(pt, gs=32, with_ids=True,
                                          origin=origin, presort=presort)(pr)
    jh, jids = jtk.make_tilecull_intersect(jt, gs=32, with_ids=True,
                                           origin=origin, presort=presort,
                                           interpret=True)(jr)
    for h in (h0, jh):
        np.testing.assert_array_equal(_bits(h1.t), _bits(h.t))
        np.testing.assert_array_equal(np.asarray(h1.mati), np.asarray(h.mati))
        for k in range(3):
            np.testing.assert_array_equal(_bits(h1.n[k]), _bits(h.n[k]))
            np.testing.assert_array_equal(_bits(h1.p[k]), _bits(h.p[k]))
    np.testing.assert_array_equal(ids1.numpy(), ids0.numpy())
    np.testing.assert_array_equal(ids1.numpy(), np.asarray(jids))
    assert (ids1 >= 0).sum() > 150
    hits = tk.make_tilecull_intersect(pt, gs=32, presort=presort)(pr)
    assert torch.equal(hits.t, h1.t)


def test_unknown_presort_raises():
    jt, pt = _soup(40)
    for make in (lambda: tk.make_tilecull_intersect(pt, presort="hilbert"),
                 lambda: jtk.make_tilecull_intersect(jt, presort="hilbert")):
        with pytest.raises(ValueError, match="unknown presort 'hilbert'"):
            make()


ANCHORS = {  # name: (JAX scene, port scene, camera size, bounces, n_tiles)
    "cornell": (lambda: jlib.cornell_box(with_spheres=True),
                lambda: plib.cornell_box(with_spheres=True),
                (1920, 1080), 5, 32),
    "cornell-i1": (lambda: jlib.cornell_box(with_spheres=True),
                   lambda: plib.cornell_box(with_spheres=True),
                   (1920, 1080), 1, 32),
    "reference": (lambda: jlib.reference_scene(MODELS),
                  lambda: plib.reference_scene(MODELS),
                  (1536, 864), 5, 32),
    "dense": (lambda: jlib.cornell_box(with_spheres=True,
                                       sphere_res=(26, 50)),
              lambda: plib.cornell_box(with_spheres=True,
                                       sphere_res=(26, 50)),
              (1920, 1080), 5, 8),
}


@pytest.mark.parametrize("name", list(ANCHORS))
def test_predictor_equals_jax_on_anchors(name, monkeypatch):
    jmake, pmake, (w, h), iters, n_tiles = ANCHORS[name]
    js, ps = jmake(), pmake()
    jcam, pcam = jlib.cornell_camera(w, h), plib.cornell_camera(w, h)
    ref = jtk.estimate_tile_need_fraction(js.tris, jcam, iterations=iters,
                                          n_tiles=n_tiles)
    got = tk.estimate_tile_need_fraction(ps.tris, pcam, iterations=iters,
                                         n_tiles=n_tiles)
    assert got == ref and 0.0 < got < 1.0
    # auto_small_accel's choice on this fraction, in both packages (the
    # estimate replaced by its value, asked with the same arguments).
    for mod, tris, cam in ((jtk, js.tris, jcam), (tk, ps.tris, pcam)):
        def fake(tris_, cam_, *, gs, iterations, tris=tris, cam=cam):
            assert tris_ is tris and cam_ is cam
            assert (gs, iterations) == (128, iters)
            return got
        monkeypatch.setattr(mod, "estimate_tile_need_fraction", fake)
    for thr in (0.55, got, np.nextafter(got, 1.0)):
        assert (tk.auto_small_accel(ps.tris, pcam, iterations=iters,
                                    threshold=thr)
                == jtk.auto_small_accel(js.tris, jcam, iterations=iters,
                                        threshold=thr))
    assert tk.auto_small_accel(ps.tris, pcam, iterations=iters) == (
        "tilecull" if got < 0.55 else "minarg")


@pytest.mark.parametrize("t", [128, 8193])
def test_auto_small_accel_range_edges(t, monkeypatch):
    """At most gs or above gs * MAX_GROUPS triangles: the fallback,
    without sampling."""
    jt, pt = _soup(t, seed=5, spread=100.0)
    for mod in (jtk, tk):
        monkeypatch.setattr(mod, "estimate_tile_need_fraction", None)
    cam = plib.cornell_camera(64, 64)
    for fb in ("minarg", "pairwin"):
        assert tk.auto_small_accel(pt, cam, fallback=fb) == fb
        assert jtk.auto_small_accel(jt, jlib.cornell_camera(64, 64),
                                    fallback=fb) == fb


def test_make_intersect_fn_asks_the_predictor_only_on_cuda(monkeypatch):
    calls = []
    monkeypatch.setattr(engine, "auto_small_accel",
                        lambda *a, **k: calls.append(k) or "tilecull")
    scene = plib.cornell_box(with_spheres=True)
    cam = plib.cornell_camera(32, 32)
    fn = engine.make_intersect_fn(scene, "auto", cam=cam, iterations=3)
    assert fn.accel == "minarg" and not calls
    assert engine.make_intersect_fn(scene, "tilecull", cam=cam).accel == \
        "tilecull"
    # The pick itself, as make_intersect_fn asks for it on CUDA.
    assert engine.predicted_accel(scene, cam, 3) == "tilecull"
    assert calls == [dict(iterations=3,
                          threshold=engine.AUTO_TILECULL_THRESHOLD)]


@pytest.mark.parametrize("t,smooth,want", [
    (5000, True, "pairwin"), (4096, True, "minarg"),
    (5000, False, "minarg")])
def test_smooth_pick_above_4096(t, smooth, want, monkeypatch):
    """The divergence on purpose: a smooth untextured pick of 'minarg'
    above SMOOTH_MINARG_MAX_TRIS is 'pairwin' (smooth 'auto''s choice
    there). The JAX engine passes 'minarg' on, and its smooth minarg
    raises above 4,096 triangles; the textured path (smooth=False here)
    keeps the pick: JAX's ids minarg has no cap."""
    monkeypatch.setattr(engine, "auto_small_accel", lambda *a, **k: "minarg")
    jt, pt = _soup(t, seed=6, spread=100.0)

    class S:   # the scene attributes predicted_accel reads
        tris, num_triangles = pt, t
    assert engine.predicted_accel(S, plib.cornell_camera(32, 32), 5,
                                  smooth) == want
    if want == "pairwin":
        js = jlib.cornell_box(with_spheres=True, smooth_spheres=True,
                              sphere_res=(30, 40))
        assert 4096 < js.num_triangles <= 8192
        with pytest.raises(ValueError, match="4096"):
            jengine._make_smooth_tri_fn(js, "minarg", force=False)


def _engine(model, **kw):
    cfg = RenderConfig(width=8, height=8, iterations=3, spp=1, model=model,
                       camera=CORNELL_CAM, **kw)
    return engine.RenderEngine(plib.cornell_box(with_spheres=True), cfg,
                               device="cpu")


@pytest.mark.parametrize("model", ["megakernel", "wavefront"])
def test_repick_caches_per_depth(model, monkeypatch):
    eng = _engine(model)
    assert eng._accel_auto is False    # the CPU keeps 'minarg'
    first = eng.intersect_fn
    assert first.accel == "minarg" and eng._accel_by_iters == {3: first}
    eng._accel_auto = True
    built = []
    real = engine.make_intersect_fn

    def counted(scene, accel, **kw):
        built.append((accel, kw["iterations"]))
        return real(scene, accel, **kw)

    monkeypatch.setattr(engine, "make_intersect_fn", counted)
    frame = (eng.frame if model == "megakernel"
             else lambda: eng.render(1, progress=False))
    frame()
    assert built == [] and eng.intersect_fn is first
    eng.controller.key_down("-")
    frame()
    assert built == [("auto", 2)] and eng.intersect_fn is not first
    second = eng.intersect_fn
    assert eng._accel_by_iters == {3: first, 2: second}
    eng.controller.key_down("+")
    frame()
    assert eng.intersect_fn is first
    eng.controller.key_down("-")
    eng.render(1, progress=False)
    assert built == [("auto", 2)] and eng.intersect_fn is second
    assert np.isfinite(eng.image()).all()


def test_repick_never_replaces_an_injected_intersector(monkeypatch):
    scene = plib.cornell_box(with_spheres=True)
    mine = engine.make_intersect_fn(scene, "minarg")
    eng = engine.RenderEngine(scene, RenderConfig(
        width=8, height=8, iterations=3, camera=CORNELL_CAM),
        intersect_fn=mine, device="cpu")
    assert eng._accel_auto is False
    monkeypatch.setattr(engine, "make_intersect_fn", None)
    eng.controller.key_down("-")
    eng.frame()
    assert eng.intersect_fn is mine
