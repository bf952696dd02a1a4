"""Thin-lens depth of field and the dormant sky light in the port against
the JAX package on the CPU: `raygen.camera_rays_dof` (the JAX package's
tests/test_dof.py), `megakernel.EnvLight` in both models
(tests/test_envlight.py), the DOF and environment options of
`RenderConfig` and the `--dof`, `--env*` and `--envmap` flags.

`camera_rays_dof` is camera_rays' IEEE operations plus cos and sin of the
lens angle, which round an ulp apart in XLA's and PyTorch's CPU
libraries: on 4,096 lanes at aperture 30 the origins differ at 10 of
12,288 values by 6.1e-5 (one ulp of coordinates between 512 and 1,024;
atol 5e-4 here, none beyond) and the directions at 14 by 1.2e-7 (atol
1e-6, none beyond); at apertures 0 and 5 they are bit-equal. Renders
compare with JAX op by op (`jax.disable_jit()`) at the tolerances of
tests/test_torch_megakernel.py's oracle comparison (rtol 2e-5, atol
2e-6); measured on the Cornell box: bit-equal but for 3 to 5 of 192
values an ulp apart from 3 bounces on (the glass sphere)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.models import megakernel as jmk
from opencl_path_tracer_tpu.models import wavefront as jwf
from opencl_path_tracer_tpu.ops import intersect as jisect
from opencl_path_tracer_tpu.ops import raygen as jraygen
from opencl_path_tracer_tpu.scene import builder as jbuilder
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch import cli, interop
from opencl_path_tracer_tpu_torch.config import CameraConfig, RenderConfig
from opencl_path_tracer_tpu_torch.core.types import Hits
from opencl_path_tracer_tpu_torch.models import megakernel, wavefront
from opencl_path_tracer_tpu_torch.ops import raygen, rng
from opencl_path_tracer_tpu_torch.runtime.engine import (
    RenderEngine, make_intersect_fn,
)
from opencl_path_tracer_tpu_torch.scene import builder, library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-6
W = H = 8
ENV = megakernel.EnvLight()
JENV = jmk.EnvLight()


def _np(x):
    if isinstance(x, tuple):
        return np.stack([_np(c) for c in x])
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def open_floor_scene(b):
    """tests/test_envlight.py's scene: a matte and a mirror floor at y = 0
    under the open sky, in the Cornell camera's frame, so that the three
    miss tiers (primary, specular only, after a diffuse bounce) all
    occur. b: either package's SceneBuilder."""
    matte = b.add_material((0.6, 0.5, 0.4), (1.0, 1.0, 1.0), (0, 0, 0),
                           (1, 1, 1), (0, 0, 0), 50.0, 0)
    mirror = b.add_material((0, 0, 0), (0, 0, 0), (0, 0, 0),
                            (0.2, 0.2, 0.2), (3.0, 3.0, 3.0), 0.0, 1)
    for mat, x0, x1 in ((matte, -4000.0, 500.0), (mirror, 500.0, 5000.0)):
        z0, z1 = -2000.0, 8000.0
        b.add_triangle((x0, 0, z0), (x1, 0, z0), (x1, 0, z1), mat)
        b.add_triangle((x0, 0, z0), (x1, 0, z1), (x0, 0, z1), mat)
    b.end_obj()
    return b.build()


def _lens_inputs(n, seed, one_pixel=False):
    rs = np.random.default_rng(seed)
    ids = (np.full(n, 400, np.int32) if one_pixel
           else rs.integers(0, 32 * 24, n).astype(np.int32))
    u = rs.random((4, n)).astype(np.float32)
    if one_pixel:
        u[0] = u[1] = 0.5
    return ids, u


@pytest.mark.parametrize("aperture,focus", [(30.0, 800.0), (0.0, 800.0),
                                            (5.0, 150.0)])
def test_camera_rays_dof_matches_jax(aperture, focus):
    ids, u = _lens_inputs(4096, 1)
    jr = jraygen.camera_rays_dof(jlib.cornell_camera(32, 24),
                                 jnp.asarray(ids), *(jnp.asarray(x)
                                                     for x in u),
                                 aperture, focus)
    pr = raygen.camera_rays_dof(library.cornell_camera(32, 24),
                                torch.from_numpy(ids),
                                *(torch.from_numpy(x) for x in u),
                                aperture, focus)
    np.testing.assert_allclose(_np(pr.p), _np(jr.p), rtol=0, atol=5e-4)
    np.testing.assert_allclose(_np(pr.d), _np(jr.d), rtol=0, atol=1e-6)


def test_dof_zero_aperture_is_pinhole():
    cam = library.cornell_camera(32, 24)
    ids, u = _lens_inputs(32 * 24, 0)
    ids = torch.arange(32 * 24, dtype=torch.int32)
    u = [torch.from_numpy(x) for x in u]
    pin = raygen.camera_rays(cam, ids, u[0], u[1])
    dof = raygen.camera_rays_dof(cam, ids, u[0], u[1], u[2], u[3], 0.0,
                                 800.0)
    np.testing.assert_allclose(_np(dof.p), _np(pin.p), atol=1e-4)
    np.testing.assert_allclose(_np(dof.d), _np(pin.d), atol=1e-5)


def test_dof_rays_converge_on_focal_plane():
    """The thin-lens property: a pixel's rays (same jitter, other lens
    points) meet on the focal plane and spread by about the aperture off
    it; the origins lie on the lens disk."""
    cam = library.cornell_camera(32, 24)
    ids, u = _lens_inputs(256, 1, one_pixel=True)
    ap, focus = 30.0, 800.0
    rays = raygen.camera_rays_dof(cam, torch.from_numpy(ids),
                                  *(torch.from_numpy(x) for x in u), ap,
                                  focus)
    eye = cam.eye.numpy().astype(np.float64)
    ahead = (cam.lookat - cam.eye).numpy().astype(np.float64)
    ahead /= np.linalg.norm(ahead)
    p = _np(rays.p).T.astype(np.float64)
    d = _np(rays.d).T.astype(np.float64)

    def spread_at(dist):
        t = (dist - (p - eye) @ ahead) / (d @ ahead)
        pts = p + d * t[:, None]
        return np.linalg.norm(pts - pts.mean(0), axis=-1).max()

    assert spread_at(focus) < 0.05
    assert spread_at(2 * focus) > 0.5 * ap
    assert spread_at(1.0) > 0.5 * ap
    r = np.linalg.norm(p - eye, axis=-1)
    assert r.max() <= ap + 1e-3 and r.max() > 0.7 * ap


def _setups():
    js = open_floor_scene(jbuilder.SceneBuilder())
    ps = open_floor_scene(builder.SceneBuilder())
    return (js, functools.partial(jisect.first_intersect, tris=js.tris),
            ps, make_intersect_fn(ps, "bruteforce"))


@pytest.mark.parametrize("mode", ["parity", "fast"])
@pytest.mark.parametrize("opt", ["env", "dof", "env+dof"])
def test_megakernel_env_light_and_dof_match_jax(mode, opt):
    """The open floor (all three miss tiers) at 3 bounces, and the Cornell
    box with its glass sphere at 5."""
    env = "env" in opt
    dof = (20.0, 600.0) if "dof" in opt else None
    js, jis, ps, pis = _setups()
    cases = [(js, jis, ps, pis, 3)]
    jc, pc = jlib.cornell_box(with_spheres=True), library.cornell_box(
        with_spheres=True)
    cases.append((jc, functools.partial(jisect.first_intersect,
                                        tris=jc.tris),
                  pc, make_intersect_fn(pc, "bruteforce"), 5))
    for j_s, j_is, p_s, p_is, iters in cases:
        kw = dict(num_pixels=W * H, iterations=iters, spp=2, mode=mode,
                  dof=dof)
        with jax.disable_jit():
            j = jmk.render(jlib.cornell_camera(W, H), j_s.mats,
                           intersect_fn=j_is, env=JENV if env else None,
                           **kw)
        p = megakernel.render(library.cornell_camera(W, H), p_s.mats,
                              intersect_fn=p_is, env=ENV if env else None,
                              device="cpu", **kw)
        np.testing.assert_allclose(megakernel.colors_array(p).numpy(),
                                   np.asarray(jmk.colors_array(j)),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(
            p.rng_state.numpy(), np.asarray(j.rng_state).astype(np.int64))


def test_env_light_tiers_and_wavefront_bit_identical():
    """Parity wavefront with exact_spp equals the megakernel with the sky
    on (had_diffuse per lane); all three tiers change the image."""
    _, _, ps, pis = _setups()
    cam = library.cornell_camera(W, H)
    kw = dict(num_pixels=W * H, iterations=3, mode="parity", device="cpu")
    mk = megakernel.render(cam, ps.mats, intersect_fn=pis, spp=2, env=ENV,
                           **kw)
    wf = wavefront.render_wavefront(cam, ps.mats, intersect_fn=pis,
                                    min_spp=2, exact_spp=True, env=ENV,
                                    **kw)
    assert torch.equal(megakernel.colors_array(mk),
                       wavefront.colors_by_pixel(wf, W * H))
    # Another deep color changes only the after-diffuse tier.
    other = megakernel.render(
        cam, ps.mats, intersect_fn=pis, spp=2,
        env=megakernel.EnvLight(deep=(0.0, 0.0, 0.0)), **kw)
    none = megakernel.render(cam, ps.mats, intersect_fn=pis, spp=2, **kw)
    a, b, c = (megakernel.colors_array(s) for s in (mk, other, none))
    assert not torch.equal(a, b) and not torch.equal(b, c)


def test_env_primary_miss_is_bare_sky():
    """A scene the camera never hits renders the sky color, sky * scale."""
    _, _, ps, _ = _setups()

    def never_hit(rays):
        n = rays.count
        z = torch.zeros(n)
        return Hits(t=torch.full((n,), -1.0), p=(z, z, z), n=(z, z, z),
                    mati=torch.zeros(n, dtype=torch.int32))

    env = megakernel.EnvLight(scale=0.5)
    st = megakernel.render(library.cornell_camera(4, 4), ps.mats,
                           intersect_fn=never_hit, num_pixels=16,
                           iterations=3, spp=2, mode="parity", env=env,
                           device="cpu")
    np.testing.assert_array_equal(
        megakernel.colors_array(st).numpy(),
        np.tile(np.float32(env.sky) * np.float32(0.5), (16, 1)))


def _to_jax(st):
    f = interop.wavefront_state_to_numpy(st)
    return jwf.WavefrontState(**{
        k: (tuple(jnp.asarray(c) for c in v) if isinstance(v, tuple)
            else jnp.asarray(v, jnp.uint32) if k == "step"
            else jnp.asarray(v)) for k, v in f.items()})


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_wavefront_dof_and_env_light_steps_match_jax(mode):
    """init_wavefront's lens draws (step 0, salt 4), and five steps with
    the sky and regenerated thin-lens rays, field by field."""
    js, jis, ps, pis = _setups()
    cam, jcam = library.cornell_camera(W, H), jlib.cornell_camera(W, H)
    dof = (20.0, 600.0)
    st = wavefront.init_wavefront(cam, W * H, mode=mode, key=rng.key(4),
                                  dof=dof)
    with jax.disable_jit():
        jst = jwf.init_wavefront(jcam, W * H, mode=mode,
                                 key=jax.random.key(4), dof=dof)
    for s in range(6):
        got = interop.wavefront_state_to_numpy(st)
        for name in ("ray_p", "ray_d", "colors", "cur_color"):
            np.testing.assert_allclose(_np(got[name]),
                                       _np(getattr(jst, name)), rtol=RTOL,
                                       atol=ATOL * 100 if name == "ray_p"
                                       else ATOL, err_msg=f"{s}: {name}")
        for name in ("samples", "bounce", "had_diffuse", "rng_state"):
            np.testing.assert_array_equal(
                got[name].astype(np.int64),
                np.asarray(getattr(jst, name)).astype(np.int64),
                err_msg=f"{s}: {name}")
        jst = _to_jax(st)
        st = wavefront.wavefront_step(cam, ps.mats, st, intersect_fn=pis,
                                      iterations=3, mode=mode,
                                      key=rng.key(4), env=ENV, dof=dof)
        with jax.disable_jit():
            jst = jwf.wavefront_step(jcam, js.mats, jst, intersect_fn=jis,
                                     iterations=3, mode=mode,
                                     key=jax.random.key(4), env=JENV,
                                     dof=dof)
    assert bool(st.had_diffuse.any()) and int(st.samples.sum()) > 0


def _cfg(**kw):
    return RenderConfig(width=8, height=8, iterations=2, spp=1,
                        camera=CameraConfig(fov=60.0, yaw=0.0, pitch=0.0,
                                            shift=(0.0, 0.0, 0.0)), **kw)


@pytest.mark.parametrize("kw,match", [
    (dict(env_map="sunsky", env_light=True), "mutually exclusive"),
    (dict(env_map="sunsky", env_scale=0.0), "env_scale"),
    (dict(env_map="sunsky", env_sample_res=(0, 8)), "env_sample_res"),
    (dict(env_sky=(1.0, 2.0)), "3-tuples"),
    (dict(dof_aperture=-1.0), "dof_aperture"),
    (dict(dof_aperture=5.0), "dof_focus"),
])
def test_config_env_and_dof_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        _cfg(**kw).validate()


def test_config_env_and_dof_accepted_and_roundtrip():
    cfg = _cfg(env_map="gradient", env_scale=2.0, env_nee=False,
               env_sample_res=(32, 16), dof_aperture=5.0, dof_focus=400.0)
    assert RenderConfig.from_json(cfg.to_json()) == cfg.validate()
    e = RenderEngine(library.cornell_box(with_spheres=False),
                     dataclasses.replace(cfg, model="wavefront"),
                     device="cpu")
    assert e.dof == (5.0, 400.0) and e.env.nee is False
    assert e.env.Ws == 32 and e.occluded is None   # no gather: no K7
    e = RenderEngine(library.cornell_box(with_spheres=False),
                     _cfg(env_light=True, env_sky=(1.0, 0.5, 0.25)),
                     device="cpu")
    assert e.env == megakernel.EnvLight(sky=(1.0, 0.5, 0.25))


@pytest.mark.parametrize("args", [
    ["--envmap", "sunsky"],
    ["--envmap", "gradient", "--no-env-nee", "--env-scale", "2",
     "--model", "wavefront"],
    ["--env", "--env-sky", "1", "1", "1", "--env-deep", "0", "0", "0"],
    ["--dof", "20", "600", "--model", "wavefront"],
    ["--envmap", "sunsky", "--nee", "--no-nee-anyhit"],
])
def test_cli_env_and_dof_flags(args, tmp_path, capsys, monkeypatch):
    seen = {}
    real = RenderEngine.__init__

    def spy(self, scene, cfg, *a, **kw):
        seen["cfg"] = cfg
        real(self, scene, cfg, *a, **kw)

    monkeypatch.setattr(RenderEngine, "__init__", spy)
    out = tmp_path / "o.png"
    assert cli.main(["render", "--scene", "cornell-empty", "--size", "8x8",
                     "--spp", "1", "--iters", "2", "--device", "cpu",
                     "--out", str(out)] + args) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    cfg = seen["cfg"]
    if "--envmap" in args:
        assert cfg.env_map == args[args.index("--envmap") + 1]
        assert cfg.env_nee == ("--no-env-nee" not in args)
        assert cfg.nee_anyhit == ("--no-nee-anyhit" not in args)
    if "--env" in args:
        assert cfg.env_light and cfg.env_sky == (1.0, 1.0, 1.0)
        assert cfg.env_deep == (0.0, 0.0, 0.0)
    if "--dof" in args:
        assert (cfg.dof_aperture, cfg.dof_focus) == (20.0, 600.0)
    if "--env-scale" in args:
        assert cfg.env_scale == 2.0
