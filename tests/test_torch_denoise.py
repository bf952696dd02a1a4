"""The à-trous denoiser, its primary-ray guides and the 3x3 median filter
in the port against the JAX package on the CPU: `ops.denoise.
primary_aovs`, `atrous_denoise`, `ops.median_filter.median3x3`,
`RenderEngine.denoised_image` in both models, and the CLI's `--denoise`
(PNG, PFM, NPY) and `--median`, which are exclusive.

Tolerances, measured on this package's tests' inputs:
- `primary_aovs` is bit-equal to JAX's (its elementwise operations
  eager, each its own computation, so nothing is contracted; the
  intersector interpret-mode minarg, whose t the port's K1 path rounds
  as; JAX's XLA `first_intersect` rounds t differently).
- `atrous_denoise` calls exp and log1p, which differ by ulps between the
  libraries: against JAX op by op and jitted, at most 4.2e-6 relative
  (27-51 % of the values differ); held to ATROUS_RTOL = 2e-5.
- `median3x3` is bit-equal to JAX's eager call (the CLI's): its grey is
  `jnp.mean`'s jitted rounding, ((r + g) + b) * float32(1/3); under
  `jax.disable_jit()` `jnp.mean` divides by 3 instead, and an ulp there
  can pick another neighbour.
- `denoised_image` against the jitted JAX engine's (XLA `first_intersect`
  on its side): at most 5.3e-6 relative; held to ATROUS_RTOL."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.config import CameraConfig as JCameraConfig
from opencl_path_tracer_tpu.config import RenderConfig as JRenderConfig
from opencl_path_tracer_tpu.ops import denoise as jdenoise
from opencl_path_tracer_tpu.ops import median_filter as jmedian
from opencl_path_tracer_tpu.ops.pallas.plucker_kernel import (
    make_minarg_intersect as jminarg,
)
from opencl_path_tracer_tpu.runtime.engine import RenderEngine as JEngine
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch import cli
from opencl_path_tracer_tpu_torch.config import CameraConfig, RenderConfig
from opencl_path_tracer_tpu_torch.io.image import read_pfm, read_png
from opencl_path_tracer_tpu_torch.models import megakernel
from opencl_path_tracer_tpu_torch.ops import denoise, median_filter
from opencl_path_tracer_tpu_torch.runtime.engine import (
    RenderEngine, make_intersect_fn,
)
from opencl_path_tracer_tpu_torch.scene import library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

ATROUS_RTOL = 2e-5
W, H = 24, 16
PRESET = dict(fov=60.0, yaw=0.0, pitch=0.0, shift=(0.0, 0.0, 0.0))


@functools.lru_cache(maxsize=None)
def _aovs():
    """Both packages' guides of the Cornell box (spheres tessellated),
    and the port's 2-spp fast render of it."""
    js = jlib.cornell_box(with_spheres=True)
    ps = library.cornell_box(with_spheres=True)
    jn, jd = jdenoise.primary_aovs(jlib.cornell_camera(W, H), js.mats,
                                   jminarg(js.tris, interpret=True), W, H)
    pis = make_intersect_fn(ps, "minarg")
    pn, pd = denoise.primary_aovs(library.cornell_camera(W, H), ps.mats,
                                  pis, W, H)
    st = megakernel.render(library.cornell_camera(W, H), ps.mats,
                           intersect_fn=pis, num_pixels=W * H, iterations=3,
                           spp=2, mode="fast", device="cpu")
    colors = megakernel.colors_array(st).reshape(H, W, 3)
    return (np.asarray(jn), np.asarray(jd)), (pn, pd), colors


def test_primary_aovs_bit_equal_to_jax():
    (jn, jd), (pn, pd), _ = _aovs()
    assert pn.shape == (H, W, 3) and pd.shape == (H, W)
    np.testing.assert_array_equal(pn.numpy(), jn)
    np.testing.assert_array_equal(pd.numpy(), jd)
    hit = pd.numpy() > 0
    assert hit.mean() > 0.9
    np.testing.assert_allclose(np.linalg.norm(pn.numpy(), axis=-1)[hit], 1.0,
                               atol=1e-4)


def test_primary_aovs_misses_and_textured_tuple():
    """Misses (a camera outside the box, looking away from it) get normal
    0 and depth -1; a (Hits, kd) intersector gives the same guides as
    its Hits alone."""
    ps = library.cornell_box(with_spheres=True)
    isect = make_intersect_fn(ps, "bruteforce")
    cam = library.cornell_camera(8, 8)
    outside = CameraConfig(fov=60.0, yaw=180.0, pitch=0.0,
                           shift=(0.0, 0.0, -4000.0))
    from opencl_path_tracer_tpu_torch.runtime.controller import (
        CameraController,
    )
    away = CameraController(RenderConfig(width=8, height=8, camera=outside),
                            device="cpu").camera(8, 8)
    n0, d0 = denoise.primary_aovs(away, ps.mats, isect, 8, 8)
    miss = d0 == -1.0
    assert miss.any() and (~miss).any()
    assert (n0[miss] == 0.0).all() and (d0[~miss] > 0.0).all()
    a = denoise.primary_aovs(cam, ps.mats, isect, 8, 8)
    b = denoise.primary_aovs(cam, ps.mats,
                             lambda r: (isect(r), (1.0, 1.0, 1.0)), 8, 8)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("kw,op_by_op", [
    (dict(), False), (dict(iterations=3, clamp_percentile=None), False),
    (dict(iterations=2, clamp_percentile=90.0, sigma_color=1.0,
          sigma_normal=0.5, sigma_depth=0.2), True)])
def test_atrous_denoise_matches_jax(kw, op_by_op):
    """Against the jitted JAX filter, and (two iterations: op by op costs
    seconds an iteration) against its op-by-op evaluation."""
    (jn, jd), (pn, pd), colors = _aovs()
    args = (jnp.asarray(colors.numpy()), jnp.asarray(jn), jnp.asarray(jd))
    got = denoise.atrous_denoise(colors, pn, pd, **kw).numpy()
    jitted = jax.jit(functools.partial(jdenoise.atrous_denoise, **kw))
    np.testing.assert_allclose(got, np.asarray(jitted(*args)),
                               rtol=ATROUS_RTOL, atol=0)
    if op_by_op:
        with jax.disable_jit():
            ref = jdenoise.atrous_denoise(*args, **kw)
        np.testing.assert_allclose(got, np.asarray(ref), rtol=ATROUS_RTOL,
                                   atol=0)
    assert np.isfinite(got).all() and not np.array_equal(got, colors)


def test_atrous_fixed_point_and_edges():
    """A flat image with flat guides passes through; a guide edge keeps
    the two sides' means while the noise within each drops (JAX's
    tests/test_denoise.py)."""
    c = torch.full((12, 16, 3), 0.7)
    n = torch.zeros(12, 16, 3)
    n[..., 2] = 1.0
    out = denoise.atrous_denoise(c, n, torch.full((12, 16), 5.0),
                                 iterations=3)
    np.testing.assert_allclose(out.numpy(), 0.7, atol=1e-5)
    rs = np.random.default_rng(0)
    base = np.full((16, 32, 3), 0.2, np.float32)
    base[:, 16:] = 0.9
    noisy = base + rs.normal(0, 0.08, base.shape).astype(np.float32)
    nrm = np.zeros((16, 32, 3), np.float32)
    nrm[:, :16, 2] = 1.0
    nrm[:, 16:, 0] = 1.0
    dep = np.where(np.arange(32)[None, :] < 16, 3.0, 9.0).astype(
        np.float32).repeat(16, 0)
    out = denoise.atrous_denoise(torch.from_numpy(noisy),
                                 torch.from_numpy(nrm),
                                 torch.from_numpy(dep), iterations=3).numpy()
    assert out[:, 4:12].std() < 0.35 * noisy[:, 4:12].std()
    assert abs(out[:, :14].mean() - 0.2) < 0.03
    assert abs(out[:, 18:].mean() - 0.9) < 0.03


def _tied_image():
    """Random colours, a block whose pixels share the grey 0.25 in two
    colours, and a stripe of four colours of two greys: equal greys with
    different colours around many medians."""
    rs = np.random.default_rng(0)
    img = rs.random((H, W, 3)).astype(np.float32)
    img[4:10, 4:12] = 0.25
    img[4:10, 8:12] = np.float32([0.75, 0.0, 0.0])
    pal = np.float32([[0.3, 0.6, 0.0], [0.6, 0.3, 0.0], [0.0, 0.3, 0.6],
                      [0.9, 0.0, 0.0]])
    img[:, 18:] = pal[rs.integers(0, 4, (H, W - 18))]
    img[0, 5:9] = 0.0    # black misses on the kept top row
    return img


@pytest.mark.parametrize("tonemap", [True, False])
def test_median3x3_bit_equal_to_jax(tonemap):
    img = _tied_image()
    ref = np.asarray(jmedian.median3x3(jnp.asarray(img), tonemap=tonemap))
    got = median_filter.median3x3(torch.from_numpy(img), tonemap=tonemap)
    np.testing.assert_array_equal(got.numpy(), ref)
    # The border quirk: row 0 and column 0 keep the (tonemapped) input.
    from opencl_path_tracer_tpu_torch.ops.tonemap import filmic
    base = filmic(torch.from_numpy(img)) if tonemap else torch.from_numpy(img)
    assert torch.equal(got[0], base[0]) and torch.equal(got[:, 0],
                                                        base[:, 0])
    assert not torch.equal(got[1:, 1:], base[1:, 1:])


def test_median3x3_ties_pick_by_neighbour_order():
    """Where the median grey is shared by neighbours of other colours,
    the first of them in neighbour order (dy, then dx) wins, as a stable
    argsort ranks them; the image has such pixels."""
    img = _tied_image()
    got = median_filter.median3x3(torch.from_numpy(img),
                                  tonemap=False).numpy()
    pad = np.pad(img, ((1, 1), (1, 1), (0, 0)), mode="edge")
    ties = 0
    for y in range(1, H):
        for x in range(1, W):
            nb = np.stack([pad[y + 1 + dy, x + 1 + dx]
                           for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
            g = (nb[:, 0] + nb[:, 1] + nb[:, 2]) * np.float32(1.0 / 3.0)
            order = np.argsort(g, kind="stable")
            np.testing.assert_array_equal(got[y, x], nb[order[4]])
            same = g == g[order[4]]
            ties += bool(len({tuple(c) for c in nb[same]}) > 1)
    assert ties > 10


def _cfg(**kw):
    return dict(width=16, height=16, iterations=3, spp=2, mode="parity",
                accel="bruteforce", **kw)


def test_denoised_image_matches_jax_engine():
    """The megakernel engine's denoised image, tonemapped and linear,
    against the jitted JAX engine's."""
    je = JEngine(jlib.cornell_box(with_spheres=True),
                 JRenderConfig(camera=JCameraConfig(**PRESET), **_cfg()))
    je.render(2, progress=False)
    pe = RenderEngine(library.cornell_box(with_spheres=True),
                      RenderConfig(camera=CameraConfig(**PRESET), **_cfg()),
                      device="cpu")
    pe.render(2, progress=False)
    for tm in (True, False):
        got = pe.denoised_image(apply_tonemap=tm)
        assert got.shape == (16, 16, 3)
        np.testing.assert_allclose(got, je.denoised_image(apply_tonemap=tm),
                                   rtol=ATROUS_RTOL, atol=1e-7)
    np.testing.assert_allclose(pe.denoised_image(apply_tonemap="filmic"),
                               je.denoised_image(apply_tonemap="filmic"),
                               rtol=ATROUS_RTOL, atol=1e-7)


def test_denoised_image_wavefront_equals_megakernel():
    """Parity mode: the wavefront engine's pixels equal the megakernel's
    at equal spp, so their denoised images are equal too; a denoise
    option reaches the filter."""
    imgs = {}
    for model in ("megakernel", "wavefront"):
        e = RenderEngine(library.cornell_box(with_spheres=True),
                         RenderConfig(camera=CameraConfig(**PRESET),
                                      **_cfg(model=model)), device="cpu")
        e.render(2, progress=False)
        imgs[model] = e.denoised_image()
        noisy = e.image()
        assert not np.array_equal(imgs[model], noisy)
        one = e.denoised_image(iterations=1)
        assert not np.array_equal(one, imgs[model])
    np.testing.assert_array_equal(imgs["wavefront"], imgs["megakernel"])


def _cli(tmp_path, out, *extra):
    path = str(tmp_path / out)
    rc = cli.main(["render", "--scene", "cornell", "--size", "16x12",
                   "--spp", "2", "--iters", "2", "--device", "cpu",
                   "--out", path, *extra])
    return rc, path


@pytest.mark.parametrize("out", ["d.png", "d.pfm", "d.npy"])
def test_cli_denoise(out, tmp_path):
    rc, path = _cli(tmp_path, out, "--denoise")
    assert rc == 0
    plain_rc, plain = _cli(tmp_path, "p" + out)
    if out.endswith(".png"):
        img, ref = read_png(path), read_png(plain)
        assert img.shape == (12, 16, 3) and not np.array_equal(img, ref)
    else:
        load = np.load if out.endswith(".npy") else read_pfm
        img, ref = load(path), load(plain)
        assert img.shape == (12, 16, 3) and np.isfinite(img).all()
        # Linear light: the same scale as the undenoised HDR image.
        assert 0.2 < img.mean() / ref.mean() < 5.0
        assert not np.array_equal(img, ref)


def test_cli_median_and_exclusive(tmp_path):
    rc, path = _cli(tmp_path, "m.png", "--median")
    assert rc == 0
    assert read_png(path).shape == (12, 16, 3)
    with pytest.raises(SystemExit, match="exclusive"):
        _cli(tmp_path, "x.png", "--median", "--denoise")
