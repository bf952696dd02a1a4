"""The port's raygen, BSDF, tonemap and PNG output against the JAX
package.

Camera rays are bit-equal to JAX's op-by-op `camera_rays` (every
product and sum separately rounded, exact sqrt and divide). The BSDF
and tonemap functions call cos, sin and pow, which XLA evaluates with
its own polynomials: they are held to 4 float32 ulps (rtol 5e-7)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.io import image as jimage
from opencl_path_tracer_tpu.ops import bsdf as jbsdf
from opencl_path_tracer_tpu.ops import raygen as jraygen
from opencl_path_tracer_tpu.ops import tonemap as jtonemap
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch.io import image
from opencl_path_tracer_tpu_torch.ops import bsdf, raygen, tonemap
from opencl_path_tracer_tpu_torch.scene import library as plib

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

RTOL = 5e-7


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _v3(n, seed, unit=True):
    v = np.random.default_rng(seed).normal(size=(3, n)).astype(np.float32)
    if unit:
        v /= np.linalg.norm(v, axis=0, keepdims=True)
    return v


@pytest.mark.parametrize("w,h", [(16, 16), (40, 24)])
def test_camera_rays_bit_equal(w, h):
    rs = np.random.default_rng(w)
    r1, r2 = (rs.random(w * h).astype(np.float32) for _ in range(2))
    jr = jraygen.camera_rays(jlib.cornell_camera(w, h),
                             jraygen.pixel_ids(w, h), jnp.asarray(r1),
                             jnp.asarray(r2))
    pr = raygen.camera_rays(plib.cornell_camera(w, h), raygen.pixel_ids(w, h),
                            _t(r1), _t(r2))
    for k in range(3):
        np.testing.assert_array_equal(pr.p[k].numpy(), np.asarray(jr.p[k]))
        np.testing.assert_array_equal(pr.d[k].numpy().view(np.int32),
                                      np.asarray(jr.d[k]).view(np.int32))


def test_bsdf_diffuse_specular_refractive():
    n = 2000
    p, nrm, d = _v3(n, 1, False) * 100, _v3(n, 2), _v3(n, 3)
    d = np.where((d * nrm).sum(0) > 0, -d, d).astype(np.float32)
    rs = np.random.default_rng(4)
    u1, u2 = (rs.random(n).astype(np.float32) for _ in range(2))
    jv = lambda a: tuple(jnp.asarray(x) for x in a)       # noqa: E731
    pv = lambda a: tuple(_t(x) for x in a)                 # noqa: E731

    def close(a, b):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=RTOL,
                                       atol=2e-6)

    jo, jd = jbsdf.diffuse_ray(jv(p), jv(nrm), jnp.asarray(u1),
                               jnp.asarray(u2))
    po, pd = bsdf.diffuse_ray(pv(p), pv(nrm), _t(u1), _t(u2))
    close(po, jo)
    close(pd, jd)
    close(bsdf.specular_ray(pv(p), pv(nrm), pv(d))[1],
          jbsdf.specular_ray(jv(p), jv(nrm), jv(d))[1])
    f0 = (np.full(n, 0.04, np.float32),) * 3
    inside = rs.random(n) < 0.3
    mat_n = np.full(n, 1.5, np.float32)
    jres = jbsdf.refractive_ray(jv(p), jv(nrm), jv(d), jnp.asarray(mat_n),
                                jv(f0), jnp.asarray(inside), jnp.asarray(u1))
    pres = bsdf.refractive_ray(pv(p), pv(nrm), pv(d), _t(mat_n), pv(f0),
                               _t(inside), _t(u1))
    close(pres[0], jres[0])
    close(pres[1], jres[1])
    np.testing.assert_array_equal(pres[2].numpy(), np.asarray(jres[2]))
    close(pres[3], jres[3])


@pytest.mark.parametrize("safe", [True, False])
def test_reinhard_matches_including_zero_quirk(safe):
    c = np.random.default_rng(6).random((50, 3)).astype(np.float32) * 4
    c[:5] = 0.0                          # L == 0: black, or NaN if unsafe
    want = np.asarray(jtonemap.reinhard(jnp.asarray(c), safe=safe))
    got = tonemap.reinhard(_t(c), safe=safe).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[:5]).all() == (not safe)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)
    f = np.asarray(jtonemap.filmic(jnp.asarray(c)))
    np.testing.assert_allclose(tonemap.filmic(_t(c)).numpy(), f, rtol=RTOL)


def test_png_output(tmp_path):
    img = np.random.default_rng(2).random((8, 5, 3)).astype(np.float32)
    img[0, 0] = np.nan
    np.testing.assert_array_equal(image.to_uint8(img), jimage.to_uint8(img))
    path = str(tmp_path / "x.png")
    image.write_png(path, img)
    np.testing.assert_array_equal(jimage.read_png(path), image.to_uint8(img))
