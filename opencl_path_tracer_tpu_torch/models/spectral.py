"""Spectral dispersion: glass whose refraction index depends on the
wavelength.

Port of `opencl_path_tracer_tpu/models/spectral.py`. The reference's
dielectric has one scalar index for all light (main.cpp:103 takes the
mean of the per-channel IOR; prog.cl:339-356 bends every wavelength
alike). Here the visible spectrum is cut into B bands (`band_centers`);
each band renders an ordinary wavefront pass with a materials table in
which every REFRACTIVE row's index n becomes n(lambda) of the Abbe
number's Cauchy model (`abbe_ior`) and its Fresnel F0 the dielectric's
((n - 1) / (n + 1))^2, and the band images combine to RGB with weights
that sum to one per channel (`band_weights`). Without a refractive
material, or with v_d=None, the bands are alike and the combination is
the plain render.

Each band is `models.wavefront.wavefront_step` on a fresh
`init_wavefront` of the same seed and key (common random numbers:
NEE's draws key on the step counter and the lane, so every band must
start from step 1), in chunks of max(2 iterations, 8) steps until every
pixel holds min_spp samples (exactly min_spp with exact_spp). The band
tables are built once, on the host in float32, and moved to the
camera's device. The bands combine in float64, in band order, the
float32 weights and images widened, and the sum is rounded once to
float32: the JAX package's `out += w[b] * img` into a float64 numpy
array, as it runs op by op (`jax.disable_jit()`). Outside that mode
the JAX array on the right turns `out` into a float32 JAX array at the
first band (x64 is off), so the jitted package sums in float32 and may
differ by an ulp where the weights are not 0 or 1 (more than 3 bands).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from opencl_path_tracer_tpu_torch.core.materials import (
    MaterialsSoA, MaterialType,
)
from opencl_path_tracer_tpu_torch.models import wavefront
from opencl_path_tracer_tpu_torch.ops import rng

# The Fraunhofer lines the Abbe number is defined over (nm).
_LAMBDA_F = 486.13
_LAMBDA_D = 589.29
_LAMBDA_C = 656.27

# The dominant wavelengths of the sRGB primaries (nm): the 3-band centres.
_RGB_CENTERS = (612.0, 549.0, 465.0)

# Gaussian stand-ins for the sRGB channels' spectral responses, used only
# to split each channel's weight across bands (normalised per channel).
_CHANNEL_MU = (612.0, 549.0, 465.0)
_CHANNEL_SIGMA = (45.0, 40.0, 35.0)


def _dispersive(v_d) -> bool:
    """False for v_d None or inf (no dispersion); refuses a finite
    v_d <= 0, for which the model has no meaning (the JAX package renders
    black through NaN there)."""
    if v_d is None or not np.isfinite(v_d):
        return False
    if v_d <= 0:
        raise ValueError(f"the Abbe number v_d must be > 0, got {v_d}")
    return True


def abbe_ior(n_d, wavelength_nm, v_d):
    """n(lambda) = A + B / lambda^2, the two-term Cauchy model with
    n(589.29) = n_d and (n_d - 1) / (n_F - n_C) = v_d, on the CPU in
    float32 (a float32 tensor n_d is taken in float32, a Python n_d in
    float64 and rounded once, as the JAX package's weak types do).
    v_d=None or inf returns n_d itself."""
    if not _dispersive(v_d):
        return n_d
    lam = torch.as_tensor(wavelength_nm, dtype=torch.float32)
    spread = 1.0 / _LAMBDA_F ** 2 - 1.0 / _LAMBDA_C ** 2
    b = (n_d - 1.0) / (v_d * spread)
    a = n_d - b / _LAMBDA_D ** 2
    if not isinstance(n_d, torch.Tensor):
        a = torch.tensor(a, dtype=torch.float32)
        b = torch.tensor(b, dtype=torch.float32)
    return a + b / (lam * lam)


def band_centers(bands: int) -> np.ndarray:
    """(B,) band centres in nm, float64: the d line for one band, the
    sRGB primaries for three, else 660 to 440 evenly."""
    if bands < 1:
        raise ValueError(f"bands must be >= 1, got {bands}")
    if bands == 1:
        return np.array([_LAMBDA_D], np.float64)
    if bands == 3:
        return np.array(_RGB_CENTERS, np.float64)
    return np.linspace(660.0, 440.0, bands)


def band_weights(bands: int) -> np.ndarray:
    """(B, 3) float32 weights, result[c] = sum_b w[b, c] img_b[c]: each
    channel's column sums to one (three bands: the identity; more: a
    Gaussian response at each band's centre, normalised in float64)."""
    lam = band_centers(bands)
    if bands == 1:
        return np.ones((1, 3), np.float32)
    if bands == 3:
        return np.eye(3, dtype=np.float32)
    w = np.zeros((bands, 3), np.float64)
    for c in range(3):
        w[:, c] = np.exp(-0.5 * ((lam - _CHANNEL_MU[c])
                                 / _CHANNEL_SIGMA[c]) ** 2)
    w /= w.sum(axis=0, keepdims=True)
    return w.astype(np.float32)


def dispersive_materials(mats: MaterialsSoA, wavelength_nm: float,
                         v_d: float | None = 55.0) -> MaterialsSoA:
    """The band's materials: every REFRACTIVE row's n becomes
    abbe_ior(n, wavelength_nm, v_d) and its F0, on all three channels,
    ((n - 1) / (n + 1))^2; the other rows stay. Built on the CPU and
    moved to mats' device. v_d=None or inf returns `mats` itself."""
    if not _dispersive(v_d):
        return mats
    dev = mats.n.device
    n = mats.n.cpu()
    refr = mats.type.cpu() == int(MaterialType.REFRACTIVE)
    n_l = abbe_ior(n, float(wavelength_nm), float(v_d))
    x = (n_l - 1.0) / (n_l + 1.0)
    f0_diel = x * x
    return dataclasses.replace(
        mats, n=torch.where(refr, n_l, n).to(dev),
        f0=tuple(torch.where(refr, f0_diel, c.cpu()).to(dev)
                 for c in mats.f0))


def make_dispersive_renderer(mats: MaterialsSoA, *, intersect_fn,
                             num_pixels: int, iterations: int,
                             min_spp: int, bands: int = 3,
                             v_d: float | None = 55.0,
                             mode: str = "fast", seed: int = 1,
                             key=None, ids=None, nee=None, rr=None,
                             qmc: bool = False, dof=None,
                             occluded_fn=None, exact_spp: bool = True,
                             max_extra_steps: int = 1_000_000):
    """render(cam) -> (num_pixels, 3) float32 dispersive image on the
    camera's device (mats must be there too). The band tables are built
    here, once."""
    if mode == "fast" and key is None:
        key = rng.key(seed)
    weights = band_weights(bands)
    tables = [dispersive_materials(mats, c, v_d)
              for c in band_centers(bands)]
    cap = min_spp if exact_spp else None
    chunk = max(iterations * 2, 8)

    def band(cam, table):
        state = wavefront.init_wavefront(
            cam, num_pixels, seed=seed, mode=mode, key=key, ids=ids,
            qmc=qmc, dof=dof)
        for _ in range(max_extra_steps):
            for _ in range(chunk):
                state = wavefront.wavefront_step(
                    cam, table, state, intersect_fn=intersect_fn,
                    iterations=iterations, mode=mode, key=key,
                    max_samples=cap, ids=ids, nee=nee, rr=rr, qmc=qmc,
                    dof=dof, occluded_fn=occluded_fn)
            if int(state.samples.min()) >= min_spp:
                break
        return wavefront.colors_by_pixel(state, num_pixels)

    def render(cam) -> torch.Tensor:
        dev = cam.eye.device
        out = torch.zeros((num_pixels, 3), dtype=torch.float64, device=dev)
        for b, table in enumerate(tables):
            w = torch.as_tensor(weights[b], dtype=torch.float64, device=dev)
            out += w[None, :] * band(cam, table).to(torch.float64)
        return out.to(torch.float32)

    return render


def render_dispersive(cam, mats: MaterialsSoA, *, intersect_fn,
                      num_pixels: int, iterations: int, min_spp: int,
                      bands: int = 3, v_d: float | None = 55.0,
                      mode: str = "fast", seed: int = 1, key=None,
                      ids=None, nee=None, rr=None, qmc: bool = False,
                      dof=None, occluded_fn=None, exact_spp: bool = True,
                      max_extra_steps: int = 1_000_000) -> torch.Tensor:
    """(num_pixels, 3) float32 linear radiance with spectral dispersion:
    one wavefront render per band, combined by `band_weights`. nee, rr,
    qmc and dof compose as in `wavefront_step`; the emitter table and
    occluded_fn (built on the undispersed scene: only refraction
    disperses) serve every band."""
    return make_dispersive_renderer(
        mats, intersect_fn=intersect_fn, num_pixels=num_pixels,
        iterations=iterations, min_spp=min_spp, bands=bands, v_d=v_d,
        mode=mode, seed=seed, key=key, ids=ids, nee=nee, rr=rr, qmc=qmc,
        dof=dof, occluded_fn=occluded_fn, exact_spp=exact_spp,
        max_extra_steps=max_extra_steps)(cam)
