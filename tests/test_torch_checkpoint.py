"""Checkpoints in the port on the CPU: parity resumes bit-identical to
an unbroken render in both models, the file layout of the JAX package
(read raw with `np.load`), resumes across the two packages in both
directions, old files, refusals, autosave and the CLI's `--checkpoint`,
`--resume`, `--config` and HDR `--out`.

"Unbroken" for the wavefront model with NEE is `render(2); render(2)` in
one engine, not `render(4)`: the gather's draws key on the global step
counter, and at a sample cap the finished lanes idle until the others
catch up, so the split changes at which steps a lane's bounces fall (in
JAX as in the port). Without NEE, parity draws ride the lanes' Lehmer
streams and `render(4)` is the same.

Across the packages the renders run JAX under `jax.disable_jit()` on the
triangle Cornell box at 2 bounces, where one step is bit-equal in the
two (tests/test_torch_adaptive.py says why)."""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu import config as jconfig
from opencl_path_tracer_tpu.io import checkpoint as jckpt
from opencl_path_tracer_tpu.models import wavefront as jwf
from opencl_path_tracer_tpu.ops import intersect as jisect
from opencl_path_tracer_tpu.runtime import engine as jengine
from opencl_path_tracer_tpu.scene import library as jlib
from opencl_path_tracer_tpu_torch import cli
from opencl_path_tracer_tpu_torch.config import CameraConfig, RenderConfig
from opencl_path_tracer_tpu_torch.io import checkpoint
from opencl_path_tracer_tpu_torch.models import wavefront
from opencl_path_tracer_tpu_torch.runtime.engine import RenderEngine
from opencl_path_tracer_tpu_torch.scene import library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)

W = H = 16
CAM = dict(fov=60.0, yaw=0.0, pitch=0.0, shift=(0.0, 0.0, 0.0))
LAMP = dict(with_spheres=True, analytic_spheres=True, sphere_lamp=True)


def _engine(model, nee=False, scene_kw=None, iters=3, **kw):
    cfg = RenderConfig(width=W, height=H, iterations=iters, mode="parity",
                       model=model, nee=nee, camera=CameraConfig(**CAM), **kw)
    return RenderEngine(library.cornell_box(**(scene_kw or dict(
        with_spheres=True))), cfg, device="cpu")


def _assert_same(a, b):
    assert torch.equal(a.state.rng_state, b.state.rng_state)
    np.testing.assert_array_equal(a.image(apply_tonemap=False),
                                  b.image(apply_tonemap=False))
    if a.cfg.model == "wavefront":
        assert torch.equal(a.state.samples, b.state.samples)
        assert a.state.step == b.state.step
    else:
        assert a.state.sample == b.state.sample
    assert a._sample_host == b._sample_host


@pytest.mark.parametrize("model,nee", [("megakernel", False),
                                       ("wavefront", True),
                                       ("wavefront", False)])
def test_parity_resume_bit_identical(model, nee, tmp_path):
    kw = dict(nee=nee, scene_kw=LAMP if nee else None)
    unbroken = _engine(model, **kw)
    if nee:
        unbroken.render(2)
        unbroken.render(2)
    else:
        unbroken.render(4)
    first = _engine(model, **kw)
    first.render(2)
    first.save(str(tmp_path / "ck.npz"))
    resumed = _engine(model, **kw)
    resumed.load(str(tmp_path / "ck.npz"))
    assert resumed._sample_host == 2
    resumed.render(2)
    _assert_same(resumed, unbroken)


def _jax_engine(model, iters=2):
    js = jlib.cornell_box(with_spheres=True)
    cfg = jconfig.RenderConfig(width=W, height=H, iterations=iters,
                               mode="parity", model=model,
                               camera=jconfig.CameraConfig(**CAM))
    return jengine.RenderEngine(
        js, cfg, intersect_fn=functools.partial(jisect.first_intersect,
                                                tris=js.tris))


def _jax_wavefront_resume(path, spp):
    """JAX's own resumed render through its model functions (op by op):
    steps capped at the loaded floor + spp until every pixel has it."""
    js = jlib.cornell_box(with_spheres=True)
    st, _ = jckpt.load_checkpoint(path)
    target = int(jnp.min(st.samples)) + spp
    with jax.disable_jit():
        while int(jnp.min(st.samples)) < target:
            st = jwf.wavefront_step(
                jlib.cornell_camera(W, H), js.mats, st,
                intersect_fn=functools.partial(jisect.first_intersect,
                                               tris=js.tris),
                iterations=2, mode="parity", max_samples=target)
    return st


def _layout(path):
    with np.load(path) as z:
        return [(k, z[k].dtype, z[k].shape) for k in z.files]


@pytest.mark.parametrize("model", ["megakernel", "wavefront"])
def test_resume_across_packages(model, tmp_path):
    """JAX's engine writes, the port resumes to the bits of JAX's own
    resumed render; the port writes, JAX's load_checkpoint resumes to the
    port's bits. Both files have one layout (keys, order, dtypes,
    shapes)."""
    jpath, ppath = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    je = _jax_engine(model)
    with jax.disable_jit():
        je.render(2, progress=False)
    je.save(jpath)
    pe = _engine(model, iters=2, accel="bruteforce")
    pe.render(2)
    pe.save(ppath)
    assert _layout(jpath) == _layout(ppath)
    with np.load(ppath) as z:
        meta = json.loads(str(z["meta"]))
        assert meta == {"version": 1, "model": model, "width": W,
                        "height": H, "mode": "parity", "seed": 1}
        assert z["rng_state"].dtype == np.uint32
        assert (z["step" if model == "wavefront" else "sample"].dtype
                == (np.uint32 if model == "wavefront" else np.int32))
    # The two 2-spp states are one state (the JAX engine's wavefront
    # floats an ulp apart on a few lanes: its steps go through
    # lift_consts, tests/test_torch_adaptive.py).
    with np.load(jpath) as zj, np.load(ppath) as zp:
        for name in zj.files:
            if name == "meta":
                continue
            if model == "wavefront" and zj[name].dtype == np.float32:
                np.testing.assert_allclose(zp[name], zj[name], rtol=1e-5,
                                           atol=1e-6, err_msg=name)
            else:
                np.testing.assert_array_equal(zp[name], zj[name], name)

    port = _engine(model, iters=2, accel="bruteforce")
    port.load(jpath)
    port.render(2)
    if model == "wavefront":
        ref = _jax_wavefront_resume(jpath, 2)
        np.testing.assert_array_equal(
            wavefront.colors_by_pixel(port.state, W * H).numpy(),
            jwf.colors_by_pixel(ref, W * H))
        np.testing.assert_array_equal(port.state.samples.numpy(),
                                      np.asarray(ref.samples))
        np.testing.assert_array_equal(
            port.state.rng_state.numpy().astype(np.uint32),
            np.asarray(ref.rng_state))
        # JAX's engine reads the port's file; its steps round a few values
        # an ulp apart through lift_consts (tests/test_torch_adaptive.py).
        je2 = _jax_engine(model)
        je2.load(ppath)
        assert je2._sample_host == 2
        np.testing.assert_array_equal(
            np.asarray(jckpt.load_checkpoint(ppath)[0].lum_m2),
            pe.state.lum_m2.numpy())
        back = _jax_wavefront_resume(ppath, 2)
        pe.render(2)
        np.testing.assert_array_equal(
            jwf.colors_by_pixel(back, W * H),
            wavefront.colors_by_pixel(pe.state, W * H).numpy())
        np.testing.assert_array_equal(np.asarray(back.rng_state),
                                      pe.state.rng_state.numpy())
    else:
        ref = _jax_engine(model)
        ref.load(jpath)
        with jax.disable_jit():
            ref.render(2, progress=False)
        np.testing.assert_array_equal(port.image(apply_tonemap=False),
                                      ref.image(apply_tonemap=False))
        np.testing.assert_array_equal(
            port.state.rng_state.numpy().astype(np.uint32),
            np.asarray(ref.state.rng_state))
        assert port.state.sample == int(ref.state.sample) == 4
        back = _jax_engine(model)
        back.load(ppath)
        assert back._sample_host == 2
        with jax.disable_jit():
            back.render(2, progress=False)
        np.testing.assert_array_equal(back.image(apply_tonemap=False),
                                      port.image(apply_tonemap=False))


def test_old_files_and_refusals(tmp_path):
    """A version-1 file without `model` is a megakernel state; wavefront
    fields missing from an older file load as zeros; another resolution,
    model or version is refused."""
    eng = _engine("megakernel")
    eng.render(1)
    old = str(tmp_path / "old.npz")
    np.savez_compressed(old, colors=np.stack([c.numpy() for c in
                                              eng.state.colors], -1),
                        rng_state=eng.state.rng_state.numpy().astype(
                            np.uint32),
                        sample=np.asarray(1, np.int32),
                        meta=json.dumps({"version": 1, "width": W,
                                         "height": H}))
    fresh = _engine("megakernel")
    fresh.load(old)
    assert fresh.state.sample == 1 and fresh._sample_host == 1
    assert fresh.state.rng_state.dtype == torch.int64
    assert torch.equal(fresh.state.colors[1], eng.state.colors[1])

    wf = _engine("wavefront")
    wf.render(1)
    full = str(tmp_path / "wf.npz")
    wf.save(full)
    with np.load(full) as z:
        kept = {k: z[k] for k in z.files
                if k not in ("had_diffuse", "prev_pdf", "lum_m2")}
    older = str(tmp_path / "wf_old.npz")
    np.savez_compressed(older, **kept)
    st, meta = checkpoint.load_checkpoint(older)
    assert meta["model"] == "wavefront"
    assert st.had_diffuse.dtype == torch.bool and not st.had_diffuse.any()
    for name in ("prev_pdf", "lum_m2"):
        v = getattr(st, name)
        assert v.dtype == torch.float32 and v.shape == (W * H,)
        assert not v.any()
    jst, _ = jckpt.load_checkpoint(older)
    for f in dataclasses.fields(wavefront.WavefrontState):
        a, b = getattr(st, f.name), getattr(jst, f.name)
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            np.testing.assert_array_equal(
                np.asarray(x) if f.name == "step"
                else x.numpy().astype(np.asarray(y).dtype), np.asarray(y))

    with pytest.raises(ValueError, match="resolution mismatch: 16x16 vs"):
        RenderEngine(library.cornell_box(with_spheres=True),
                     RenderConfig(width=8, height=8, mode="parity",
                                  camera=CameraConfig(**CAM)),
                     device="cpu").load(old)
    with pytest.raises(ValueError, match="checkpoint model 'megakernel' != "
                                         "engine model 'wavefront'"):
        _engine("wavefront").load(old)
    np.savez_compressed(str(tmp_path / "v2.npz"), colors=np.zeros((1, 3)),
                        meta=json.dumps({"version": 2}))
    with pytest.raises(ValueError, match="checkpoint version 2 != 1"):
        checkpoint.load_checkpoint(str(tmp_path / "v2.npz"))
    # np.savez_compressed appends .npz to a bare name, as in JAX.
    checkpoint.save_checkpoint(str(tmp_path / "bare"), eng.state)
    assert (tmp_path / "bare.npz").exists()


@pytest.mark.parametrize("model", ["megakernel", "wavefront"])
def test_autosave(model, tmp_path):
    """Autosave leaves no .tmp.npz behind, and the autosaved file resumes
    to the unbroken render."""
    path = str(tmp_path / "auto.npz")
    eng = _engine(model)
    eng.render(3, autosave_every=2, autosave_path=path)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["auto.npz"]
    unbroken = _engine(model)
    unbroken.render(4)
    resumed = _engine(model)
    resumed.load(path)
    # Megakernel: saved at sample 2; wavefront: at the last check, 3 spp.
    at = 3 if model == "wavefront" else 2
    assert resumed._sample_host == at
    resumed.render(4 - at)
    _assert_same(resumed, unbroken)


def test_cli_checkpoint_resume_config_and_hdr(tmp_path, capsys):
    """--checkpoint, then --resume continues to the unbroken render's
    pixels; --config overrides the flags; --out .npy/.pfm is linear."""
    common = ["render", "--scene", "cornell", "--size", "12x8", "--iters",
              "2", "--mode", "parity", "--device", "cpu"]
    ck = str(tmp_path / "ck.npz")
    assert cli.main(common + ["--spp", "2", "--checkpoint", ck,
                              "--autosave-every", "1",
                              "--out", str(tmp_path / "a.png")]) == 0
    assert cli.main(common + ["--spp", "2", "--resume", ck,
                              "--out", str(tmp_path / "b.npy")]) == 0
    err = capsys.readouterr().err
    assert "resumed at sample 2" in err
    assert cli.main(common + ["--spp", "4",
                              "--out", str(tmp_path / "c.pfm")]) == 0
    from opencl_path_tracer_tpu_torch.io.image import read_pfm
    np.testing.assert_array_equal(np.load(tmp_path / "b.npy"),
                                  read_pfm(str(tmp_path / "c.pfm")))
    cfg = RenderConfig(width=6, height=4, iterations=1, spp=1,
                       model="wavefront")
    (tmp_path / "cfg.json").write_text(cfg.to_json())
    assert cli.main(common + ["--config", str(tmp_path / "cfg.json"),
                              "--out", str(tmp_path / "d.npy")]) == 0
    assert np.load(tmp_path / "d.npy").shape == (4, 6, 3)
