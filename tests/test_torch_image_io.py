"""The port's image I/O against the JAX package on the CPU: PFM files
byte-equal to JAX's, PFM reading (big-endian, scaled), the dependency-free
PNG encoder and decoder (the path that runs where PIL is missing) against
JAX's `read_png`, and the engine's `save_hdr`."""

import struct
import zlib

import numpy as np
import pytest
import torch

from opencl_path_tracer_tpu.io import image as jimage
from opencl_path_tracer_tpu_torch.config import CameraConfig, RenderConfig
from opencl_path_tracer_tpu_torch.io import image
from opencl_path_tracer_tpu_torch.runtime.engine import RenderEngine
from opencl_path_tracer_tpu_torch.scene import library

# pytest workers share the machine: one intra-op thread each.
torch.set_num_threads(1)


def _hdr(h=5, w=7, seed=0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((h, w, 3)) * 10).astype(np.float32)


def test_write_pfm_byte_equal_to_jax(tmp_path):
    img = _hdr()
    image.write_pfm(str(tmp_path / "p.pfm"), img)
    jimage.write_pfm(str(tmp_path / "j.pfm"), img)
    data = (tmp_path / "p.pfm").read_bytes()
    assert data == (tmp_path / "j.pfm").read_bytes()
    assert data.startswith(b"PF\n7 5\n-1.0\n")
    np.testing.assert_array_equal(image.read_pfm(str(tmp_path / "p.pfm")),
                                  img)
    with pytest.raises(ValueError, match="PFM needs"):
        image.write_pfm(str(tmp_path / "x.pfm"), img[..., :2])


@pytest.mark.parametrize("scale", [1.0, 2.5, -1.0, -0.5])
def test_read_pfm_byte_order_and_scale(scale, tmp_path):
    """A positive scale is big-endian; |scale| != 1 multiplies."""
    img = _hdr(seed=1)
    order = "<f4" if scale < 0 else ">f4"
    path = tmp_path / "s.pfm"
    path.write_bytes(b"PF\n7 5\n" + f"{scale}\n".encode()
                     + img[::-1].astype(order).tobytes())
    got = image.read_pfm(str(path))
    want = img if abs(scale) == 1.0 else img * np.float32(abs(scale))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jimage.read_pfm(str(path)))
    (tmp_path / "g.pfm").write_bytes(b"Pf\n1 1\n-1.0\n" + bytes(4))
    with pytest.raises(ValueError, match="color PFM"):
        image.read_pfm(str(tmp_path / "g.pfm"))


def _png(path, rows, w, h):
    """An 8-bit RGB PNG of pre-filtered rows (filter byte + payload)."""
    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0,
                                                  0, 0))
                     + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                     + chunk(b"IEND", b""))


def test_raw_png_round_trip_equals_jax(tmp_path, monkeypatch):
    """With PIL absent, write_png's and read_png's own encoder and decoder
    run; the file reads the same through JAX's read_png (PIL here)."""
    u8 = np.random.default_rng(2).integers(0, 256, (6, 9, 3), np.uint8)
    with_pil = tmp_path / "pil.png"
    image.write_png(str(with_pil), u8)
    monkeypatch.setattr(image, "_PIL", None)
    raw = tmp_path / "raw.png"
    image.write_png(str(raw), u8)
    np.testing.assert_array_equal(image.read_png(str(raw)), u8)
    np.testing.assert_array_equal(image.read_png(str(raw)),
                                  jimage.read_png(str(raw)))
    np.testing.assert_array_equal(jimage.read_png(str(with_pil)), u8)
    f = np.linspace(-0.5, 1.5, 6 * 9 * 3).reshape(6, 9, 3).astype(np.float32)
    image.write_png(str(raw), f)
    np.testing.assert_array_equal(image.read_png(str(raw)),
                                  jimage.to_uint8(f))


def test_raw_png_filters(tmp_path, monkeypatch):
    """Filters 0 (none), 1 (sub) and 2 (up) decode as JAX's raw decoder
    does; any other raises."""
    monkeypatch.setattr(image, "_PIL", None)
    w, h = 5, 4
    u8 = np.random.default_rng(3).integers(0, 256, (h, w, 3), np.uint8)
    flat = u8.reshape(h, w * 3).astype(np.int32)
    rows = []
    for y in range(h):
        ftype = y % 3
        if ftype == 1:
            body = flat[y] - np.concatenate([np.zeros(3, np.int32),
                                             flat[y][:-3]])
        elif ftype == 2:
            body = flat[y] - (flat[y - 1] if y else 0)
        else:
            body = flat[y]
        rows.append(bytes([ftype]) + (body % 256).astype(np.uint8).tobytes())
    path = tmp_path / "f.png"
    _png(path, rows, w, h)
    got = image.read_png(str(path))
    np.testing.assert_array_equal(got, u8)
    np.testing.assert_array_equal(got, jimage._read_png_raw(str(path)))
    _png(path, [bytes([3]) + bytes(w * 3)] * h, w, h)
    with pytest.raises(ValueError, match="unsupported PNG filter 3"):
        image.read_png(str(path))
    (tmp_path / "n.png").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        image.read_png(str(tmp_path / "n.png"))


@pytest.mark.parametrize("model", ["megakernel", "wavefront"])
def test_save_hdr_holds_the_linear_image(model, tmp_path):
    cfg = RenderConfig(width=12, height=8, iterations=2, mode="parity",
                       model=model,
                       camera=CameraConfig(fov=60.0, yaw=0.0, pitch=0.0,
                                           shift=(0.0, 0.0, 0.0)))
    eng = RenderEngine(library.cornell_box(with_spheres=True), cfg,
                       device="cpu")
    eng.render(2)
    lin = eng.image(apply_tonemap=False)
    assert lin.max() > 1.0                       # untonemapped lamp pixels
    eng.save_hdr(str(tmp_path / "x.pfm"))
    eng.save_hdr(str(tmp_path / "x.npy"))
    np.testing.assert_array_equal(image.read_pfm(str(tmp_path / "x.pfm")),
                                  lin)
    np.testing.assert_array_equal(jimage.read_pfm(str(tmp_path / "x.pfm")),
                                  lin)
    np.testing.assert_array_equal(np.load(tmp_path / "x.npy"), lin)
