"""PNG and PFM image I/O.

Port of `opencl_path_tracer_tpu/io/image.py`: `to_uint8`, `write_png`,
`write_pfm`, `read_pfm` and `read_png` (the reference cannot save
images, main.cpp:727-741). PNG goes through PIL when it is installed,
else through a dependency-free zlib encoder (`png_bytes`, which also
encodes in memory) and decoder (8-bit RGB; the
decoder takes filters 0, 1 and 2, which is what the encoder and PIL's
default writes use, and raises on any other). PFM is linear float32
HDR, written bottom-up with scale -1.0 (little-endian), as the JAX
package writes it, byte for byte.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

try:
    from PIL import Image as _PIL
except Exception:  # pragma: no cover
    _PIL = None


def to_uint8(img) -> np.ndarray:
    """Clamp float [0, 1] (H, W, 3|4) to uint8; NaN (the tonemap's 0/0
    quirk) becomes 0, +inf 255."""
    img = np.asarray(img, np.float32)
    img = np.nan_to_num(img, nan=0.0, posinf=1.0, neginf=0.0)
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, img) -> None:
    """img: (H, W, 3) float in [0, 1] or uint8, row 0 at the top."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = to_uint8(img)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    if img.shape[-1] == 4:
        img = img[..., :3]
    img = np.ascontiguousarray(img)
    if _PIL is not None:
        _PIL.fromarray(img, "RGB").save(path)
        return
    with open(path, "wb") as fh:
        fh.write(png_bytes(img))


def png_bytes(img: np.ndarray) -> bytes:
    """The dependency-free encoder's PNG file of a contiguous (H, W, 3)
    uint8 image, row 0 at the top, in memory (filter 0 on every row,
    zlib level 6)."""
    h, w, _ = img.shape
    rows = np.empty((h, 1 + 3 * w), np.uint8)
    rows[:, 0] = 0
    rows[:, 1:] = img.reshape(h, 3 * w)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_pfm(path: str, img) -> None:
    """Portable FloatMap: img (H, W, 3) float, row 0 at the top; the
    file holds the rows bottom-up, little-endian (scale -1.0)."""
    img = np.asarray(img, np.float32)
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"PFM needs (H, W, 3), got {img.shape}")
    h, w, _ = img.shape
    with open(path, "wb") as fh:
        fh.write(b"PF\n" + f"{w} {h}\n".encode() + b"-1.0\n")
        fh.write(img[::-1].astype("<f4").tobytes())


def read_pfm(path: str) -> np.ndarray:
    """(H, W, 3) float32, row 0 at the top. The scale's sign gives the
    byte order; a magnitude other than 1 multiplies the radiance (the
    PFM convention, for files written elsewhere)."""
    with open(path, "rb") as fh:
        if fh.readline().strip() != b"PF":
            raise ValueError("not a color PFM")
        w, h = (int(v) for v in fh.readline().split())
        scale = float(fh.readline())
        data = np.frombuffer(fh.read(w * h * 12),
                             "<f4" if scale < 0 else ">f4")
    img = data.reshape(h, w, 3)[::-1].astype(np.float32)
    if abs(scale) != 1.0:
        img = img * np.float32(abs(scale))
    return img


def read_png(path: str) -> np.ndarray:
    """(H, W, 3) uint8."""
    if _PIL is not None:
        return np.asarray(_PIL.open(path).convert("RGB"))
    return _read_png_raw(path)


def _read_png_raw(path: str) -> np.ndarray:
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, w, h, idat = 8, 0, 0, b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            if depth != 8 or ctype != 2:
                raise ValueError("only 8-bit RGB PNGs are supported")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * 3
    out = np.empty((h, w, 3), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        start = y * (stride + 1)
        ftype = raw[start]
        row = np.frombuffer(raw[start + 1:start + 1 + stride], np.uint8)
        if ftype == 0:
            row = row.copy()
        elif ftype == 1:   # sub: add the byte one pixel to the left
            acc = row.astype(np.int32)
            for x in range(3, stride):
                acc[x] = (acc[x] + acc[x - 3]) % 256
            row = acc.astype(np.uint8)
        elif ftype == 2:   # up: add the byte above
            row = ((row.astype(np.int32) + prev) % 256).astype(np.uint8)
        else:
            raise ValueError(f"unsupported PNG filter {ftype}")
        out[y] = row.reshape(w, 3)
        prev = row
    return out
