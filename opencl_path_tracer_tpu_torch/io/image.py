"""PNG output.

Port of `to_uint8` and `write_png` of `opencl_path_tracer_tpu/io/image.py`
(the reference cannot save images, main.cpp:727-741). Uses PIL when it
is installed, else a dependency-free zlib encoder.
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
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        fh.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        fh.write(chunk(b"IEND", b""))
