"""Turntable and camera-path animation.

Port of `opencl_path_tracer_tpu/runtime/anim.py`. The reference is
interactive only: a fly camera over a progressive accumulator that any
input resets (current_sample = 0, main.cpp:1100-1148), with no export
path (`download_image` is commented out, main.cpp:727-741). This module
drives the same camera model offline: a pose sequence, each pose
rendered from a fresh accumulator (the reference's reset rule), the
frames written as PNGs and, optionally, as a looping GIF.

The camera is built per pose by the engine's controller, and the
engine's intersector, emitter table and any-hit test are built once, so
an orbit costs only its rendering. The GIF goes through PIL where it is
installed and through the port's own GIF89a writer otherwise
(`_write_gif_raw`), as `io/image.py` does for PNG.
"""

from __future__ import annotations

import os
import struct
import sys

import numpy as np
import torch

from opencl_path_tracer_tpu_torch.core.camera import BASE_EYE
from opencl_path_tracer_tpu_torch.core.geometry import rotate_x, rotate_y
from opencl_path_tracer_tpu_torch.io.image import to_uint8, write_png

try:
    from PIL import Image as _PIL
except ImportError:  # pragma: no cover
    _PIL = None

# The raw writer's palette for frames of more than 256 colours: 6 levels
# of red and blue and 7 of green (252 colours), each channel rounded to
# its nearest level, so no channel moves by more than 25 (red, blue) or
# 21 (green) of 255.
QUANT_LEVELS = (6, 7, 6)
QUANT_MAX_ERR = 25
# Literal codes between clear codes: after a clear the decoder adds one
# table entry per code but the first, so 254 literals leave the table at
# 511 entries and the codes at 9 bits.
_LZW_RUN = 254


def orbit_shift(center, radius: float, yaw: float, pitch: float):
    """The global shift that places the eye on an orbit around `center`.

    The camera fixes eye = BASE_EYE + shift and takes its view direction
    from (yaw, pitch) (main.cpp:327-343); to look at `center` from
    `radius` away, the eye backs off along the pose's own ahead vector:
    eye = center - radius * ahead(yaw, pitch). The ahead vector is
    `core.geometry`'s float32 rotation, the arithmetic in float64."""
    axis = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32)
    ahead = rotate_y(rotate_x(axis, pitch), yaw).numpy().astype(np.float64)
    eye = np.asarray(center, np.float64) - radius * ahead
    return eye - np.asarray(BASE_EYE, np.float64)


def turntable_poses(*, frames: int, center, radius: float,
                    pitch: float = 12.0, start_yaw: float = 0.0,
                    sweep: float = 360.0):
    """(yaw, pitch, shift) per frame of a `sweep`-degree orbit.

    A full turn (|sweep| >= 360) gives `frames` end-exclusive poses (the
    closing frame would repeat frame 0, so a GIF loops cleanly); a
    partial sweep is end-inclusive: its last frame lands on start_yaw +
    sweep."""
    den = frames if abs(sweep) >= 360.0 else max(frames - 1, 1)
    poses = []
    for i in range(frames):
        yaw = start_yaw + sweep * i / den
        poses.append((yaw, pitch, orbit_shift(center, radius, yaw, pitch)))
    return poses


def render_animation(engine, poses, *, spp: int, out_dir: str | None = None,
                     gif_path: str | None = None, fps: float = 12.0,
                     progress: bool = True, denoise: bool = False):
    """Render one frame per (yaw, pitch, shift) pose with `engine` (a
    RenderEngine, either model).

    Each pose starts from a fresh accumulator: the megakernel keeps its
    running Lehmer streams (rnds[] is never reseeded, main.cpp:522-527),
    the wavefront restarts at the pose. Returns the (H, W, 3) uint8
    frames, tonemapped, or denoised then tonemapped with denoise=True
    (`RenderEngine.denoised_image`). out_dir: write frame_%04d.png
    there; gif_path: also a looping GIF at `fps`; progress: a line per
    frame on stderr."""
    frames = []
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    for i, (yaw, pitch, shift) in enumerate(poses):
        st = engine.controller.state
        st.yaw = float(yaw)
        st.pitch = float(pitch)
        st.shift = np.asarray(shift, np.float64)
        engine.reset_accumulation()
        engine.render(spp, progress=False)
        img = to_uint8(engine.denoised_image() if denoise
                       else engine.image())
        frames.append(img)
        if out_dir:
            write_png(os.path.join(out_dir, f"frame_{i:04d}.png"), img)
        if progress:
            print(f"\rframe {i + 1}/{len(poses)} (yaw {yaw:.1f})", end="",
                  flush=True, file=sys.stderr)
    if progress:
        print(file=sys.stderr)
    if gif_path:
        write_gif(gif_path, frames, fps=fps)
    return frames


def gif_delay_ms(fps: float) -> int:
    """A frame's delay as both writers are given it, in ms (the file
    holds it in hundredths of a second, truncated as PIL truncates)."""
    return max(1, int(round(1000.0 / fps)))


def write_gif(path: str, frames, fps: float = 12.0) -> None:
    """Assemble (H, W, 3) uint8 frames into a GIF that loops forever:
    through PIL where it is installed (which merges equal consecutive
    frames), else through `_write_gif_raw` (every frame kept)."""
    if not frames:
        raise ValueError("write_gif needs at least one frame")
    if _PIL is None:
        _write_gif_raw(path, frames, fps=fps)
        return
    ims = [_PIL.fromarray(np.asarray(f)) for f in frames]
    ims[0].save(path, save_all=True, append_images=ims[1:],
                duration=gif_delay_ms(fps), loop=0)


def _write_gif_raw(path: str, frames, fps: float = 12.0) -> None:
    """The dependency-free GIF89a writer: the NETSCAPE2.0 block (loop 0),
    then per frame a graphic control block (the delay of `gif_delay_ms`
    in hundredths of a second), an image descriptor with a local
    256-entry colour table and the pixels as literal-only LZW.

    A frame of at most 256 colours keeps them exactly. A frame of more is
    rounded to QUANT_LEVELS' 252-colour cube: no channel moves by more
    than QUANT_MAX_ERR (25 of 255; 21 in green). Each frame is a few
    whole-array numpy passes, no per-pixel Python."""
    if not frames:
        raise ValueError("write_gif needs at least one frame")
    h, w = np.asarray(frames[0]).shape[:2]
    cs = gif_delay_ms(fps) // 10
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0x70, 0, 0),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0)
           + b"\x00"]
    for f in frames:
        f = np.asarray(f, np.uint8)
        if f.shape != (h, w, 3):
            raise ValueError(f"GIF frames must all be ({h}, {w}, 3), got "
                             f"{f.shape}")
        palette, index = _palette(f)
        out += [b"\x21\xf9\x04\x00" + struct.pack("<H", cs) + b"\x00\x00",
                b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x87),
                palette.tobytes(), b"\x08", _lzw_blocks(index.ravel())]
    out.append(b"\x3b")
    with open(path, "wb") as fh:
        fh.write(b"".join(out))


def _palette(frame: np.ndarray):
    """((256, 3) uint8 colour table, (H, W) uint8 indices) of a frame:
    its own colours where it has at most 256, else the rounded cube."""
    key = ((frame[..., 0].astype(np.int32) << 16)
           | (frame[..., 1].astype(np.int32) << 8) | frame[..., 2])
    seen = np.zeros(1 << 24, bool)
    seen[key] = True
    colours = np.flatnonzero(seen)
    table = np.zeros((256, 3), np.uint8)
    if colours.size <= 256:
        lut = np.zeros(1 << 24, np.uint8)
        lut[colours] = np.arange(colours.size, dtype=np.uint8)
        table[:colours.size] = np.stack(
            [colours >> 16, (colours >> 8) & 255, colours & 255], -1)
        return table, lut[key]
    idx = np.zeros(frame.shape[:2], np.int32)
    levels = []
    for c, n in enumerate(QUANT_LEVELS):
        step = 255.0 / (n - 1)
        q = np.rint(frame[..., c] / step).astype(np.int32)
        idx = idx * n + q
        levels.append(np.rint(np.arange(n) * step).astype(np.uint8))
    r, g, b = np.meshgrid(*levels, indexing="ij")
    cube = np.stack([r.ravel(), g.ravel(), b.ravel()], -1)
    table[:cube.shape[0]] = cube
    return table, idx.astype(np.uint8)


def _lzw_blocks(index: np.ndarray) -> bytes:
    """The image data's sub-blocks for minimum code size 8: a clear code
    before every _LZW_RUN literals, the end code last, all 9 bits wide,
    packed least significant bit first, cut into blocks of 255 bytes and
    closed by an empty block."""
    n = index.size
    runs = -(-n // _LZW_RUN)
    codes = np.full(n + runs + 1, 256, np.uint16)     # 256: clear
    pos = np.arange(n) + np.arange(n) // _LZW_RUN + 1
    codes[pos] = index
    codes[-1] = 257                                   # end of information
    bits = ((codes[:, None] >> np.arange(9, dtype=np.uint16)) & 1)
    data = np.packbits(bits.astype(np.uint8).ravel(), bitorder="little")
    full, rest = divmod(data.size, 255)
    body = np.empty((full, 256), np.uint8)
    body[:, 0] = 255
    body[:, 1:] = data[:full * 255].reshape(full, 255)
    tail = (bytes([rest]) + data[full * 255:].tobytes()) if rest else b""
    return body.tobytes() + tail + b"\x00"
