"""30-bit Morton codes of triangle centroids.

Port of `morton3` and `_expand_bits` of
`opencl_path_tracer_tpu/accel/lbvh.py` (lbvh.py:28-44), in numpy: the
pair intersector's cluster build (`ops/kernels/march_kernel.py`) orders
triangles by these codes on the host. The rest of the JAX module (the
device-side LBVH build) is not ported yet.
"""

from __future__ import annotations

import numpy as np


def _expand_bits(v: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of v (uint32) so they occupy every 3rd bit."""
    v = np.asarray(v, np.uint32)
    v = (v * np.uint32(0x00010001)) & np.uint32(0xFF0000FF)
    v = (v * np.uint32(0x00000101)) & np.uint32(0x0F00F00F)
    v = (v * np.uint32(0x00000011)) & np.uint32(0xC30C30C3)
    v = (v * np.uint32(0x00000005)) & np.uint32(0x49249249)
    return v


def morton3(q: np.ndarray) -> np.ndarray:
    """30-bit Morton codes (uint32) from float32 coordinates q in [0, 1),
    (N, 3): each axis scaled by 1024 in float32, clipped to [0, 1023] and
    truncated."""
    q = np.asarray(q, np.float32)
    scaled = np.clip(q * np.float32(1024.0), np.float32(0.0),
                     np.float32(1023.0)).astype(np.uint32)
    return ((_expand_bits(scaled[:, 0]) << np.uint32(2))
            | (_expand_bits(scaled[:, 1]) << np.uint32(1))
            | _expand_bits(scaled[:, 2]))
