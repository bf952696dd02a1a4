"""LBVH: the device-side BVH build, and 30-bit Morton codes.

Port of `opencl_path_tracer_tpu/accel/lbvh.py`: `morton3` and
`_expand_bits` (lbvh.py:28-44) in numpy, which the pair intersector's
cluster build (`ops/kernels/march_kernel.py`) uses on the host, and
`_lbvh_arrays` with `build_lbvh` (:47-145) in plain PyTorch on the
scene's device (plain XLA in the JAX package: no Pallas kernel): Morton
codes of the triangle centroids, one stable sort of the codes (int64
keys, the padding keys 0xFFFFFFFF last, as `lax.sort_key_val` keeps
equal keys in index order), a perfect binary tree over the sorted order
whose boxes reduce level by level, and heap-ordered rows (children of
slot s at 2 s + 1 and 2 s + 2: a = -(2 s + 1)), the format of
accel/types.py. The jitted JAX build rounds mid = (r1 + r2 + r3) / 3.0
and (mid - lo) / extent as true divisions (no reciprocal), which
`core/fp.py::div` and a tensor division give on every device
(tests/test_torch_bvh.py holds the trees bit-equal).
"""

from __future__ import annotations

import numpy as np
import torch

from opencl_path_tracer_tpu_torch.accel.types import BVH
from opencl_path_tracer_tpu_torch.core import fp
from opencl_path_tracer_tpu_torch.core.geometry import TrianglesSoA

BIG = 3.0e38


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


def _expand_bits_t(v: torch.Tensor) -> torch.Tensor:
    """_expand_bits on int64 tensors (the masks drop what uint32 wraps)."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def _morton3_t(q: torch.Tensor) -> torch.Tensor:
    """morton3 of (N, 3) float32 q on its device, as int64."""
    scaled = torch.clamp(q * 1024.0, 0.0, 1023.0).to(torch.int64)
    return ((_expand_bits_t(scaled[:, 0]) << 2)
            | (_expand_bits_t(scaled[:, 1]) << 1)
            | _expand_bits_t(scaled[:, 2]))


def _ceil_log2(x: int) -> int:
    return max(0, (x - 1).bit_length())


def build_lbvh(tris: TrianglesSoA, *, leaf_size: int = 4) -> BVH:
    """The LBVH over the scene's triangles, on their device."""
    t_count = tris.count
    depth = _ceil_log2(-(-t_count // leaf_size))
    num_leaves = 1 << depth
    p_total = num_leaves * leaf_size
    dev = tris.device
    r1, r2, r3 = tris.r1, tris.r2, tris.r3
    lo = torch.minimum(torch.minimum(r1, r2), r3)
    hi = torch.maximum(torch.maximum(r1, r2), r3)
    mid = fp.div(r1 + r2 + r3, 3.0)
    scene_lo = lo.amin(0)
    extent = torch.clamp(hi.amax(0) - scene_lo, min=1e-9)
    codes = _morton3_t((mid - scene_lo) / extent)
    codes = torch.cat([codes, torch.full((p_total - t_count,), 0xFFFFFFFF,
                                         dtype=torch.int64, device=dev)])
    _, order = torch.sort(codes, stable=True)
    pad_mask = order >= t_count
    safe = torch.where(pad_mask, 0, order)
    # Payload: the intersection constants (16), the normal (3), mati (1).
    extra = torch.cat([tris.n, tris.c0[:, None], tris.m1, tris.d1[:, None],
                       tris.m2, tris.d2[:, None], tris.m3, tris.d3[:, None],
                       tris.n, tris.mati.to(torch.float32)[:, None]], 1)
    pm = pad_mask[:, None]
    lo_r = torch.where(pm, BIG, lo[safe])
    hi_r = torch.where(pm, -BIG, hi[safe])
    extra_r = torch.where(pm, 0.0, extra[safe])
    levels_lo = [lo_r.reshape(num_leaves, leaf_size, 3).amin(1)]
    levels_hi = [hi_r.reshape(num_leaves, leaf_size, 3).amax(1)]
    while levels_lo[0].shape[0] > 1:
        cur_lo, cur_hi = levels_lo[0], levels_hi[0]
        levels_lo.insert(0, torch.minimum(cur_lo[0::2], cur_lo[1::2]))
        levels_hi.insert(0, torch.maximum(cur_hi[0::2], cur_hi[1::2]))
    rows = []
    for lvl, (llo, lhi) in enumerate(zip(levels_lo, levels_hi)):
        n_l = llo.shape[0]
        if lvl == len(levels_lo) - 1:   # the leaves
            a = torch.arange(n_l, dtype=torch.float32, device=dev) * leaf_size
            b = a + leaf_size
        else:
            slots = (1 << lvl) - 1 + torch.arange(n_l, device=dev)
            a = -(2.0 * slots.to(torch.float32) + 1.0)
            b = torch.zeros(n_l, device=dev)
        rows.append(torch.cat([llo, lhi, a[:, None], b[:, None]], 1))
    return BVH(
        nodes=torch.cat(rows),
        tri_pack=extra_r[:, :16].contiguous(),
        tri_n=extra_r[:, 16:19].contiguous(),
        tri_mati=extra_r[:, 19].to(torch.int32),
        depth=depth,
        leaf_size=leaf_size,
    )
