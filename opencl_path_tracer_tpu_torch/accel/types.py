"""The flat BVH format shared by every builder and the walker.

Port of `opencl_path_tracer_tpu/accel/types.py` (types.py:44-95): one
tree over the whole scene, its nodes one (N, 8) float32 matrix of rows
[lo.x lo.y lo.z hi.x hi.y hi.z a b]. a < 0 marks an internal node
whose left child is row -a (the right child is the next row); a >= 0 a
leaf holding triangles [a, a + leaf_size) of the reordered array (b is
its true count; the slots past it are padding rows). Padding rows are
all zero: n = 0 gives t = 0/0, which never hits. The triangles are
reordered and leaf-padded as (Tp, 16) float32 rows [n c0 m1 d1 m2 d2 m3
d3], the plane and edge-test constants, beside their normals and
material ids. The arrays are built on the host and live on the scene's
device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from opencl_path_tracer_tpu_torch.core.geometry import TrianglesSoA


@dataclasses.dataclass(frozen=True)
class BVH:
    nodes: torch.Tensor     # (N, 8) float32, see the module docstring
    tri_pack: torch.Tensor  # (Tp, 16) float32 intersection constants
    tri_n: torch.Tensor     # (Tp, 3) float32 unit normals (hit records)
    tri_mati: torch.Tensor  # (Tp,) int32 material ids
    depth: int              # the tree's depth (sizes the walker's stack)
    leaf_size: int          # rows per leaf

    @property
    def num_nodes(self) -> int:
        return self.nodes.shape[0]


def pack_triangles(tris: TrianglesSoA) -> np.ndarray:
    """(T, 16) float32 intersection-constant rows, on the host."""
    def col(x):
        x = x.cpu().numpy()
        return x[:, None] if x.ndim == 1 else x

    return np.concatenate(
        [col(tris.n), col(tris.c0), col(tris.m1), col(tris.d1),
         col(tris.m2), col(tris.d2), col(tris.m3), col(tris.d3)],
        axis=1).astype(np.float32)


DEGENERATE_ROW = np.zeros(16, np.float32)  # n = 0 -> t = nan -> never hits


def finalize_bvh(nodes: np.ndarray, order: np.ndarray, pad_mask: np.ndarray,
                 tris: TrianglesSoA, depth: int, leaf_size: int) -> BVH:
    """A BVH on the triangles' device from a builder's host output: order
    (Tp,) indices into the triangles (padding slots arbitrary), pad_mask
    (Tp,) True where the slot is padding."""
    pack = pack_triangles(tris)[order]
    pack[pad_mask] = DEGENERATE_ROW
    tri_n = tris.n.cpu().numpy()[order]
    tri_mati = tris.mati.cpu().numpy()[order].astype(np.int32)
    tri_mati[pad_mask] = 0
    dev = tris.device
    return BVH(
        nodes=torch.as_tensor(np.asarray(nodes, np.float32), device=dev),
        tri_pack=torch.as_tensor(pack, device=dev),
        tri_n=torch.as_tensor(np.ascontiguousarray(tri_n), device=dev),
        tri_mati=torch.as_tensor(tri_mati, device=dev),
        depth=int(depth),
        leaf_size=int(leaf_size),
    )
