"""Host-side recursive AABB tree builder.

Port of `opencl_path_tracer_tpu/accel/median_tree.py`
(median_tree.py:28-156), host numpy in float64 as there, so its output
(nodes, order, pad mask, depth, leaf_size) is bit-equal to the JAX
package's. Two policies:

* `split='midpoint_mean'`, the reference's builder (NodeOnHost::build,
  main.cpp:210-262): a leaf at <= max_leaf (6) triangles, the split plane
  at the mean of the triangle midpoints, the axis depth % 3, the next
  axis while either side is empty, midpoints <= plane on the right; where
  the midpoints are identical on every axis (the reference loops forever)
  the index list is halved.
* `split='median'` (the default): equal halves at the centroid median on
  the longest axis (a stable sort), so the depth is ceil(log2(T /
  leaf_size)).

Both emit the flat pointer format of accel/types.py with sibling nodes
in adjacent slots. With object_ranges, one subtree is built per object
(the reference's per-shape trees, main.cpp:536-551) under a balanced
internal tree over the objects; each object's subtree starts again at
depth 0.
"""

from __future__ import annotations

import sys

import numpy as np

from opencl_path_tracer_tpu_torch.accel.types import BVH, finalize_bvh
from opencl_path_tracer_tpu_torch.core.geometry import TrianglesSoA


def build_median_tree(tris: TrianglesSoA, *, leaf_size: int = 4,
                      split: str = "median",
                      max_leaf: int = 6,
                      object_ranges=None) -> BVH:
    """Build the host AABB tree.

    object_ranges: optional (num_objects, 2) [from, to) triangle ranges
    (Scene.object_ranges). When given, one subtree is built per object —
    the reference builds one kd tree per OBJ shape and traverses them via
    a start-offset table (Scene::end_Obj main.cpp:536-551,
    prog.cl:151-166). In the flat pointer format a separate shift table
    is unnecessary: the per-object subtrees hang under a balanced
    internal "object hierarchy", so one traversal visits exactly the
    same per-object trees the reference walks, with cross-object
    bbox pruning for free.
    """
    r1 = tris.r1.cpu().numpy().astype(np.float64)
    r2 = tris.r2.cpu().numpy().astype(np.float64)
    r3 = tris.r3.cpu().numpy().astype(np.float64)
    lo_all = np.minimum(np.minimum(r1, r2), r3)
    hi_all = np.maximum(np.maximum(r1, r2), r3)
    mid = (r1 + r2 + r3) / 3.0  # vertex-mean midpoint (main.cpp:175-181)
    t_count = r1.shape[0]

    leaf_cap = max_leaf if split == "midpoint_mean" else leaf_size
    # Every leaf occupies exactly `stride` slots in the reordered array
    # (padding rows are degenerate never-hit triangles), so the traversal
    # reads a fixed-size contiguous block per leaf.
    stride = max(leaf_size, leaf_cap)

    nodes: list[list[float]] = [[0.0] * 8]  # slot 0 = root
    order: list[int] = []
    pad: list[bool] = []
    max_depth = [0]

    def fill_leaf(slot: int, idx: np.ndarray, lo, hi) -> None:
        start = len(order)
        k = len(idx)
        assert k <= stride
        order.extend(int(i) for i in idx)
        order.extend([0] * (stride - k))
        pad.extend([False] * k + [True] * (stride - k))
        nodes[slot] = [*lo, *hi, float(start), float(start + k)]

    def process(slot: int, idx: np.ndarray, depth: int) -> None:
        max_depth[0] = max(max_depth[0], depth)
        lo = lo_all[idx].min(0)
        hi = hi_all[idx].max(0)
        if len(idx) <= leaf_cap:
            fill_leaf(slot, idx, lo, hi)
            return

        m = mid[idx]
        if split == "midpoint_mean":
            # Reference policy (main.cpp:236-257); note it puts midpoints
            # <= plane on the RIGHT (main.cpp:241-244).
            plane = m.mean(0)
            axis = depth % 3
            for _ in range(3):
                right = m[:, axis] <= plane[axis]
                if right.any() and (~right).any():
                    left_idx, right_idx = idx[~right], idx[right]
                    break
                axis = (axis + 1) % 3
            else:
                # All midpoints identical on every axis (the reference
                # would loop forever here, main.cpp:246-257): split the
                # index list arbitrarily in half instead.
                half = len(idx) // 2
                left_idx, right_idx = idx[:half], idx[half:]
        else:
            axis = int(np.argmax(hi - lo))
            ordv = np.argsort(m[:, axis], kind="stable")
            half = len(idx) // 2
            left_idx, right_idx = idx[ordv[:half]], idx[ordv[half:]]

        left_slot = len(nodes)
        nodes.append([0.0] * 8)
        nodes.append([0.0] * 8)
        nodes[slot] = [*lo, *hi, -float(left_slot), 0.0]
        process(left_slot, left_idx, depth + 1)
        process(left_slot + 1, right_idx, depth + 1)

    obj_levels = [0]

    def process_objects(slot: int, groups: list[np.ndarray],
                        depth: int) -> None:
        """Balanced internal tree over per-object triangle groups; each
        single-object node roots that object's own subtree (the
        reference's per-shape trees, main.cpp:536-551). Per-object
        subtrees restart at depth 0, like the reference's independent
        builds (axis = depth % 3 cycles from x in every tree)."""
        obj_levels[0] = max(obj_levels[0], depth)
        if len(groups) == 1:
            process(slot, groups[0], 0)
            return
        idx = np.concatenate(groups)
        lo = lo_all[idx].min(0)
        hi = hi_all[idx].max(0)
        half = len(groups) // 2
        left_slot = len(nodes)
        nodes.append([0.0] * 8)
        nodes.append([0.0] * 8)
        nodes[slot] = [*lo, *hi, -float(left_slot), 0.0]
        process_objects(left_slot, groups[:half], depth + 1)
        process_objects(left_slot + 1, groups[half:], depth + 1)

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 100000))
    try:
        if object_ranges is not None and len(object_ranges) > 1:
            groups = [
                np.arange(int(a), int(b)) for a, b in object_ranges
            ]
            process_objects(0, groups, 0)
        else:
            process(0, np.arange(t_count), 0)
    finally:
        sys.setrecursionlimit(old_limit)
    max_depth[0] += obj_levels[0]

    return finalize_bvh(
        np.asarray(nodes, np.float32),
        np.asarray(order, np.int64),
        np.asarray(pad, bool),
        tris, depth=max_depth[0], leaf_size=stride,
    )
