"""The BVH walker: every ray through one loop of lockstep steps.

Port of `make_bvh_intersect` with `_slab` and `_leaf_test`
(`opencl_path_tracer_tpu/accel/traverse.py:42-188`), which the JAX
package runs as plain XLA (`lax.while_loop`, no Pallas kernel), so the
port runs it as plain PyTorch on the rays' device. Each ray (lane) owns
a state: done, node, an (R, D) stack, sp, the best t and its index.
Every step does both kinds of work with selects instead of branches:

* at an internal node, the slab test of both children (clamped row
  gathers; NaN from (lo - p) * inf fails the test, as
  `torch.maximum`/`minimum` propagate it like jnp's), pruned against
  the best t, a descent into the nearer child that passed and a push of
  the farther one when both did;
* at a leaf, the plane and edge tests of its `leaf_size` rows,
  t = (c0 - pn) / vn, the first minimum;
* with no child to descend into, a pop, or done on an empty stack.

A finished lane's step leaves its state as it is, so the loop reads the
done flags on the host only every `CHECK_EVERY` steps (one sync per
check), and there drops the finished lanes from the state (their best
t and index are final): the result is the JAX loop's, which steps every
lane until the last one is done. `intersect.iterations` is that step
count for the last call (`intersect.steps`, the steps run).

Rounding. XLA compiles the loop body even when nothing is jitted, and
its CPU backend contracts the dot products (the port computes the four
of a row in one pass over its (4, 4) view): pn, vn, pm and vm are
fma(x2, r2, fma(x0, r0, x1 * r1)) (LLVM fuses the first of two products
into the add) and the edge value fma(t, vm, pm) - dk. Of the orders
probed only this one gave JAX's t on every hit lane of 3,000 random rays
(the chain from x0 up: 74 %); `tests/test_torch_bvh.py` holds every lane
bit-equal on random and Cornell rays. inv_d = 1 /
d is a true division, as JAX's eager one, and the hit point p + d t is
rounded twice, as JAX's eager ops outside the loop.
"""

from __future__ import annotations

import torch

from opencl_path_tracer_tpu_torch.accel.types import BVH
from opencl_path_tracer_tpu_torch.core import fp
from opencl_path_tracer_tpu_torch.core.types import Hits, Rays

BIG = 3.0e38
CHECK_EVERY = 8   # steps between host reads of done.all()


def _dots(x, rows):
    """The dot products of x (three (2, R, 1, 1): P's and D's components)
    with columns 0-2 of each group of four of the (R, L, 4, 4) rows, as
    XLA's loop body rounds them (see the module docstring): (2, R, L, 4),
    P's then D's."""
    return fp.fma(x[2], rows[..., 2],
                  fp.fma(x[0], rows[..., 0], x[1] * rows[..., 1]))


def _slab(krows, p3, inv3):
    """Slab test of the (R, 2, 8) child rows against p3 and inv3 ((R, 3)
    each): (hit, tmin), (R, 2) each. The running max and min over the
    axes from -BIG and BIG propagate NaN, as jnp.maximum and minimum do,
    in any order."""
    t1 = (krows[:, :, 0:3] - p3[:, None, :]) * inv3[:, None, :]
    t2 = (krows[:, :, 3:6] - p3[:, None, :]) * inv3[:, None, :]
    tmin = torch.clamp(torch.minimum(t1, t2).amax(2), min=-BIG)
    tmax = torch.clamp(torch.maximum(t1, t2).amin(2), max=BIG)
    return (tmax >= tmin) & (tmax >= 0.0), tmin


def _leaf_test(tri_pack, base, pd3, leaf_size):
    """The nearest valid hit of the (2, R, 3) rays pd3 (P, D) among the
    leaf_size rows from base: (t, index), t = BIG on a miss, the first
    minimum. The rows [n c0 | m1 d1 | m2 d2 | m3 d3] are viewed as four
    groups of four."""
    r = base.shape[0]
    idx = base[:, None] + torch.arange(leaf_size, device=base.device)[None, :]
    rows = tri_pack[idx.clamp(0, tri_pack.shape[0] - 1)].view(
        r, leaf_size, 4, 4)
    pd, vd = _dots(tuple(pd3[:, :, k, None, None] for k in range(3)), rows)
    t = (rows[..., 0, 3] - pd[..., 0]) / vd[..., 0]
    edge = fp.fma(t[..., None], vd[..., 1:], pd[..., 1:]) - rows[..., 1:, 3]
    valid = (t > 0.0) & (edge >= 0.0).all(-1)
    t = torch.where(valid, t, torch.full_like(t, BIG))
    tbest, local = t.min(1)
    return tbest, idx.gather(1, local[:, None])[:, 0]


def make_bvh_intersect(bvh: BVH, max_stack: int | None = None):
    """intersect(rays) -> Hits over the BVH (the stack holds depth + 2
    entries unless max_stack says otherwise)."""
    depth = int(bvh.depth) + 2 if max_stack is None else max_stack
    leaf = int(bvh.leaf_size)
    nodes = bvh.nodes
    last = nodes.shape[0] - 1

    def step(st, lanes):
        """One lockstep step of every lane of the state dict st."""
        done, node, sp, best_t = st["done"], st["node"], st["sp"], st["t"]
        row = nodes[node.clamp(0, last)]                          # (R, 8)
        a = row[:, 6]
        is_leaf = a >= 0.0
        lt, li = _leaf_test(bvh.tri_pack, a.to(torch.int64), st["pd"], leaf)
        take = is_leaf & ~done & (lt < best_t)
        st["t"] = best_t = torch.where(take, lt, best_t)
        st["i"] = torch.where(take, li, st["i"])
        left = (-a).to(torch.int64)
        kids = torch.stack([left, left + 1], 1)                   # (R, 2)
        khit, ktmin = _slab(nodes[kids.clamp(0, last)], st["pd"][0],
                            st["inv"])
        khit = khit & (ktmin < best_t[:, None]) & ~is_leaf[:, None]
        near = torch.where(ktmin[:, 0] <= ktmin[:, 1], 0, 1)[:, None]
        far = 1 - near
        near_hit = khit.gather(1, near)[:, 0]
        far_hit = khit.gather(1, far)[:, 0]
        near_node = kids.gather(1, near)[:, 0]
        far_node = kids.gather(1, far)[:, 0]
        do_push = near_hit & far_hit & ~done
        stack = torch.where(do_push[:, None] & (lanes[None, :] == sp[:, None]),
                            far_node[:, None], st["stack"])
        sp = torch.where(do_push, sp + 1, sp)
        descend = (near_hit | far_hit) & ~is_leaf & ~done
        need_pop = ~descend & ~done
        can_pop = sp > 0
        sp_pop = torch.clamp(sp - 1, min=0)
        popped = stack.gather(1, sp_pop.clamp(max=depth - 1)[:, None])[:, 0]
        st["node"] = torch.where(descend,
                                 torch.where(near_hit, near_node, far_node),
                                 torch.where(can_pop, popped, node))
        st["sp"] = torch.where(need_pop & can_pop, sp_pop, sp)
        st["stack"] = stack
        fin = need_pop & ~can_pop
        st["done"] = done | fin
        return fin

    def intersect(rays: Rays) -> Hits:
        p, d = rays.p, rays.d
        r = rays.count
        dev = p[0].device
        lanes = torch.arange(depth, device=dev)
        best_t = torch.full((r,), BIG, device=dev)
        best_i = torch.zeros(r, dtype=torch.int64, device=dev)
        done_at = torch.zeros(r, dtype=torch.int64, device=dev)
        dd = torch.stack(d, 1)
        st = {"pd": torch.stack([torch.stack(p, 1), dd]),        # (2, R, 3)
              "inv": torch.ones_like(dd) / dd,
              "done": torch.zeros(r, dtype=torch.bool, device=dev),
              "node": torch.zeros(r, dtype=torch.int64, device=dev),
              "stack": torch.zeros((r, depth), dtype=torch.int64, device=dev),
              "sp": torch.zeros(r, dtype=torch.int64, device=dev),
              "t": best_t.clone(), "i": best_i.clone(),
              "at": done_at.clone(),
              "id": torch.arange(r, device=dev)}
        steps = 0
        while st["id"].numel():
            for _ in range(CHECK_EVERY):
                fin = step(st, lanes)
                st["at"] = torch.where(fin, steps, st["at"])
                steps += 1
            done = st["done"]
            n_done = int(done.sum())
            if not n_done:
                continue
            ids = st["id"][done]
            best_t[ids] = st["t"][done]
            best_i[ids] = st["i"][done]
            done_at[ids] = st["at"][done]
            if n_done == st["id"].numel():
                break
            keep = ~done
            for k, v in st.items():
                st[k] = v[:, keep] if k == "pd" else v[keep]
        intersect.iterations = int(done_at.max()) + 1 if r else 0
        intersect.steps = steps
        any_hit = best_t < BIG
        z = torch.zeros_like(best_t)
        safe_t = torch.where(any_hit, best_t, z)
        safe_i = best_i.clamp(0, bvh.tri_n.shape[0] - 1)
        return Hits(
            t=torch.where(any_hit, best_t, torch.full_like(best_t, -1.0)),
            p=tuple(torch.where(any_hit, p[k] + d[k] * safe_t, z)
                    for k in range(3)),
            n=tuple(torch.where(any_hit, bvh.tri_n[safe_i, k], z)
                    for k in range(3)),
            mati=torch.where(any_hit, bvh.tri_mati[safe_i], 0).to(torch.int32),
        )

    intersect.iterations = 0
    intersect.steps = 0
    return intersect
