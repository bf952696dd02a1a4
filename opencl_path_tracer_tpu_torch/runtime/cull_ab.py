"""K17 (the cluster intersector), K7 (the any-hit test), K6 (the
tile-culled nearest hit), K16 (the mask-grouped intersector), K14 (the
fused minarg), K15 (the mxu dense intersect) or K3b (the sphere table)
built from two source trees and timed in one process.

No counterpart in `opencl_path_tracer_tpu`. Compares the kernel of this
checkout with the kernel of another checkout's `csrc/`, on the inputs
`chip_smoke.py` checks them on:

- `--kernel cluster`: K17 over the stress scene's 777 clusters of 128
  (tiles of 256 rays, each tile's list from `_tile_cluster_lists`,
  early exit off as the 'cluster' accel runs it), on the 1080p camera
  rays, or with `--bounce N` on the rays of the N-th bounce (the camera
  rays' hits shaded N times);
- `--kernel anyhit`: K7 over the Cornell box's Morton groups of 128
  rows, on the NEE shadow rays (`shadow_rays`) at the hits of the 1080p
  camera rays, or with `--bounce N` at the hits of the N-th bounce's
  rays; `--scene reference` takes the reference scene
  (tests/assets/models) and its camera instead;
- `--kernel tilecull`: K6 over the Cornell box's Morton groups of 128
  rows ordered front to back from the camera's eye, as the 'tilecull'
  accel builds them, on the 1080p camera rays or with `--bounce N` the
  N-th bounce's rays; `--scene reference` as for K7;
- `--kernel group`: K16 over the reference scene's 15 clusters of 128
  (`build_clusters(split_large=True)`), on the 1080p camera rays or the
  N-th bounce's, mask-sorted in blocks of 2,048 by `group_inputs`, as
  the 'group' accel runs it (the line also times `group_inputs`, the
  plain passes that make K16's inputs); `--scene cornell` takes the
  Cornell box's 7 clusters instead;
- `--kernel minarg_fused`, `--kernel mxu`: K14 or K15 over the Cornell
  box's pack (804 rows in scene order, 26 sub-blocks), as the injected
  intersectors build it, on the 1080p camera rays or the N-th bounce's;
  `--scene reference` as for K7 (1,838 rows);
- `--kernel sphere_table`: K3b over the many-light scene's 66 spheres
  (`--scene stress-analytic`: the analytic stress scene's 138) and their
  `sphere_groups`, on the 1080p Cornell camera rays or the N-th bounce's,
  with this tree's counting entry's counts (box tests made and passed,
  pairs whose disc it computed, pairs with disc > 0, groups some ray of a
  warp entered). A base without `ptx_sphere_table_simt` is the first
  kernel (table only).

A source tree whose library exports `ptx_<kernel>_simt` takes the
sub-block table of the skip rule and a ballot threshold (this tree's
interface); one without takes neither (the first kernels' interface).
Both builds use `_build`'s nvcc flags and run as base, this, this, base
(each the mean of --reps launches timed with CUDA events), must give
equal outputs, and one JSON line (per ballot threshold of this tree's
kernel given with --coop, the wrapper's by default; a base with a table
takes the wrapper's) reports the four times with what the inputs ask of
the kernel: K17's clusters listed per tile and (ray, triangle) tests
over the listed clusters; K7's and K6's groups, K16's clusters, that a
block of 256 rays stages where any of its rays needs one, and the (ray,
triangle) tests the first kernel runs (K7: each needing ray until its
first hit below rmax; K6: each needing ray through the group's rows; K16:
each ray through every cluster of its block's union). Where this tree
has the counting entry, the line also has its counts at the wrapper's
threshold: the tests that reached the divide (and their share of the
first kernel's tests), the sub-block box tests that passed, those of
them run by the whole warp, the edge tests reached, and the box (K7, K6:
and group slab) tests made. Needs a GPU:

    python -m opencl_path_tracer_tpu_torch.runtime.cull_ab \\
        --kernel cluster|anyhit|tilecull|group|minarg_fused|mxu|sphere_table \\
        [--bounce N] [--scene cornell|reference|many-lights|stress-analytic] \\
        [--coop N ...] --base DIR

where DIR is, for example, the `opencl_path_tracer_tpu_torch/csrc` of a
`git archive` of the parent commit unpacked in a gitignored directory.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re

import torch

from opencl_path_tracer_tpu_torch.runtime.minarg_ab import (
    _bounce, _compile, time_in_turns)

W, H = 1920, 1080
P, I = ctypes.c_void_p, ctypes.c_int
# The first kernels' C interfaces (no table, no ballot threshold).
FIRST_ARGTYPES = {"cluster": [P, P, P, P, P, P, I, I, I, I, I, P],
                  "anyhit": [P, I, P, P, P, P, I, I, P],
                  "tilecull": [P, I, P, P, P, P, I, I, P],
                  "group": [P, P, P, P, I, I, I, I, P],
                  "minarg_fused": [P, P, P, P, P, P, P, I, I, P],
                  "mxu": [P, P, P, I, I, P],
                  "sphere_table": [P, P, P, P, P, P, P, I, I, P]}
CHUNK = 1 << 18   # rays per pass of the plain counts


def shadow_rays(scene, cam, rays, isect):
    """The shadow rays (and their rmax = dist (1 - 1e-3)) that NEE traces
    at the first hits of `rays`, one per lane, captured from
    `ops.nee.direct_light` itself."""
    from opencl_path_tracer_tpu_torch.core.types import vdot, vneg, vwhere
    from opencl_path_tracer_tpu_torch.models import megakernel
    from opencl_path_tracer_tpu_torch.ops import nee, rng
    n = rays.count
    hit, mat = megakernel.fetch_material(scene.mats, isect, rays)
    n_vec = vwhere(vdot(rays.d, hit.n) > 0.0, vneg(hit.n), hit.n)
    table = nee.build_emitter_table(scene.tris, scene.mats, scene.spheres)
    u = rng.fast_uniforms(rng.key(7), 0, 10_000, n, 3, device=rays.device)
    ones = tuple(torch.ones(n, device=rays.device) for _ in range(3))
    got = {}

    def capture(shadow, rmax):
        got["rays"], got["rmax"] = shadow, rmax
        return torch.zeros_like(rmax, dtype=torch.bool)

    nee.direct_light(table, intersect_fn=None, cam_eye=cam.eye, hit_p=hit.p,
                     n_vec=n_vec, mat=mat, f_l=ones, f_b=ones, f_s=ones,
                     f_r=ones, is_diff=hit.valid & (mat.type == 0), u1=u[0],
                     u2=u[1], u3=u[2], occluded_fn=capture)
    return got["rays"], got["rmax"].contiguous()


def escape_rays(scene, cam, rays, isect, em):
    """The escape rays (rmax 3.0e38) that the environment gather of
    `em` (an `ops.envmap.EnvMap`) traces at the first hits of `rays`, one
    per lane, captured from `ops.envmap.direct_light_env` itself."""
    from opencl_path_tracer_tpu_torch.core.types import vdot, vneg, vwhere
    from opencl_path_tracer_tpu_torch.models import megakernel
    from opencl_path_tracer_tpu_torch.ops import envmap, rng
    n = rays.count
    hit, mat = megakernel.fetch_material(scene.mats, isect, rays)
    n_vec = vwhere(vdot(rays.d, hit.n) > 0.0, vneg(hit.n), hit.n)
    u = rng.fast_uniforms(rng.key(7), 0, 30_000, n, 3, device=rays.device)
    ones = tuple(torch.ones(n, device=rays.device) for _ in range(3))
    got = {}

    def capture(shadow, rmax):
        got["rays"], got["rmax"] = shadow, rmax
        return torch.zeros_like(rmax, dtype=torch.bool)

    envmap.direct_light_env(
        em, intersect_fn=None, cam_eye=cam.eye, hit_p=hit.p, n_vec=n_vec,
        mat=mat, f_l=ones, f_b=ones, f_s=ones, f_r=ones,
        is_diff=hit.valid & (mat.type == 0), u1=u[0], u2=u[1], u3=u[2],
        occluded_fn=capture)
    return got["rays"], got["rmax"].contiguous()


def anyhit_staging(s8, rmax, pack, groups, block=256):
    """What the first K7 kernel does on these inputs: (groups staged per
    block of `block` rays (a group is staged where any ray of the block
    needs it), (ray, triangle) tests run (each needing ray through a
    group's rows until its first hit below rmax))."""
    from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
    from opencl_path_tracer_tpu_torch.ops.kernels import tilecull_kernel as tk
    r = s8.shape[1]
    n_blocks = -(-r // block)
    staged = tests = 0
    gl = groups.cpu().tolist()
    for s in range(0, r, CHUNK):
        x, rm = s8[:, s:s + CHUNK], rmax[s:s + CHUNK]
        inv = [tk._safe_inv(c) for c in x[3:6]]
        occ = torch.zeros_like(rm, dtype=torch.bool)
        for row in gl:
            tn, tf = tk._slab(x[0:3], inv, row[0:3], row[3:6])
            need = (tf >= tn) & (tf >= 0.0) & (tn <= rm) & ~occ
            pad = -need.shape[0] % block
            staged += int(torch.nn.functional.pad(need, (0, pad))
                          .view(-1, block).any(1).sum())
            base, end = int(row[6]), int(row[7])
            t, valid = k1.exact_test(pack[base:end], x)
            hit = valid & (t < rm[None])
            first = torch.where(hit.any(0), hit.int().argmax(0) + 1,
                                torch.full_like(rm, end - base,
                                                dtype=torch.int64))
            tests += int(first[need].sum())
            occ |= need & hit.any(0)
    return staged / n_blocks, tests


def tilecull_staging(r8, pack, groups, block=256):
    """What the first K6 kernel does on these rays: (groups staged per
    block of `block` rays (a group is staged where any ray of the block
    needs it: its slab test passes and tn < its best t so far), (ray,
    triangle) tests run (each needing ray through all the group's
    rows))."""
    from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
    from opencl_path_tracer_tpu_torch.ops.kernels import tilecull_kernel as tk
    r = r8.shape[1]
    n_blocks = -(-r // block)
    staged = tests = 0
    gl = groups.cpu().tolist()
    for s in range(0, r, CHUNK):
        x = r8[:, s:s + CHUNK]
        inv = [tk._safe_inv(c) for c in x[3:6]]
        best = torch.full_like(x[0], k1.BIG)
        for row in gl:
            tn, tf = tk._slab(x[0:3], inv, row[0:3], row[3:6])
            need = (tf >= tn) & (tf >= 0.0) & (tn < best)
            pad = -need.shape[0] % block
            staged += int(torch.nn.functional.pad(need, (0, pad))
                          .view(-1, block).any(1).sum())
            base, end = int(row[6]), int(row[7])
            tests += int(need.sum()) * (end - base)
            t, valid = k1.exact_test(pack[base:end], x)
            tm = torch.where(valid & need[None], t, torch.full_like(t, k1.BIG))
            best = torch.minimum(best, tm.min(0).values)
    return staged / n_blocks, tests


def _load(name, path, log, flags):
    """(the entry, whether it takes the sub-block table, ptxas's frame,
    spills and registers); flags: whether a minarg_fused entry takes its
    scratch of flags (this tree's K14, its rare path in a second kernel)."""
    lib = ctypes.CDLL(str(path))
    table = hasattr(lib, f"ptx_{name}_simt")
    fn = getattr(lib, f"ptx_{name}")
    from opencl_path_tracer_tpu_torch.ops.kernels import _build
    argtypes = list(_build.KERNELS[name][2] if table
                    else FIRST_ARGTYPES[name])
    if table and name == "minarg_fused" and not flags:
        del argtypes[8]
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    regs = [[int(x) for x in m] for m in re.findall(
        r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) "
        r"bytes spill loads\s+ptxas info\s+: Used (\d+) registers", log)]
    return fn, table, regs


def _cluster_case(args, dev):
    """K17's inputs and stats: (the launch arguments before the table and
    after the outputs, those that only a kernel with a table takes, the
    outputs' shape, the table's and the counting entry's makers, the
    JSON fields)."""
    from opencl_path_tracer_tpu_torch.ops.kernels import cluster_kernel as ck
    from opencl_path_tracer_tpu_torch.scene import library
    scene = library.stress_scene(device=dev)
    cam = library.cornell_camera(W, H, device=dev)
    rays = _camera_rays(cam, dev)
    for _ in range(args.bounce):
        rays = _bounce(scene, cam, rays)
    cscene, c, k = ck.build_clusters(scene.tris, 128)
    rows = cscene.rows()
    tr = 256
    rr8 = ck.pack_rays_rows(rays.p, rays.d, -(-rays.count // tr) * tr)
    ids, cnt, ent = ck._tile_cluster_lists(rr8, cscene.boxes, tr)
    g = cnt.shape[0]
    info = {"clusters": c, "k": k, "tiles": g,
            "listed_per_tile": float(cnt.float().mean()),
            "tests": int(cnt.sum()) * tr * k}

    def table():
        return ck.cluster_sub_boxes(rows, k)

    def counted(sub):
        return ck.run_cluster_counted(rr8, cnt, ids, ent, rows, k, tr,
                                      False, sub)[1]

    def alloc():
        return (torch.empty((6, rr8.shape[0]), device=dev),)

    return ((rr8, cnt, ids, ent, rows), (g, tr, c, k, 0), (), alloc, table,
            counted, info)


def _anyhit_case(args, dev):
    """K7's inputs and stats, as `_cluster_case`'s."""
    from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
    from opencl_path_tracer_tpu_torch.ops.kernels import tilecull_kernel as tk
    from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
    scene, cam = _scene_camera(args.scene, dev)
    rays = _camera_rays(cam, dev)
    for _ in range(args.bounce):
        rays = _bounce(scene, cam, rays)
    shadow, rmax = shadow_rays(scene, cam, rays,
                               make_intersect_fn(scene, "auto"))
    s8 = k1.pack_rays(shadow.p, shadow.d).contiguous()
    pack, groups, _ = tk.grouped_pack(scene.tris, 128)
    r = s8.shape[1]
    staged, tests = anyhit_staging(s8, rmax, pack, groups)
    info = {"scene": args.scene, "triangles": pack.shape[0],
            "groups": groups.shape[0], "staged_per_block": staged,
            "first_kernel_tests": tests}

    sub = tk.anyhit_sub_boxes(pack, groups)

    def counted(sub):
        return tk.anyhit_counted(s8, rmax, pack, groups, sub)[1]

    def alloc():
        return (torch.empty(r, dtype=torch.bool, device=dev),)

    return ((s8, s8.stride(0), rmax, pack, groups), (r, groups.shape[0]),
            (sub.shape[0],), alloc, lambda: sub, counted, info)


def _scene_camera(name, dev):
    from opencl_path_tracer_tpu_torch.scene import library
    if name == "cornell":
        return (library.cornell_box(with_spheres=True, device=dev),
                library.cornell_camera(W, H, device=dev))
    models = pathlib.Path(__file__).resolve().parents[2] / "tests" / (
        "assets/models")
    return (library.reference_scene(str(models), smooth=True, device=dev),
            library.reference_camera(W, H, device=dev))


def _tilecull_case(args, dev):
    """K6's inputs and stats, as `_cluster_case`'s."""
    from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
    from opencl_path_tracer_tpu_torch.ops.kernels import tilecull_kernel as tk
    scene, cam = _scene_camera(args.scene, dev)
    rays = _camera_rays(cam, dev)
    for _ in range(args.bounce):
        rays = _bounce(scene, cam, rays)
    r8 = k1.pack_rays(rays.p, rays.d).contiguous()
    eye = tuple(float(v) for v in cam.eye.cpu())
    pack, groups, _ = tk.grouped_pack(scene.tris, 128, origin=eye)
    r = r8.shape[1]
    staged, tests = tilecull_staging(r8, pack, groups)
    info = {"scene": args.scene, "triangles": pack.shape[0],
            "groups": groups.shape[0], "staged_per_block": staged,
            "first_kernel_tests": tests}
    sub = tk.anyhit_sub_boxes(pack, groups)

    def counted(sub):
        return tk.tilecull_counted(r8, pack, groups, sub)[1]

    def alloc():
        return tuple(torch.empty(r, device=dev) for _ in range(2))

    return ((r8, r8.stride(0), pack, groups), (r, groups.shape[0]),
            (sub.shape[0],), alloc, lambda: sub, counted, info)


def _group_case(args, dev):
    """K16's inputs and stats, as `_cluster_case`'s."""
    from opencl_path_tracer_tpu_torch.ops.kernels import cluster_kernel as ck
    from opencl_path_tracer_tpu_torch.ops.kernels import sorted_intersect as si
    scene, cam = _scene_camera(args.scene, dev)
    rays = _camera_rays(cam, dev)
    for _ in range(args.bounce):
        rays = _bounce(scene, cam, rays)
    gscene, c, k = ck.build_clusters(scene.tris, 128, split_large=True)
    rows = gscene.rows()
    block = 2048
    _, union, g8 = si.group_inputs(rays, gscene.boxes, block)
    # The plain passes before K16 (masks, sort, unions), for scale.
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(args.reps):
        si.group_inputs(rays, gscene.boxes, block)
    e1.record()
    torch.cuda.synchronize(dev)
    rpad = g8.shape[0]
    # Every block of 256 rays lies in one group of 2,048: the first kernel
    # stages its group's union, and every ray tests all of it.
    bits = sum(((union >> b) & 1).long() for b in range(c))
    info = {"scene": args.scene, "clusters": c, "k": k,
            "staged_per_block": float(bits.float().mean()),
            "first_kernel_tests": int(bits.sum()) * block * k,
            "group_inputs_ms": e0.elapsed_time(e1) / args.reps}

    def counted(sub):
        return si.run_group_counted(union, g8, rows, k, block, sub)[1]

    def alloc():
        return (torch.empty((5, rpad), device=dev),)

    return ((union, g8, rows), (rpad, block, c, k), (), alloc,
            lambda: ck.cluster_sub_boxes(rows, k), counted, info)


def _dense_case(args, dev):
    """K14's or K15's inputs and stats, as `_cluster_case`'s: the pack in
    scene order and its one-span table."""
    from opencl_path_tracer_tpu_torch.ops.kernels import cluster_kernel as ck
    from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
    from opencl_path_tracer_tpu_torch.ops.kernels import plucker_kernel as k2
    scene, cam = _scene_camera(args.scene, dev)
    rays = _camera_rays(cam, dev)
    for _ in range(args.bounce):
        rays = _bounce(scene, cam, rays)
    r8 = k1.pack_rays(rays.p, rays.d).contiguous()
    pack = k1.build_tri_pack(scene.tris)
    r, t = r8.shape[1], pack.shape[0]
    sub = ck.sub_boxes(pack, [(0, t)])
    info = {"scene": args.scene, "triangles": t,
            "sub_blocks": sub.shape[0], "first_kernel_tests": r * t}
    if args.kernel == "minarg_fused":
        def counted(sub):
            return k2.minarg_fused_counted(r8, pack, sub)[1]

        def alloc():
            return tuple(torch.empty(r, device=dev) for _ in range(5))
    else:
        def counted(sub):
            return k1.mxu_counted(r8, pack, sub)[1]

        def alloc():
            return (torch.empty((6, r), device=dev),)
    return ((r8, pack), (r, t), (), alloc, lambda: sub, counted, info)


def _sphere_ab(args, dev, fns, tables, regs) -> int:
    """K3b of both trees in turns (see the module docstring): one JSON
    line; 0 when every output is equal."""
    from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
    from opencl_path_tracer_tpu_torch.ops.kernels import sphere_kernel as k3
    from opencl_path_tracer_tpu_torch.scene import library
    scene = (library.stress_scene(analytic=True, device=dev)
             if args.scene == "stress-analytic"
             else library.many_light_scene(64, device=dev))
    cam = library.cornell_camera(W, H, device=dev)
    rays = _camera_rays(cam, dev)
    for _ in range(args.bounce):
        rays = _bounce(scene, cam, rays)
    r8 = k1.pack_rays(rays.p, rays.d).contiguous()
    table = k3.build_sphere_table(scene.spheres)
    groups = k3.sphere_groups(table)
    r, s, g = r8.shape[1], table.shape[0], groups.data.shape[0]
    outs = {k: [torch.empty(r, device=dev) for _ in range(5)] for k in fns}
    stream = torch.cuda.current_stream(dev).cuda_stream
    counts = k3.sphere_table_counted(r8, table, groups)[1]

    def launch(k):
        if tables[k]:
            a = (r8, table, groups.data, *outs[k], r, g)
        else:
            a = (r8, table, *outs[k], r, s)
        err = fns[k](*(x.data_ptr() if isinstance(x, torch.Tensor)
                       else x for x in a), stream)
        if err:
            raise RuntimeError(f"sphere_table ({k}) failed: "
                               f"cudaError_t {err}")

    order, times = time_in_turns(launch, args.reps, dev)
    equal = all(torch.equal(a, b) for a, b in zip(outs["base"], outs["this"]))
    made, passed, n_disc, n_sqrt, n_warp = counts
    print(json.dumps({
        "kernel": "sphere_table", "scene": args.scene,
        "bounce": args.bounce, "rays": r, "spheres": s, "groups": g,
        "box_tests": made, "box_passed_per_ray": passed / r,
        "disc_pairs_per_ray": n_disc / r, "sqrt_pairs_per_ray": n_sqrt / r,
        "groups_entered_per_warp": n_warp * 32 / r,
        "first_kernel_pairs_per_ray": s, "reps": args.reps,
        "device": torch.cuda.get_device_name(dev), "tables": tables,
        "order": list(order), "ms": times,
        "ptxas_frame_spills_registers": regs,
        "base_ms": (times[0] + times[3]) / 2,
        "this_ms": (times[1] + times[2]) / 2, "outputs_equal": equal,
    }))
    return int(not equal)


def _camera_rays(cam, dev):
    from opencl_path_tracer_tpu_torch.ops import raygen, rng
    s1, r1 = rng.lehmer_step(rng.seed_pixel_streams(W * H, 1, device=dev))
    _, r2 = rng.lehmer_step(s1)
    return raygen.camera_rays(cam, raygen.pixel_ids(W, H, dev), r1, r2)


def main(argv=None) -> int:
    from opencl_path_tracer_tpu_torch.ops.kernels import _build
    from opencl_path_tracer_tpu_torch.ops.kernels import cluster_kernel as ck
    from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
    from opencl_path_tracer_tpu_torch.ops.kernels import plucker_kernel as k2
    from opencl_path_tracer_tpu_torch.ops.kernels import sorted_intersect as si
    from opencl_path_tracer_tpu_torch.ops.kernels import tilecull_kernel as tk
    from opencl_path_tracer_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", required=True,
                    choices=("cluster", "anyhit", "tilecull", "group",
                             "minarg_fused", "mxu", "sphere_table"))
    ap.add_argument("--base", required=True, type=pathlib.Path,
                    help="the csrc/ directory of the checkout to compare")
    ap.add_argument("--bounce", type=int, default=0,
                    help="rays of this bounce (0: the camera rays)")
    ap.add_argument("--scene", choices=("cornell", "reference",
                                        "many-lights", "stress-analytic"),
                    default=None, help="K7's, K6's, K16's, K14's or K15's "
                    "scene, cornell or reference (default: cornell, for K16 "
                    "reference); K3b's, many-lights (the default) or "
                    "stress-analytic")
    ap.add_argument("--coop", type=int, nargs="+", default=None,
                    help="ballot thresholds of this tree's kernel, one "
                    "line each (default: the wrapper's)")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if args.scene is None:
        args.scene = {"group": "reference",
                      "sphere_table": "many-lights"}.get(args.kernel,
                                                         "cornell")
    sphere = args.kernel == "sphere_table"
    if sphere != (args.scene in ("many-lights", "stress-analytic")):
        ap.error(f"--scene {args.scene} is not a scene of {args.kernel}")
    dev = resolve_device("cuda")
    name = args.kernel
    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = {"base": args.base.resolve(), "this": _build.CSRC}
    libs = {k: out_dir / f"lib{name}_{k}.so" for k in srcs}
    procs = {k: _compile(d, libs[k], f"{name}.cu") for k, d in srcs.items()}
    # Whether each tree's K14 takes a scratch of flags after its outputs.
    flags = {k: name == "minarg_fused" and "start_kernel" in (
        d / "minarg_fused.cu").read_text() for k, d in srcs.items()}
    fns, tables, regs = {}, {}, {}
    for k, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {k}:\n{log}")
        fns[k], tables[k], regs[k] = _load(name, libs[k], log, flags[k])
    if sphere:
        return _sphere_ab(args, dev, fns, tables, regs)

    case = {"cluster": _cluster_case, "anyhit": _anyhit_case,
            "tilecull": _tilecull_case, "group": _group_case,
            "minarg_fused": _dense_case, "mxu": _dense_case}[name]
    before, after, extra, alloc, table, counted, info = case(args, dev)
    sub = table() if any(tables.values()) else None
    default = {"cluster": ck.CLUSTER_COOP, "anyhit": tk.ANYHIT_COOP,
               "tilecull": tk.TILECULL_COOP, "group": si.GROUP_COOP,
               "minarg_fused": k2.MINARG_FUSED_COOP,
               "mxu": k1.MXU_COOP}[name]
    if tables["this"]:
        # The counting entry at the wrapper's threshold (only the whole
        # warp's share depends on it).
        n_div, n_box, n_coop, n_edge, n_tests = counted(sub)
        info.update({"divide_tests": n_div, "box_passed": n_box,
                     "box_passed_warp": n_coop, "edge_tests": n_edge,
                     "box_tests": n_tests})
        if "first_kernel_tests" in info:
            info["divide_share"] = n_div / max(info["first_kernel_tests"], 1)
    outs = {k: alloc() for k in fns}
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = (k2.start_flags(before[0].shape[1], dev),)

    def this_extra(k):
        return scratch if flags[k] else ()

    def ptr(a):
        return a.data_ptr() if isinstance(a, torch.Tensor) else a

    status = 0
    for coop in args.coop or [default]:
        def launch(k):
            if tables[k]:
                a = (*before, sub, *outs[k], *this_extra(k), *after, *extra,
                     coop if k == "this" else default)
            else:
                a = (*before, *outs[k], *after)
            err = fns[k](*(ptr(x) for x in a), stream)
            if err:
                raise RuntimeError(f"{name} ({k}) failed: cudaError_t {err}")

        order, times = time_in_turns(launch, args.reps, dev)
        equal = all(torch.equal(a, b)
                    for a, b in zip(outs["base"], outs["this"]))
        status |= not equal
        print(json.dumps({
            "kernel": name, "bounce": args.bounce, **info,
            "coop_max": coop if tables["this"] else None, "reps": args.reps,
            "device": torch.cuda.get_device_name(dev), "tables": tables,
            "order": list(order), "ms": times,
            "ptxas_frame_spills_registers": regs,
            "base_ms": (times[0] + times[3]) / 2,
            "this_ms": (times[1] + times[2]) / 2, "outputs_equal": equal,
        }))
    return status


if __name__ == "__main__":
    raise SystemExit(main())
