#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`opencl_path_tracer_tpu_torch`).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's twenty-three CUDA kernels from
`opencl_path_tracer_tpu_torch/csrc/`, holds each against its plain
PyTorch version at 1080p ray and lane counts, renders the three goldens
of `tests/golden/` through the kernels, and drives the main paths at
1920x1080 and 5 bounces, each with the launch counts reset just before
and read just after:

  * the megakernel model (`RenderEngine.render`) on the Cornell box and
    the analytic Cornell box, 8 spp;
  * the wavefront model (`RenderEngine` with model='wavefront') on the
    analytic Cornell box, 8 spp;
  * the fused fast pipeline (`models.pipeline.render_fast`) on the
    Cornell box, 64 steps;
  * next-event estimation (nee=True, shadow rays through the any-hit
    kernel): the megakernel on the Cornell box, the wavefront model on
    the sphere-lamp box, and the wavefront model with the 'distance'
    select on the many-light scene (64 lamps, 66 spheres), 8 spp each;
  * the megakernel with accel='tilecull' on the Cornell box, 8 spp;
  * smooth shading (smooth=True, K1 then the smooth refine K8): the
    megakernel on the reference's own scene (`reference_scene` with the
    seven models of tests/assets/models, 1,838 triangles, its own
    camera) and on the Cornell box with smooth spheres, and the
    wavefront model with NEE on the reference scene with its two sphere
    models as analytic spheres, 8 spp each;
  * the 100k-triangle stress scene (`stress_scene`, 99,380 triangles)
    through accel 'auto' = 'pairwin' (K4 seed, K9 candidates, K10 pair
    visits, K4 tail, K11 attribute fetch): the megakernel and the
    wavefront model, the megakernel with smooth shading (K1 + K2 seed,
    K1 tail, ids), and the megakernel on `stress-analytic` (20
    triangles and 138 analytic spheres: K1 + K2 and K3b), 2 spp each.
    K9, K10 and K11 are held against their plain versions at the stress
    scene's 1080p shapes, and the pair intersector's t against K4's on
    its camera and first-bounce rays;
  * the cluster-pack accels: 'pair' on the stress scene (the pair
    intersector at its own defaults: K4 seed, K9 on the 8-column boxes
    of 195 Morton clusters of 512, the VPU pairs round K12, K4 tail), 2
    spp; 'cluster' (K17 over 777 clusters of 128) on the stress scene, 1
    spp; 'group' (K16) on the reference scene (15 clusters) and on the
    Cornell box (7 clusters), 8 spp each. K12, K17 and K16 are held
    against their plain versions at 1080p, and each accel's hits against
    K4's on its camera and first-bounce rays;
  * the march family on the stress scene: 'march' (K18m copies, K18
    rounds 1 and 2 over 195 clusters of 512, K4 tail) and 'flat' (K18
    round 0 and K19 over 389 clusters of 256, K4 tail), 2 spp each, and
    the lazy-certification wavefront (`models.lazy`, K20, K4 for pending
    lanes; cs 512, tr 256, K 4, fast mode) for LAZY_STEPS steps after 2.
    K18, K18m, K19 and K20 are held against their plain versions at 1080p
    (K18, K19 and K20 on their first PLAIN_BLOCKS blocks), the 'march'
    and 'flat' hits against K4's over the reordered triangles on the
    camera and first-bounce rays, and the lazy lanes certified with a hit
    against K4's hit;
  * the two intersectors that no accel names, injected into the
    megakernel model on the Cornell box, 8 spp each: K14 (K1 and K2 in
    one launch) through `make_minarg_intersect(fuse_fetch=True)` and K15
    (K4's outputs with the dots rounded as one matmul) through
    `make_mxu_intersect`; neither path may launch K1 or K2, nor the mxu
    path K4. K14 is held against its plain version and against K1 + K2
    on the Cornell camera and first-bounce rays and the reference camera
    rays, K15 against its plain version on the Cornell rays, with its
    lanes that differ from K4's counted.

K4 splits its triangles across blocks when the rays alone cannot fill
the card (`intersect_kernel.dense_splits`): it is held against its plain
version in both output layouts on the Cornell camera rays (one loop),
at the stress tails' 16,384 lanes and on 300 lanes against a pack whose
rows repeat (exact-t ties across chunks), with the splits printed, and
timed at the tails' shape and on the fused slice with one loop and with
other splits. K18m is also held against its plain version on an odd L
and on views at storage offsets.

K18 runs its edge values on the tensor cores behind a certified margin:
it is also held against its first kernel (every product on the float32
cores, `march_kernel.run_march_simt`) on every K18 launch that the
'march' (rounds 1 and 2) and 'flat' (round 0) intersectors make on the
camera rays, whole, with the edge tests that the margin sent to the
float32 chain printed per launch, and the two are timed in turns on
'march' round 1. K9 is held against its plain version at every l the
paths use (2, 6, 14 and 48 on the 16-column table, 8, 16 and 48 on the
8-column one). The build line is followed by ptxas's registers, stack
frame and spills of every entry function of K18 and K9.

K13a runs its edge values on the tensor cores behind K18's certified
margin and stops its scan at the live triangle count; K1 settles the
pairs it can by sign or distance before the divide in warps of coherent
rays and divides every pair of the others without a branch per ray.
Each is held against its first kernel (`plucker_kernel.run_candidates_simt`,
`intersect_kernel.minarg_simt`) and its plain version: K13a on every
launch of the fused pipeline's first two steps at 1080p, with the edge
tests the margin sent to the float32 chain printed per launch; K1 on the
cornell and reference camera and first-bounce rays, the stress-analytic
triangles and tests/minarg_rays.py's adversarial batch (and a pack whose
rows repeat), with the shares of warps in the joint loop and of pairs
that reached the divide and the edge tests; K13a also where whole chunks
of padding follow a live count that ends a chunk. Both are timed in
turns against their first kernels (K1 on camera and bounce rays), and
the build line is followed by ptxas's report of their entry functions
too. No main path may launch a check-only entry (CHECK_ONLY).

K19 and K20 run K18's tensor-core visit too (march_mma.cuh), K19 over
its segments cut into chunks of at most `flat_march.CHUNK` real visits,
the longest segments' chunks first. Each is held against its first
kernel (`flat_march.run_flat_simt`, `lazy_march.run_lazy_march_simt`)
whole and its plain version on the first PLAIN_BLOCKS blocks: K19 on
the 'flat' intersector's launches on the camera and first-bounce rays
(with the chain's share and the segment statistics printed), K20 on the
lazy pipeline's first two steps; each is timed in turns against its
first kernel (K19 also unsplit and at other chunk sizes), and the
kernels line has a K19 row on the first-bounce rays.

K10 runs K18's tensor-core visit too, with the features computed from
the rays in the kernel; K12 skips, per pair, the sub-blocks of 32 rows
whose outward-rounded boxes (`sorted_intersect.pair_sub_boxes`) its
segment misses. Each is held against its first kernel
(`pair_mxu.pair_visits_simt`, `sorted_intersect.run_pairs_simt`), its
counting entry and its plain version on round 1 of the stress camera
and first-bounce pairs, with the counts printed (K10's edge tests sent
to the float32 chain; K12's tests that reached the divide, edge tests
and sub-blocks tested, from which its bound counts its operations),
timed in turns against its first kernel on both, and the kernels line
has K10 and K12 rows on the first-bounce pairs.

K17 and K7 skip, per ray, the sub-blocks of 32 rows whose boxes
(`cluster_kernel.sub_boxes`, the table K12's rule reads) the ray's
segment to its running best (K17) or to rmax (K7) misses, with nothing
staged for a block. K17 is held against its first kernel
(`cluster_kernel.run_cluster_simt`) and its counting entry on the
stress camera and first-bounce rays (and against its plain version on
the first CLUSTER_PLAIN_TILES first-bounce tiles), K7 against its first
kernel (`tilecull_kernel.anyhit_simt`), its counting entry and its
plain version on the NEE shadow rays of bounces 0, 1 and 2 of cornell
and reference, with the clusters listed per tile, the sub-blocks passed
per ray and each check's time printed; each is timed in turns against
its first kernel, and the kernels line has K17 rows on the camera and
first-bounce rays and K7 rows on the three shadow batches of cornell,
their bounds counted from the tests the rule leaves. `megakernel
cornell nee` must launch K7 on every bounce but the last, whose NEE
contribution is zero. The kernels line's plain times are one call each
(the checks' own calls where they time one).

K6 and K16 skip, per ray, the sub-blocks of 32 rows whose boxes (K7's
table for K6, K17's for K16) the ray's segment to its running best
misses, with nothing staged for a block. K6 is held against its first
kernel (`tilecull_kernel.tilecull_simt`) and its counting entry on the
cornell camera and first-bounce rays, K16 (`sorted_intersect.
run_group_simt`) on the reference camera and first-bounce rays and on
the 'group' accel's own launches on the cornell camera and first-bounce
rays (there also against its plain version; the other plain checks are
above), with the groups or clusters a first kernel's block stages, the
tests it runs and the counts printed; each is timed in turns against its
first kernel, and the kernels line has K6 rows on the cornell camera and
first-bounce rays and K16 rows on the reference camera and first-bounce
rays, their bounds counted from the tests the rule leaves.

K14 and K15 walk their pack's sub-blocks of 32 rows in row order and
skip, per ray, those whose boxes (the pack's one-span table) the ray's
segment to its running best misses (K15 none while its best is above
BIG), with nothing staged for a block. Each is held against its first
kernel (`plucker_kernel.minarg_fused_simt`, `intersect_kernel.
mxu_simt`) and its counting entry on the cornell camera and first-bounce
rays and the reference camera rays, and against its plain version and
first kernel (K14 also K1 + K2) on tests/sub_cull_mirror.py's crafted
batches, with the sub-blocks passed and the tests that reach the divide
printed; each is timed in turns against its first kernel, and the
kernels line has their rows on the cornell camera and first-bounce rays,
their bounds counted from the tests the rule leaves.

Checkpoints and adaptive sampling (`check_slice18`, after the main
paths above, with the same counts reset before and read after each
path): a parity resume (2 spp, `RenderEngine.save`, `load` into a new
engine, 2 spp) equals an unbroken render with torch.equal on the colors,
Lehmer states and samples, for `megakernel cornell resume` (K1, K2;
unbroken = 4 spp) and `wavefront cornell-sphere-lamp nee resume` (K1,
K2, K3, K7; unbroken = 2 spp then 2 spp in one engine: NEE's draws key on
the step counter, and the split moves the steps at which a lane
bounces), with each checkpoint's size and its save and load seconds
printed. `wavefront cornell-sphere-lamp nee adaptive` is
`RenderEngine.render_adaptive` in parity mode (tol 0.05, min_spp 8, a
cap of 32): it prints the buckets it stepped (at least one below
2,073,600), spp min / mean / max and its Mrays/s and samples/s beside
the fixed 32-spp render of the same engine configuration; pixels below
the cap satisfy the stop rule.
NEE's draws also key on lane position, so compaction changes that
render's bits (in the JAX package too); the equality of compaction on
and off is held on `wavefront cornell-sphere-lamp adaptive` (the same
render without NEE: K1, K2, K3; off is `models.wavefront.render_adaptive`
with compact=False), colors and samples by pixel. K1, K2, K3 and K7 are
held against their plain versions at every bucket size of the 1080p
ladder, 2,073,600 halved down to 8,100.

The engine's interactive state, the environment and depth of field
(`check_slice19`, at 1920x1080, 5 bounces, fast mode): `megakernel
cornell frame` runs FRAMES `RenderEngine.frame(1/60)` calls with real
time off (a sync every third sample), holds 'w' for FRAMES_MOVE frames,
releases it and runs FRAMES_AFTER more; the sample counter restarts on
the move and the release, an idle frame reuses the controller's camera,
and the last frames equal a fresh engine's samples at the moved pose
(torch.equal: fast draws key on the sample counter); it prints frames/s,
Mrays/s and the meter's line. `megakernel cornell envmap-sunsky` (2 spp)
traces the environment gather's escape rays through K7 at rmax 3.0e38;
its flags on the bounce-0 and bounce-1 escape rays equal K7's plain
version and its counting entry, and (K4 t valid and t < 3.0e38) but for
zero-area strips. `wavefront cornell-sphere-lamp nee envmap-gradient`
(the emitter and the environment gathers in one step), `megakernel
cornell-analytic env` (the dormant sky, EnvLight) and `megakernel cornell
dof` (aperture 20, focus 600) render 2 spp each. The kernels line has an
`anyhit escape` row (K7 on the bounce-1 escape rays).

Image textures, the à-trous denoiser and the 3x3 median
(`check_slice20`, at 1920x1080, 5 bounces, fast mode, TEX_SPP samples):
`scene.library.textured_room` writes a closed room's OBJ + MTL and two
seeded PNG maps (256 x 256 and 48 x 80, so the atlas pads; the ceiling's
map_Kd names a missing file, which must warn) into a temporary directory
and loads them through `SceneBuilder.add_obj`: `textured-room` (14
triangles, the lamp quad among them, and an analytic sphere of a
textured material) and `textured-grid` (the room and a 64 x 64 quad
floor, 8,206 triangles: 'auto' resolves to 'pairwin' with ids). On the
1080p camera rays and the first-bounce rays, the textured intersector of
'minarg', 'tilecull' and 'pairwin' (the room) and of 'minarg' and
'pairwin' (the grid) is held against the plain reference on the card
(`minarg_plain` over all triangles, lowest index on exact-t ties, the
spheres through `sphere_intersect`): its ids intersector's winner is the
reference's, or on an exact-t tie a triangle whose own exact test gives
the same t; its Hits torch.equal to the reference's at those winners
(p and n on hit lanes); its kd torch.equal to `kd_scale` on the CPU of
the reference's (mati, s, t, ok), a sphere winner exactly 1.0; over
30 % of the camera rays are textured. The intersectors run on every ray;
they are compared on every lane of the room and on every
GRID_REF_STRIDE-th lane of the grid (the reference over 8,206 triangles
takes 42 s a 1080p ray set on the H100). `megakernel textured-room nee`
(K1, K2, K3, K7), `wavefront textured-room` (K1, K2, K3) and
`megakernel textured-grid` (K1, K2 on the walls, K9, K10, K11) render
NaN-free and unlike the untextured render; their samples/s and Mrays/s are printed.
The megakernel render's denoise: the guides torch.equal to the CPU's,
the filter within DENOISE_RTOL of the CPU's on the same colours, its
time printed; the median torch.equal to the CPU's. `ptx-torch render
--scene room.obj --textured` with `--denoise` and with `--median` writes
its PNGs, and the missing map warns.

The tilecull presort, the auto accel's predictor and spectral
dispersion (`check_slice21`, at 1920x1080, 5 bounces, fast mode):
`make_tilecull_intersect(presort='octant'|'morton')` on the cornell
camera and first-bounce rays, with and without ids, gives Hits (and ids)
torch.equal to presort='none'; K6 on the permuted rays equals its plain
version and its launch on the rays in order, permuted; K6, the
permutation, the gather, the unpermute and the whole intersector are
timed in turns against 'none', and the kernels line has a `tilecull
presorted bounce` row. `runtime/accel_anchors.measure` times
'megakernel' with 'minarg' and 'tilecull' in turns on the auto accel's
four anchors (3 turns of 4 spp) and prints each anchor's predicted
fraction and the predictor's host seconds; an 'auto' engine's pick
equals `auto_small_accel` at AUTO_TILECULL_THRESHOLD on each, and the
threshold rule's result on this run is printed. `megakernel cornell
repick` ('auto') goes 5 -> 1 -> 5 -> 1 bounces by the controller's keys,
a frame each: one intersector per depth, the second visit reusing it,
NaN-free frames. `wavefront cornell-analytic nee dispersion`
(`models.spectral.render_dispersive`, SPECTRAL_SPP spp a band, NEE's
shadow rays through K7): three bands at v_d None torch.equal to
`render_wavefront` + `colors_by_pixel`, five within 1e-6, three at v_d
30 NaN-free and unlike the flat render, more than half of the values
equal to it. `ptx-torch render --dispersion 30 --nee` writes its 1080p
PNG and `--model megakernel` is refused. Where 'auto' resolves a main
path's triangles to 'tilecull' on the card (the predictor's pick), the
path must launch K6 and K2 in place of K1 (and of K8): `path_kernels`;
`megakernel cornell minarg` and `megakernel reference smooth minarg`
keep K1, K2 and K8 on main paths by name.

The bvh and median walkers, K10's full form and the pair options
(`check_slice22`, at 1920x1080, 5 bounces, fast mode): K10's full form
(five streams) on round 1's pairs of the 'pairmx' shape (K9's 8 nearest
of the clusters of 512, tiles of 512) of the stress camera and
first-bounce rays is torch.equal to its plain version on the first
K10_PLAIN_PAIRS pairs, its t and pend to the thin form's and its
attributes to K11's fetch of the thin form's winners on the whole
launch, with and without infeat (the fused features), and the kernels
line has `pair_visit_full` rows. `megakernel stress pairmx` (STRESS_SPP)
renders through the engine (K4, K9, K10's full form; neither the thin
form nor K11), and its intersector's t equals K4's on the camera and
first-bounce rays, n and mati but at exact-t ties (each counted lane
checked to be one), with the schedule printed. move='chain' with
PAIR_TPU_WINNER's other settings is held to K4 the same way and timed in
turns against move='sort'; approx=True (thin and full) prints its
resolved share and its resolved lanes' Hits equal the exact path's.
'bvh' and 'median' with force on the cornell camera rays and the first
BVH_RAYS stress first-bounce rays: hit masks and t within rtol 1e-4 of
K4's, each lane outside a ray grazing an edge; their iterations and ms
a call; `megakernel cornell bvh` (1 spp) renders and launches no kernel
of the port. `build_median_tree_native` on stress is bit-equal to the
Python builder and `load_obj_native` equals `io/obj.py` on every model
of tests/assets/models. `check_no_fallback` also holds K10's full form to
its kernel (no plain version on CUDA) and 'bvh' and 'median' refused on
CUDA without force.

The interactive front end (`check_slice23`, at 1920x1080, 5 bounces,
fast mode, every path inside `plain_guard`, under which a plain version
handed a CUDA tensor raises): `megakernel cornell nee anim` is
`runtime/anim.render_animation` ('auto', NEE: the predictor's pick, K2,
K7) over three poses of a 30-degree pan about the box's middle (ORBIT)
at ANIM_SPP, each frame np.array_equal to a fresh engine's display_u8()
at its pose through the same intersector, the frames unlike each other,
with its offline frames/s; `_write_gif_raw` on those frames, timed a
frame, its file walked block by block (GIF89a, the NETSCAPE2.0 loop 0,
one image a frame, local colour tables only); `ptx-torch anim` as a
subprocess with PIL hidden (2 frames, two PNGs and the raw writer's GIF)
and in process with --denoise and PIL's writers set aside; `wavefront
cornell-analytic nee dispersion anim` is `ptx-torch anim --dispersion 30
--bands 3 --nee` (2 frames at SPECTRAL_SPP), its images NaN-free, frame
0 torch.equal to `spectral.render_dispersive` at its pose and its PNG to
that image tonemapped; `megakernel cornell viewer` is
`runtime/viewer.ViewerServer` on 127.0.0.1, port 0, over HTTP: a 1080p
/frame.png, the published frames/s over FPS_WINDOW s and /stats'
viewer_fps, '+' to depth 6 and the engine's re-pick, 'n''s denoised
frames with error None, /stream.mjpg's JPEG parts where PIL is
installed and 404 without, /frame.png's encode ms through
`io.image.png_bytes`, and ESC stopping the server.
`check_no_fallback` also runs a 320x180 turntable and the viewer's fetch
inside `plain_guard`: their kernels launch, the fetch's host buffer is
pinned and its frame equals display_u8().

Multi-device rendering (`check_slice24`, 1920x1080, 5 bounces,
SLICE24_SPP spp, `parallel.launch.launch` from this process, each rank
entering `plain_guard` and driving its paths through `run_path`, so its
own counts show its kernels launched): a world of one NCCL rank with
devices=0 (every visible GPU) renders `megakernel cornell nee tiled`
(parity, NEE: K6, K2, K7) and `wavefront cornell-analytic tiled` (fast:
K1, K2, K3); a world of two gloo ranks on cuda:0 (NCCL refuses two ranks
on one GPU) renders `megakernel cornell tiled resume` (parity, a
checkpoint after the first sample), the same wavefront path and
`wavefront cornell tiled adaptive` (parity, no NEE, SLICE24_ADAPTIVE
with the bucket floor at SLICE24_MIN_BUCKET, each rank's bucket halved).
Each image is np.array_equal to the single-device engine's (and the
adaptive samples by pixel); the 2-rank checkpoint resumed on one device
finishes as the single-device render. Wall ms a sample of 2 more samples
is printed for each world beside one device's, as information only.
A rank's failure fails the launch and the script.

The last leftovers (`check_slice25`, 1920x1080, 5 bounces, inside
`plain_guard`): (a) `utils.check_deterministic` reruns each of
SLICE25_PATHS' steps (the megakernel's `trace_sample` from a fresh
state, the wavefront's step one step in; every accel from 'minarg' to
'median' with force, NEE through K7 and K3b, smooth K8), the fused
pipeline's step and the lazy step SLICE25_RUNS times from one state,
each as a main path whose kernels must launch, and fails on any output
bit that moves; the pixel sums with SLICE25_LANES lanes a pixel
(`colors_by_pixel`, the engine's `image()` and `display_u8_device()`)
in three lane layouts, rerun SLICE25_PIXEL_RUNS times and torch.equal to
the CPU's sums of the same lanes. (b) A parity render of `cornell`
('auto') against the port's scalar `prog.cl` oracle (`utils.oracle`) on
ORACLE_PIXELS seeded pixels: Lehmer states equal, colors within
tests/test_oracle.py's rtol and atol. (c) `utils.device_timer` beside
`time_ms` on one `cornell` megakernel sample, in turns, and one sample
under `utils.trace_profile`, whose Chrome trace must name K6's
`__global__` function. (d) The twelve `examples_torch/` twins, each
`main([...])` in this process (04's one NCCL rank in its own), their
markers checked, their launches counted (04's from its rank) and added
to the kernels line. The phase runs after the kernels' timing rows.

The last two lines are a JSON object per kernel (time, plain time,
bound, launches) and the verdict; the line before them, the smoke's total
time. Any failed phase raises, and the
script exits non-zero without the verdict. It writes nothing but the
kernel build under the package's `_build/`, and the resume checks'
checkpoints, `check_slice20`'s scene files and PNGs and `check_slice23`'s
frames and GIFs in temporary directories, which it removes. The viewer
binds a loopback port and shuts its server down.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
W, H, BOUNCES, SPP, FUSED_STEPS = 1920, 1080, 5, 8, 64
STRESS_SPP = 2   # spp of the stress paths (cut from 8 for the smoke's time)
CLUSTER_SPP = 1  # spp of 'megakernel stress cluster' (cut from 8 likewise)
# K12's plain check runs on every round-1 pair of the stress camera rays
# when they need at most this many (pair, triangle) tests (about 15 s of
# the plain version on the H100), else on the first K12_PREFIX sorted
# pairs.
K12_PLAIN_CELLS = 6e9
K12_PREFIX = 2_097_152
# K18, K19 and K20 are held against their plain versions on the first
# PLAIN_BLOCKS blocks of sorted lanes of their 1080p inputs (the plain
# versions take about 1.5 ms per visit of 512 x 512 tests on the H100, and
# 'march' round 1 alone holds up to 97,200 visits); the kernels run on the
# whole input, and blocks are independent.
PLAIN_BLOCKS = 256
LAZY_STEPS = 24   # timed steps of 'lazy stress' after 2 warm-up steps
# K7's plain version on 1080p shadow rays in chunks of this many rays (its
# default of 8,192 takes about 6 s a call on the H100; a ray's flag does
# not depend on the chunk).
ANYHIT_PLAIN_CHUNK = 1 << 18
# K17's plain version runs on this many tiles of 256 stress first-bounce
# rays (each lists nearly all 777 clusters; about 1 s on the H100); the
# kernels run on all 8,100.
CLUSTER_PLAIN_TILES = 64
STRESS_TRIS = 99_380   # the JAX builders' count (library.py:325-406)
SLICE = 76_800   # lanes of the fused pipeline's exact slice at 1080p
# H100 SXM data sheet, dense, at the full 700 W power limit.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
GOLDENS = (  # file, cornell_box kwargs, bounces (tests/test_megakernel.py)
    ("cornell_16x16_i2_s4", dict(with_spheres=False), 2),
    ("cornell_spheres_16x16_i4_s4", dict(with_spheres=True), 4),
    ("cornell_analytic_16x16_i2_s4",
     dict(with_spheres=True, analytic_spheres=True), 2),
)
KERNEL_META = {
    "minarg": ("opencl_path_tracer_tpu_torch/csrc/minarg.cu",
               "opencl_path_tracer_tpu/ops/pallas/intersect_kernel.py:452"),
    "refine1": ("opencl_path_tracer_tpu_torch/csrc/refine1.cu",
                "opencl_path_tracer_tpu/ops/pallas/plucker_kernel.py:695"),
    "spheres": ("opencl_path_tracer_tpu_torch/csrc/spheres.cu",
                "opencl_path_tracer_tpu/ops/pallas/sphere_kernel.py:47"),
    "dense": ("opencl_path_tracer_tpu_torch/csrc/dense.cu",
              "opencl_path_tracer_tpu/ops/pallas/intersect_kernel.py:51"),
    "plucker_cand": ("opencl_path_tracer_tpu_torch/csrc/plucker_cand.cu",
                     "opencl_path_tracer_tpu/ops/pallas/plucker_kernel.py:212"),
    "plucker_refine": ("opencl_path_tracer_tpu_torch/csrc/plucker_refine.cu",
                       "opencl_path_tracer_tpu/ops/pallas/plucker_kernel.py"
                       ":292"),
    "fused_step": ("opencl_path_tracer_tpu_torch/csrc/fused_step.cu",
                   "opencl_path_tracer_tpu/models/fused_step.py:147"),
    "anyhit": ("opencl_path_tracer_tpu_torch/csrc/anyhit.cu",
               "opencl_path_tracer_tpu/ops/pallas/tilecull_kernel.py:449"),
    "tilecull": ("opencl_path_tracer_tpu_torch/csrc/tilecull.cu",
                 "opencl_path_tracer_tpu/ops/pallas/tilecull_kernel.py:179"),
    "sphere_table": ("opencl_path_tracer_tpu_torch/csrc/sphere_table.cu",
                     "opencl_path_tracer_tpu/ops/pallas/sphere_kernel.py:142"),
    "smooth_refine": ("opencl_path_tracer_tpu_torch/csrc/smooth_refine.cu",
                      "opencl_path_tracer_tpu/ops/pallas/shading_kernel.py"
                      ":89"),
    "pair_cand": ("opencl_path_tracer_tpu_torch/csrc/pair_cand.cu",
                  "opencl_path_tracer_tpu/ops/pallas/sorted_intersect.py"
                  ":419"),
    "pair_visit": ("opencl_path_tracer_tpu_torch/csrc/pair_visit.cu",
                   "opencl_path_tracer_tpu/ops/pallas/pair_mxu.py:141"),
    # K10's full form (thin=False, the 'pairmx' payload), another entry.
    "pair_visit_full": ("opencl_path_tracer_tpu_torch/csrc/pair_visit.cu",
                        "opencl_path_tracer_tpu/ops/pallas/pair_mxu.py:141"),
    "attr_fetch": ("opencl_path_tracer_tpu_torch/csrc/attr_fetch.cu",
                   "opencl_path_tracer_tpu/ops/pallas/pair_mxu.py:373"),
    "pair_vpu": ("opencl_path_tracer_tpu_torch/csrc/pair_vpu.cu",
                 "opencl_path_tracer_tpu/ops/pallas/sorted_intersect.py:312"),
    "cluster": ("opencl_path_tracer_tpu_torch/csrc/cluster.cu",
                "opencl_path_tracer_tpu/ops/pallas/cluster_kernel.py:245"),
    "group": ("opencl_path_tracer_tpu_torch/csrc/group.cu",
              "opencl_path_tracer_tpu/ops/pallas/sorted_intersect.py:121"),
    "march": ("opencl_path_tracer_tpu_torch/csrc/march.cu",
              "opencl_path_tracer_tpu/ops/pallas/march_kernel.py:232"),
    "materialize": ("opencl_path_tracer_tpu_torch/csrc/materialize.cu",
                    "opencl_path_tracer_tpu/ops/pallas/march_kernel.py:707"),
    "flat_march": ("opencl_path_tracer_tpu_torch/csrc/flat.cu",
                   "opencl_path_tracer_tpu/ops/pallas/flat_march.py:83"),
    "lazy_march": ("opencl_path_tracer_tpu_torch/csrc/lazy.cu",
                   "opencl_path_tracer_tpu/ops/pallas/lazy_march.py:50"),
    "minarg_fused": ("opencl_path_tracer_tpu_torch/csrc/minarg_fused.cu",
                     "opencl_path_tracer_tpu/ops/pallas/plucker_kernel.py"
                     ":601"),
    "mxu": ("opencl_path_tracer_tpu_torch/csrc/mxu.cu",
            "opencl_path_tracer_tpu/ops/pallas/intersect_kernel.py:291"),
}
# Every kernel of each main path must launch in that path's run.
PATH_KERNELS = {
    "megakernel cornell": ("minarg", "refine1"),
    "megakernel cornell-analytic": ("minarg", "refine1", "spheres"),
    "wavefront cornell-analytic": ("minarg", "refine1", "spheres"),
    "fused cornell": ("plucker_cand", "plucker_refine", "dense",
                      "fused_step"),
    "megakernel cornell nee": ("minarg", "refine1", "anyhit"),
    "wavefront cornell-sphere-lamp nee": ("minarg", "refine1", "spheres",
                                          "anyhit"),
    "wavefront many-lights nee-distance": ("minarg", "refine1",
                                           "sphere_table", "anyhit"),
    "megakernel cornell tilecull": ("tilecull", "refine1"),
    "megakernel reference smooth": ("minarg", "smooth_refine"),
    "wavefront reference-analytic smooth nee": ("minarg", "smooth_refine",
                                                "spheres", "anyhit"),
    "megakernel cornell smooth": ("minarg", "smooth_refine"),
    "megakernel stress": ("dense", "pair_cand", "pair_visit", "attr_fetch"),
    "wavefront stress": ("dense", "pair_cand", "pair_visit", "attr_fetch"),
    "megakernel stress smooth": ("minarg", "refine1", "pair_cand",
                                 "pair_visit", "attr_fetch"),
    "megakernel stress-analytic": ("minarg", "refine1", "sphere_table"),
    "megakernel stress pair": ("dense", "pair_cand", "pair_vpu"),
    "megakernel stress cluster": ("cluster",),
    "megakernel reference group": ("group",),
    "megakernel cornell group": ("group",),
    "megakernel stress march": ("materialize", "march", "dense"),
    "megakernel stress flat": ("materialize", "march", "flat_march", "dense"),
    "lazy stress": ("lazy_march", "dense"),
    "megakernel cornell minarg-fused": ("minarg_fused",),
    "megakernel cornell mxu": ("mxu",),
    "megakernel cornell resume": ("minarg", "refine1"),
    "wavefront cornell-sphere-lamp nee resume": ("minarg", "refine1",
                                                 "spheres", "anyhit"),
    "wavefront cornell-sphere-lamp nee adaptive": ("minarg", "refine1",
                                                   "spheres", "anyhit"),
    "wavefront cornell-sphere-lamp adaptive": ("minarg", "refine1",
                                               "spheres"),
    "megakernel cornell frame": ("minarg", "refine1"),
    "megakernel cornell envmap-sunsky": ("minarg", "refine1", "anyhit"),
    "wavefront cornell-sphere-lamp nee envmap-gradient": (
        "minarg", "refine1", "spheres", "anyhit"),
    "megakernel cornell-analytic env": ("minarg", "refine1", "spheres"),
    "megakernel cornell dof": ("minarg", "refine1"),
    "megakernel textured-room nee": ("minarg", "refine1", "spheres",
                                     "anyhit"),
    "wavefront textured-room": ("minarg", "refine1", "spheres"),
    "megakernel textured-grid": ("minarg", "refine1", "pair_cand",
                                 "pair_visit", "attr_fetch"),
    # 'auto' on the card may pick 'tilecull' for these scenes
    # (`path_kernels`): K1, K2 and K8 stay driven by explicit rows.
    "megakernel cornell minarg": ("minarg", "refine1"),
    "megakernel reference smooth minarg": ("minarg", "smooth_refine"),
    "megakernel cornell repick": ("minarg", "refine1"),
    "wavefront cornell-analytic nee dispersion": ("minarg", "refine1",
                                                  "spheres", "anyhit"),
    "megakernel stress pairmx": ("dense", "pair_cand", "pair_visit_full"),
    "megakernel cornell nee anim": ("minarg", "refine1", "anyhit"),
    "wavefront cornell-analytic nee dispersion anim": (
        "minarg", "refine1", "spheres", "anyhit"),
    "megakernel cornell viewer": ("minarg", "refine1"),
    # check_slice24's paths over a mesh, each rank's counts on its own.
    "megakernel cornell nee tiled": ("minarg", "refine1", "anyhit"),
    "wavefront cornell-analytic tiled": ("minarg", "refine1", "spheres"),
    "megakernel cornell tiled resume": ("minarg", "refine1"),
    "wavefront cornell tiled adaptive": ("minarg", "refine1"),
    # The walker is plain PyTorch: the path launches no kernel of the port.
    "megakernel cornell bvh": (),
}
FRAMES, FRAMES_MOVE, FRAMES_AFTER = 30, 3, 6   # check_slice19's frame path
TEX_SPP = 2   # spp of check_slice20's textured renders and its CLI calls
GRID_REF_STRIDE = 4   # check_slice20 holds every 4th grid lane to plain
DENOISE_RTOL = 2e-5   # the denoise, card against CPU (tests' ATROUS_RTOL)
ENV_SPP = 2   # spp of check_slice19's environment and DOF paths
SPECTRAL_SPP = 2   # spp a band of check_slice21's dispersive renders
DOF = (20.0, 600.0)   # aperture, focus: the middle of the box
ADAPTIVE_TOL, ADAPTIVE_MIN_SPP, ADAPTIVE_MAX_SPP = 0.05, 8, 32
# Kernels each main path must not launch: the injected intersectors of
# the last two run their one kernel in place of K1 + K2 (and K4).
PATH_EXCLUDES = {
    "megakernel cornell minarg-fused": ("minarg", "refine1"),
    "megakernel cornell mxu": ("minarg", "refine1", "dense"),
    "megakernel stress pairmx": ("pair_visit", "attr_fetch"),
    "megakernel cornell bvh": ("minarg", "refine1", "tilecull", "dense"),
}
# Entries kept for the checks only (a redesigned kernel's first body and
# its counting entry): no main path may launch them.
CHECK_ONLY = ("minarg_simt", "minarg_count", "plucker_cand_simt",
              "plucker_cand_count", "march_simt", "march_count",
              "flat_march_simt", "flat_march_count", "lazy_march_simt",
              "lazy_march_count", "pair_visit_simt", "pair_visit_count",
              "pair_vpu_simt", "pair_vpu_count", "cluster_simt",
              "cluster_count", "anyhit_simt", "anyhit_count",
              "tilecull_simt", "tilecull_count", "group_simt", "group_count",
              "minarg_fused_simt", "minarg_fused_count", "mxu_simt",
              "mxu_count", "sphere_table_simt", "sphere_table_count")
PAIR_KERNELS = ("pair_cand", "pair_visit", "attr_fetch")
MODELS_DIR = os.path.join(HERE, "tests", "assets", "models")
REFERENCE_TRIS = 1838   # ground plane + the seven models (docs/BENCHMARKS.md)


class SmokeError(RuntimeError):
    pass


def need(cond, msg):
    if not cond:
        raise SmokeError(msg)


def import_port():
    sys.path.insert(0, HERE)
    try:
        import opencl_path_tracer_tpu_torch as pkg
    except ImportError as e:
        raise SmokeError(f"the port is not beside this script: {e}")
    need(os.path.abspath(pkg.__file__).startswith(HERE + os.sep),
         f"imported the port from {pkg.__file__}, not from this checkout")
    return pkg


def device_line(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    from opencl_path_tracer_tpu_torch.ops.kernels import _build
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True).stdout
    rel = re.search(r"release ([\d.]+)", nvcc)
    print(smi)
    print(f"device: {smi}; torch {torch.__version__} (CUDA "
          f"{torch.version.cuda}); nvcc {rel.group(1) if rel else '?'}")
    return smi


def build_line():
    from opencl_path_tracer_tpu_torch.ops.kernels import _build
    _build.build_info.clear()
    for name in _build.KERNELS:
        _build.library(name)
    info = _build.build_info
    parts = []
    for src, rep in info.get("ptxas", {}).items():
        regs = re.search(r"Used (\d+) registers", rep)
        smem = re.search(r"(\d+) bytes smem", rep)
        parts.append(f"{src} {regs.group(1) if regs else '?'} registers "
                     f"{smem.group(1) if smem else 0} B smem")
    print(f"build: {info['seconds']:.1f} s for {len(info['built'])} sources "
          f"(sm_90a, --fmad=false); " + "; ".join(parts))
    # Every entry function of the kernels redesigned in the last slices,
    # as ptxas reports it: registers, stack frame, spills, shared
    # memory.
    for src in ("march.cu", "pair_cand.cu", "plucker_cand.cu", "minarg.cu",
                "flat.cu", "lazy.cu", "pair_visit.cu", "pair_vpu.cu",
                "tilecull.cu", "group.cu", "minarg_fused.cu",
                "sphere_table.cu"):
        rep = info.get("ptxas", {}).get(src, "")
        for fn, body in re.findall(
                r"Compiling entry function '(\w+)'(.*?)(?=Compiling entry|\Z)",
                rep, re.S):
            frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores, (\d+) bytes spill loads", body)
            regs = re.search(r"Used (\d+) registers", body)
            smem = re.search(r"(\d+) bytes smem", body)
            print(f"ptxas {src} {fn}: {regs.group(1) if regs else '?'} "
                  f"registers, {smem.group(1) if smem else 0} B smem, "
                  + (f"{frame.group(1)} B stack frame, {frame.group(2)} B "
                     f"spill stores, {frame.group(3)} B spill loads"
                     if frame else "no frame line"))


def bounce_rays(torch, scene, cam, rays, isect):
    """The rays of the first bounce: shade the camera rays' hits once."""
    from opencl_path_tracer_tpu_torch.core.types import Rays
    from opencl_path_tracer_tpu_torch.models import megakernel
    from opencl_path_tracer_tpu_torch.ops import rng
    n = rays.count
    hit, mat = megakernel.fetch_material(scene.mats, isect, rays)
    u = rng.fast_uniforms(rng.key(7), 0, 1, n, 2, device=rays.device)
    inside = torch.zeros(n, dtype=torch.bool, device=rays.device)
    s = megakernel.shade(cam, mat, hit, rays.p, rays.d, inside, u[0], u[1],
                         hit.valid)
    return Rays(p=s["new_p"], d=s["new_d"])


def camera_rays(cam):
    """The 1080p camera rays of sample 0 in parity mode: gen_ray's two
    draws per pixel (prog.cl:384-389)."""
    from opencl_path_tracer_tpu_torch.ops import raygen, rng
    dev = cam.eye.device
    s1, r1 = rng.lehmer_step(rng.seed_pixel_streams(W * H, 1, device=dev))
    _, r2 = rng.lehmer_step(s1)
    return raygen.camera_rays(cam, raygen.pixel_ids(W, H, dev), r1, r2)


def check_kernels(torch, scenes, cam):
    """Each ray kernel against its plain version on the camera rays and the
    first-bounce rays of both scenes, with torch.equal."""
    from opencl_path_tracer_tpu_torch.ops.kernels import (
        intersect_kernel as k1, plucker_kernel as k2, sphere_kernel as k3)
    from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
    cam_rays = camera_rays(cam)
    inputs = {}
    errs = {name: 0.0 for name in KERNEL_META}

    def compare(name, outs, plain, where):
        torch.cuda.synchronize()
        for a, b in zip(outs, plain):
            errs[name] = max(errs[name], float((a - b).abs().max()))
        need(all(torch.equal(a, b) for a, b in zip(outs, plain)),
             f"{name} differs from its plain version on {where}")

    for sname, scene in scenes.items():
        pack = k1.build_tri_pack(scene.tris)
        table = (None if scene.spheres is None
                 else k3.build_sphere_table(scene.spheres))
        trig, tric, _ = k2.build_plucker_packs(scene.tris)
        isect = make_intersect_fn(scene, "auto")
        for rname, rays in (
                ("camera", cam_rays),
                ("bounce", bounce_rays(torch, scene, cam, cam_rays, isect))):
            where = f"{sname} {rname} rays"
            rays8 = k1.pack_rays(rays.p, rays.d).contiguous()
            t, g = k1.minarg(rays8, pack)
            compare("minarg", (t, g), k1.minarg_plain(rays8, pack), where)
            compare("refine1", k2.refine1(t, g, pack),
                    k2.refine1_plain(t, g, pack), where)
            dense = k1.dense(rays8, pack)
            compare("dense", dense, k1.dense_plain(rays8, pack), where)
            cand = k2.candidates(rays8, trig, tric, live=scene.tris.count)
            compare("plucker_cand", cand,
                    k2.candidates_plain(rays8, trig, tric), where)
            rows = k2.refine(rays8, cand, pack)
            compare("plucker_refine", rows,
                    k2.refine_plain(rays8, cand, pack), where)
            # K4's hit-row form, written into a column slice of K13b's
            # rows as the fused pipeline's exact slice does.
            hk, hp = rows.clone(), rows.clone()
            sl = slice(SLICE, 2 * SLICE)
            k1.dense(rays8[:, sl], pack, out=hk[:, sl])
            k1.dense_plain(rays8[:, sl], pack, out=hp[:, sl])
            compare("dense", (hk,), (hp,), where + " (hit rows, in place)")
            ok = rows[5] == 0
            dt = torch.where(dense[0] < k1.BIG, dense[0],
                             torch.full_like(dense[0], -1.0))
            need(torch.equal(rows[0][ok], dt[ok]),
                 f"refined Plucker hits differ from K4 on {where}")
            line = (f"{sname:16s} {rname:6s} rays {rays.count}: minarg "
                    f"({int((t < k1.BIG).sum())} hits), refine1, dense, "
                    f"plucker_cand, plucker_refine ({int((~ok).sum())} "
                    f"pending; t equal to dense elsewhere)")
            if table is not None:
                so = k3.spheres(rays8, table)
                compare("spheres", so, k3.spheres_plain(rays8, table), where)
                line += f", spheres ({int((so[0] > 0).sum())} hits)"
                inputs.setdefault("spheres", (rays8, table))
            print(line + " equal to their plain versions (torch.equal)")
            if rname == "camera":
                inputs.setdefault("minarg", (rays8, pack))
                inputs.setdefault("refine1", (t, g, pack))
    return inputs, errs, cam_rays


def check_fused(torch, scene, cam, errs):
    """K5 against its plain version on a 1080p packed state after two
    steps of the fused pipeline (real hit rows). Returns the inputs at
    which K4, K13a, K13b and K5 are timed: the pipeline's own shapes."""
    from opencl_path_tracer_tpu_torch.models import fused_step as fs
    from opencl_path_tracer_tpu_torch.models import pipeline
    from opencl_path_tracer_tpu_torch.ops import rng
    from opencl_path_tracer_tpu_torch.ops.kernels import (
        intersect_kernel as k1, plucker_kernel as k2)
    key = rng.key(1)
    (F, I, ctr), step, _ = pipeline.make_fast_pipeline(
        scene, cam, width=W, height=H, iterations=BOUNCES, key=key)
    for _ in range(2):
        F, I, ctr = step(F, I, ctr)
    hrows = step.hit_rows(F, ctr)
    table = fs.fused_table(cam, scene.mats, W, H)
    Fk, Ik = fs.fused_step(F, I, ctr, hrows, table, key, BOUNCES)
    Fp, Ip = fs.step_plain(F, I, ctr, hrows, table, key, BOUNCES)
    torch.cuda.synchronize()
    need(torch.equal(Ik, Ip), "fused_step integer rows differ from plain")
    nan = torch.isnan(Fk) & torch.isnan(Fp)
    need(torch.equal(torch.isnan(Fk), torch.isnan(Fp)),
         "fused_step NaNs differ from plain")
    a, b = torch.where(nan, 0.0, Fk), torch.where(nan, 0.0, Fp)
    err = (a - b).abs()
    errs["fused_step"] = float(err.max())
    atol = torch.full((fs.F_ROWS, 1), 1e-6, device=F.device)
    atol[fs._RAYP:fs._RAYP + 3] = 1e-3
    atol[fs._CUR:fs._CUR + 3] = 1e-3
    need(bool(((a == b) | (err <= atol + 1e-6 * b.abs())).all()),
         "fused_step float rows differ from plain beyond rtol 1e-6")
    bit = float((a.view(torch.int32) == b.view(torch.int32)).float().mean())
    print(f"fused_step on {F.shape[1]} lanes: integer rows equal, float rows "
          f"{bit:.7f} bit-equal, max abs err {errs['fused_step']:.3g} "
          f"(rtol 1e-6; atol 1e-6, 1e-3 for ray_p and cur_color)")
    rays8 = F[fs._RAYP:fs._RAYP + 8]
    need(F.shape[1] // step.n_slices == SLICE,
         f"the exact slice has {F.shape[1] // step.n_slices} lanes, not "
         f"{SLICE}")
    sl = slice(0, SLICE)
    trig, tric, _ = k2.build_plucker_packs(scene.tris)
    pack = k1.build_tri_pack(scene.tris)
    cand = k2.candidates(rays8, trig, tric, live=scene.tris.count)
    h = hrows.clone()
    torch.cuda.synchronize()
    return {"dense": (rays8[:, sl], pack, h[:, sl]),
            "plucker_cand": (rays8, trig, tric, scene.tris.count),
            "plucker_refine": (rays8, cand, pack),
            "fused_step": (F, I, ctr, hrows, table, key)}


def nee_shadow_rays(torch, scene, cam, rays, isect):
    """The shadow rays (and their rmax = dist (1 - 1e-3)) that NEE traces
    at the first hits of `rays`, one per lane (`runtime.cull_ab`'s
    capture from `ops.nee.direct_light` itself)."""
    from opencl_path_tracer_tpu_torch.runtime.cull_ab import shadow_rays
    return shadow_rays(scene, cam, rays, isect)


def check_slice3(torch, scenes, cam, cam_rays, errs):
    """K7 on the first-bounce NEE shadow rays of 1080p cornell (against its
    plain version, and equal to (K4 t valid and t < rmax)); K6 on the
    camera and first-bounce rays of cornell (against its plain version,
    and its t equal to K1's); K3b on the camera rays of the many-light
    scene. Returns the inputs at which they are timed."""
    from opencl_path_tracer_tpu_torch.ops.kernels import (
        intersect_kernel as k1, sphere_kernel as k3, tilecull_kernel as tk)
    from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
    scene = scenes["cornell"]
    eye = tuple(float(v) for v in cam.eye.cpu())
    isect = make_intersect_fn(scene, "auto")
    pack, groups, _ = tk.grouped_pack(scene.tris, 128)
    sub = tk.anyhit_sub_boxes(pack, groups)
    shadow, rmax = nee_shadow_rays(torch, scene, cam, cam_rays, isect)
    s8 = k1.pack_rays(shadow.p, shadow.d).contiguous()
    occ = tk.anyhit(s8, rmax, pack, groups, sub)
    plain = tk.anyhit_plain(s8, rmax, pack, groups, ANYHIT_PLAIN_CHUNK)
    torch.cuda.synchronize()
    errs["anyhit"] = float((occ != plain).any())
    need(torch.equal(occ, plain), "anyhit differs from its plain version on "
         "the cornell first-bounce shadow rays")
    t4 = k1.dense(s8, k1.build_tri_pack(scene.tris))[0]
    need(torch.equal(occ, (t4 < k1.BIG) & (t4 < rmax)),
         "anyhit differs from (K4 t valid and t < rmax)")
    print(f"anyhit on {s8.shape[1]} cornell first-bounce NEE shadow rays: "
          f"{int(occ.sum())} occluded; equal to its plain version and to "
          f"(K4 t valid and t < rmax) (torch.equal)")
    inputs = {"anyhit": (s8, rmax, pack, groups, sub)}
    cpack, cgroups, _ = tk.grouped_pack(scene.tris, 128, origin=eye)
    csub = tk.anyhit_sub_boxes(cpack, cgroups)
    minarg_pack = k1.build_tri_pack(scene.tris)
    for rname, rays in (("camera", cam_rays),
                        ("bounce", bounce_rays(torch, scene, cam, cam_rays,
                                               isect))):
        r8 = k1.pack_rays(rays.p, rays.d).contiguous()
        t, g = tk.tilecull(r8, cpack, cgroups, csub)
        (tp, gp), plain_ms = timed(torch, lambda: tk.tilecull_plain(
            r8, cpack, cgroups))
        errs["tilecull"] = max(errs["tilecull"], float((t - tp).abs().max()),
                               float((g - gp).abs().max()))
        need(torch.equal(t, tp) and torch.equal(g, gp),
             f"tilecull differs from its plain version on cornell {rname} "
             "rays")
        need(torch.equal(t, k1.minarg(r8, minarg_pack)[0]),
             f"tilecull t differs from minarg t on cornell {rname} rays")
        print(f"tilecull on {r8.shape[1]} cornell {rname} rays: "
              f"{int((t < k1.BIG).sum())} hits; equal to its plain version, "
              "t equal to minarg's (torch.equal)")
        inputs.setdefault("tilecull", (r8, cpack, cgroups, csub, plain_ms))
        if rname == "bounce":
            inputs["bounce rays"] = (r8, cpack, cgroups, csub, plain_ms,
                                     minarg_pack)
    many = scenes["many-lights"]
    table = k3.build_sphere_table(many.spheres)
    r8 = k1.pack_rays(cam_rays.p, cam_rays.d).contiguous()
    so = k3.sphere_table(r8, table, k3.sphere_groups(table))
    sp = k3.sphere_table_plain(r8, table)
    torch.cuda.synchronize()
    errs["sphere_table"] = max(float((a - b).abs().max())
                               for a, b in zip(so, sp))
    need(all(torch.equal(a, b) for a, b in zip(so, sp)),
         "sphere_table differs from its plain version on many-lights camera "
         "rays")
    print(f"sphere_table on {r8.shape[1]} many-lights camera rays "
          f"({table.shape[0]} spheres): {int((so[0] > 0).sum())} hits; equal "
          "to its plain version (torch.equal)")
    return inputs


def strip_hits(torch, scene, pack, s8, rmax, occ, t4, g4):
    """Where K7's flag differs from (K4 t valid and t < rmax): each such ray
    must be K7-unoccluded with its K4 hit on a zero-area triangle (float64
    area 0), and K4 over the pack with those rows zeroed (never hit) must
    find nothing below rmax. Such a triangle's face normal is the residue
    of a fused cross product, as in the JAX package, which makes its
    exact test accept a thin infinite strip outside its group's box, and
    the group culling of K6 and K7 (as on the TPU) never looks there.
    Returns the number of such rays."""
    from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
    diff = torch.nonzero(occ != ((t4 < k1.BIG) & (t4 < rmax))).flatten()
    if diff.numel() == 0:
        return 0
    r1, r2, r3 = (getattr(scene.tris, f).double().cpu()
                  for f in ("r1", "r2", "r3"))
    zero = torch.linalg.cross(r2 - r1, r3 - r1).norm(dim=1) == 0.0
    need(not bool(occ[diff].any())
         and bool(zero[g4[diff].long().cpu()].all()),
         "anyhit differs from (K4 t valid and t < rmax) on reference NEE "
         "shadow rays whose K4 hit is not on a zero-area triangle")
    solid = pack.clone()
    solid[zero.to(pack.device)] = 0.0
    t4s = k1.dense(s8[:, diff].contiguous(), solid)[0]
    torch.cuda.synchronize()
    need(not bool(((t4s < k1.BIG) & (t4s < rmax[diff])).any()),
         "anyhit misses a hit of nonzero area below rmax on reference NEE "
         "shadow rays")
    return int(diff.numel())


def check_smooth(torch, scenes, errs):
    """K8 against its plain version on the camera and first-bounce rays of
    the smooth reference scene (its own camera) and of the smooth-sphere
    Cornell box at 1080p. On the reference scene, whose ground plane
    spans +-10,000 next to unit-scale models, also K6's t against K1's
    and K7's flags on its NEE shadow rays against (K4 t valid and
    t < rmax), but on the rays `strip_hits` explains. Returns the inputs
    at which K8 is timed and the reference's rays for K1, K6 and K7."""
    from opencl_path_tracer_tpu_torch.ops.kernels import (
        intersect_kernel as k1, shading_kernel as k8, tilecull_kernel as tk)
    from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
    from opencl_path_tracer_tpu_torch.scene import library
    need(scenes["reference"].num_triangles == REFERENCE_TRIS,
         f"the reference scene has {scenes['reference'].num_triangles} "
         f"triangles, not {REFERENCE_TRIS}: a model of {MODELS_DIR} is "
         "missing")
    inputs = {}
    for sname, cam in (
            ("reference", library.reference_camera(W, H, device="cuda")),
            ("cornell-smooth", library.cornell_camera(W, H, device="cuda"))):
        scene = scenes[sname]
        isect = make_intersect_fn(scene, "auto", smooth=True)
        pack = k1.build_tri_pack(scene.tris)
        spack = k8.build_shading_pack(scene.attribs)
        cam_rays = camera_rays(cam)
        for rname, rays in (
                ("camera", cam_rays),
                ("bounce", bounce_rays(torch, scene, cam, cam_rays, isect))):
            r8 = k1.pack_rays(rays.p, rays.d).contiguous()
            t, g = k1.minarg(r8, pack)
            outs = k8.smooth_refine(r8, t, g, pack, spack)
            plain = k8.smooth_refine_plain(r8, t, g, pack, spack)
            torch.cuda.synchronize()
            errs["smooth_refine"] = max(
                [errs["smooth_refine"]]
                + [float((a - b).abs().max()) for a, b in zip(outs, plain)])
            need(all(torch.equal(a, b) for a, b in zip(outs, plain)),
                 f"smooth_refine differs from its plain version on {sname} "
                 f"{rname} rays")
            hit = outs[0] > 0
            smooth = hit & (outs[1] != pack[g.long(), 0])
            print(f"smooth_refine on {r8.shape[1]} {sname} {rname} rays: "
                  f"{int(hit.sum())} hits, {int(smooth.sum())} with an "
                  "interpolated normal; equal to its plain version "
                  "(torch.equal)")
            inputs.setdefault("smooth_refine", (r8, t, g, pack, spack))
            if sname == "reference":
                inputs[f"reference {rname}"] = r8
        if sname != "reference":
            continue
        eye = tuple(float(v) for v in cam.eye.cpu())
        cpack, cgroups, _ = tk.grouped_pack(scene.tris, 128, origin=eye)
        csub = tk.anyhit_sub_boxes(cpack, cgroups)
        for rname in ("camera", "bounce"):
            r8 = inputs[f"reference {rname}"]
            t6, _ = tk.tilecull(r8, cpack, cgroups, csub)
            torch.cuda.synchronize()
            need(torch.equal(t6, k1.minarg(r8, pack)[0]),
                 f"tilecull t differs from minarg t on reference {rname} "
                 "rays")
        shadow, rmax = nee_shadow_rays(torch, scene, cam, cam_rays, isect)
        s8 = k1.pack_rays(shadow.p, shadow.d).contiguous()
        gpack, groups, _ = tk.grouped_pack(scene.tris, 128)
        gsub = tk.anyhit_sub_boxes(gpack, groups)
        occ = tk.anyhit(s8, rmax, gpack, groups, gsub)
        t4, g4 = k1.dense(s8, pack)[:2]
        torch.cuda.synchronize()
        strip = strip_hits(torch, scene, pack, s8, rmax, occ, t4, g4)
        ext = (cgroups[:, 3:6] - cgroups[:, 0:3]).amax(dim=1)
        wide = ext > 1000.0
        need(not bool(wide.all()), "every tilecull group box on reference is "
             "as wide as the ground plane")
        print(f"reference: tilecull t equal to minarg t on camera and bounce "
              f"rays; anyhit on {s8.shape[1]} NEE shadow rays "
              f"({int(occ.sum())} occluded) equal to (K4 t valid and t < "
              f"rmax) but on {strip} rays whose K4 hit is on a zero-area "
              f"triangle's strip, outside its group's box, and that no "
              f"other triangle occludes; {int(wide.sum())} of "
              f"{cgroups.shape[0]} group boxes wider than 1,000 (the "
              f"ground plane spans 20,000; the widest other box "
              f"{float(ext[~wide].max()):.1f})")
        inputs["reference kernels"] = (cpack, cgroups, csub, s8, rmax,
                                       gpack, groups, gsub, pack)
    return inputs


def schedule_counts(run):
    """run() with the recorder on and its device-valued counts kept (the
    intersect schedules' counters, `utils.profiling`); the counters."""
    from opencl_path_tracer_tpu_torch.utils import profiling
    profiling.reset()
    with profiling.tracing(device_counts=True):
        run()
    return profiling.counters()


def pair_stats_line(name, c):
    """One line of the pair intersector's schedule over a run's calls
    (the recorder's counters c): rays resolved after round 1, rays
    escalated per tier (the unresolved rays each escalation took), the
    dense tail's iterations and rays, and the pending rays."""
    rays = c["isect.rays"]
    tiers = {k[len("isect.escalated."):].replace(".", " "): n
             for k, n in c.items() if k.startswith("isect.escalated.")}
    print(f"{name}: {c['isect.calls']} pair-intersector calls, {rays} "
          f"rays; round 1 resolved {c['isect.round1_resolved'] / rays:.4f}; "
          f"escalated {tiers}; tail {c['isect.tail_iterations']} iterations "
          f"over {c['isect.tail_rays']} rays; pending "
          f"{c['isect.pending'] / rays:.5f}")


def check_pairs(torch, scenes, cam, errs):
    """K9 (l = 2 on the 1080p camera rays, l = 6, 14 and 48 on the
    first 65,536), K10 on round 1's pairs and K11 on the final winners of the
    stress scene, each against its plain version (torch.equal); the pair
    intersector's t against K4's over the whole scene on the camera and
    first-bounce rays. Returns the inputs at which K9-K11 are timed."""
    from opencl_path_tracer_tpu_torch.ops.kernels import (
        intersect_kernel as k1, pair_mxu as pm, sorted_intersect as si)
    from opencl_path_tracer_tpu_torch.ops.kernels.march_kernel import (
        build_march_scene)
    scene = scenes["stress"]
    need(scene.num_triangles == STRESS_TRIS,
         f"the stress scene has {scene.num_triangles} triangles, not "
         f"{STRESS_TRIS}")
    cs, trp = si.PAIR_TPU_WINNER["cluster_size"], si.PAIR_TPU_WINNER["trp"]
    big, rest = si.split_by_size(scene.tris)
    ms, rt, c = build_march_scene(rest, cs)
    boxes = torch.cat([ms.boxes_lo, ms.boxes_hi,
                       torch.zeros((c, 2), device="cuda"),
                       pm.build_dops(rt, cs, c)], 1)
    boxes_r = torch.zeros((-(-c // 128) * 128, 16), device="cuda")
    boxes_r[:c] = boxes
    cam_rays = camera_rays(cam)
    r8 = k1.pack_rays(cam_rays.p, cam_rays.d).contiguous()

    def compare(name, outs, plain, where):
        torch.cuda.synchronize()
        for a, b in zip(outs, plain):
            errs[name] = max(errs[name], float(
                (a.double() - b.double()).abs().max()))
        need(all(torch.equal(a, b) for a, b in zip(outs, plain)),
             f"{name} differs from its plain version on {where}")

    ids = si.run_candidates(r8, boxes_r, 2, c)
    compare("pair_cand", ids, si.candidates_plain(r8, boxes_r, 2, c),
            "stress camera rays (l = 2)")
    sub = r8[:, :65536].contiguous()
    for l in (6, 14, 48):
        compare("pair_cand", si.run_candidates(sub, boxes_r, l, c),
                si.candidates_plain(sub, boxes_r, l, c),
                f"stress camera rays (l = {l})")
    keys_s, r8p, _ = pm.sort_pairs([r8[k] for k in range(6)], ids[0], c, trp)
    tg = pm.pair_visits(keys_s, r8p, ms.trig, ms.tric, cs, trp, c)
    compare("pair_visit", tg,
            pm.pair_visits_plain(keys_s, r8p, ms.trig, ms.tric, cs, trp, c),
            "round 1's pairs of the stress camera rays")
    nv = int((pm.build_visits(keys_s, trp, c)[1] >= 0).sum())
    print(f"stress: {scene.num_triangles} triangles, {big.count} split out, "
          f"{c} clusters of {cs}; pair_cand on {r8.shape[1]} camera rays, "
          f"pair_visit on {keys_s.shape[0]} pairs ({nv} visits, "
          f"{int((tg[0] < k1.BIG).sum())} hits, {int((tg[1] % 2).sum())} "
          "pending) equal to their plain versions (torch.equal)")
    # The intersector as the engine builds it; K11's input captured from
    # its final fetch.
    isect = si.make_pair_intersect(scene.tris, **si.PAIR_TPU_WINNER)
    real_fetch, got = pm.fetch_attrs, {}

    def capture(g, tric):
        got["g"], got["tric"] = g, tric
        return real_fetch(g, tric)

    pack = k1.build_tri_pack(scene.tris)
    pm.fetch_attrs = capture

    def check_both():
        got["bounce"] = bounce_rays(torch, scene, cam, cam_rays, isect)
        for rname, rays in (("camera", cam_rays), ("bounce", got["bounce"])):
            h = isect(rays)
            t4 = k1.dense(k1.pack_rays(rays.p, rays.d).contiguous(), pack)[0]
            torch.cuda.synchronize()
            need(torch.equal(h.t, torch.where(t4 < k1.BIG, t4,
                                              torch.full_like(t4, -1.0))),
                 f"the pair intersector's t differs from K4's on stress "
                 f"{rname} rays")
            if rname == "camera":
                got["winners"] = got["g"], got["tric"]

    try:
        stats = schedule_counts(check_both)
    finally:
        pm.fetch_attrs = real_fetch
    g, tric = got["winners"]
    compare("attr_fetch", pm.fetch_attrs(g, tric),
            pm.fetch_attrs_plain(g, tric), "the stress camera rays' winners")
    print(f"stress: pair intersector t equal to K4's on camera and bounce "
          f"rays; attr_fetch on {g.shape[0]} winners "
          f"({int((g >= 0).sum())} from the pairs rounds) equal to its plain "
          "version (torch.equal)")
    pair_stats_line("stress camera, bounce rays", stats)
    return {"pair_cand": (r8, boxes_r, c), "pair_visit": (keys_s, r8p, ms,
                                                           cs, trp, c, nv),
            "attr_fetch": (g, tric), "stress bounce rays": got["bounce"]}


def exact_vs_k4(torch, name, h, t4, where):
    """An accel's hits against K4's t over the whole scene: hit or miss
    equal; t within the JAX tests' rtol 2e-5 and atol 1e-3
    (tests/test_sorted_intersect.py::_check). Returns the count of lanes
    whose t differs at all."""
    from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
    torch.cuda.synchronize()
    hit = t4 < k1.BIG
    need(torch.equal(h.t > 0, hit),
         f"{name}: hit or miss differs from K4's on {where}")
    diff = hit & (h.t != t4)
    n = int(diff.sum())
    if n:
        err = (h.t - t4).abs()[diff]
        need(bool((err <= 1e-3 + 2e-5 * t4.abs()[diff]).all()),
             f"{name}: t differs from K4's beyond rtol 2e-5 on {where}")
    return n


def check_slice6(torch, scenes, cam, cam_rays, errs):
    """K12 on the round-1 pairs of the 1080p stress camera rays at the
    'pair' defaults (with K9 on the 8-column table at l = 8, 16 and 48), K17
    on the stress camera rays and the cornell first-bounce rays (early
    exit off and on), K16 on the reference camera and first-bounce rays,
    each against its plain version (torch.equal); the 'pair', 'cluster'
    and 'group' accels' hits against K4's. Returns the inputs at which
    K12, K17 and K16 are timed, with their plain versions' times (ms) from
    these checks."""
    from opencl_path_tracer_tpu_torch.ops.kernels import (
        cluster_kernel as ck, intersect_kernel as k1, pair_mxu as pm,
        sorted_intersect as si)
    from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
    from opencl_path_tracer_tpu_torch.scene import library

    def compare(name, outs, plain, where):
        torch.cuda.synchronize()
        for a, b in zip(outs, plain):
            errs[name] = max(errs[name], float(
                (a.double() - b.double()).abs().max()))
        need(all(torch.equal(a, b) for a, b in zip(outs, plain)),
             f"{name} differs from its plain version on {where}")

    inputs = {}
    # K12 and K9 at the 'pair' defaults.
    stress = scenes["stress"]
    _, rest = si.split_by_size(stress.tris)
    cs = si._auto_cluster_size(rest.count, 512)
    cscene, c, k = ck.build_clusters(rest, cs)
    rows = torch.cat([cscene.rows(), torch.zeros((k, 24), device="cuda")])
    boxes_r = torch.zeros((-(-c // 128) * 128, 8), device="cuda")
    boxes_r[:c] = cscene.boxes
    r8 = k1.pack_rays(cam_rays.p, cam_rays.d).contiguous()
    ids = si.run_candidates(r8, boxes_r, 8, c)
    compare("pair_cand", ids, si.candidates_plain(r8, boxes_r, 8, c),
            "stress camera rays (8-column table, l = 8)")
    sub = r8[:, :65536].contiguous()
    for l in (16, 48):
        compare("pair_cand", si.run_candidates(sub, boxes_r, l, c),
                si.candidates_plain(sub, boxes_r, l, c),
                f"stress camera rays (8-column table, l = {l})")
    keys_s, r8p, _ = pm.sort_pairs([r8[j] for j in range(6)], ids[0], c,
                                   1024)
    n_real = int((keys_s < c).sum())
    n = (keys_s.shape[0] if n_real * k <= K12_PLAIN_CELLS
         else min(K12_PREFIX, keys_s.shape[0]))
    keys_n, r8p_n = keys_s[:n].contiguous(), r8p[:, :n].contiguous()
    sub = si.pair_sub_boxes(rows, k)
    out = si.run_pairs(keys_n, r8p_n, rows, k, sub)
    plain, plain_ms = timed(torch, lambda: si.pairs_plain(keys_n, r8p_n,
                                                          rows, k))
    compare("pair_vpu", out, plain, "round 1's pairs of the stress camera "
            "rays")
    print(f"stress 'pair': {c} clusters of {k}; pair_cand (8-column table, "
          f"l = 8 on {r8.shape[1]} camera rays, 48 on 65,536) and pair_vpu "
          f"on {n} of round 1's {keys_s.shape[0]} sorted pairs ({n_real} "
          f"not dummy, {int((out[0] < k1.BIG).sum())} hits) equal to their "
          "plain versions (torch.equal)")
    inputs["pair_vpu"] = (keys_n, r8p_n, rows, k, plain_ms)
    inputs["pair_vpu scene"] = (sub, boxes_r, c)
    pack = k1.build_tri_pack(stress.tris)
    isect = make_intersect_fn(stress, "pair")
    for rname, rays in (("camera", cam_rays),
                        ("bounce", bounce_rays(torch, stress, cam, cam_rays,
                                               isect))):
        t4 = k1.dense(k1.pack_rays(rays.p, rays.d).contiguous(), pack)[0]
        nd = exact_vs_k4(torch, "pair", isect(rays), t4, f"stress {rname}")
        print(f"stress 'pair' on {rname} rays: hit or miss equal to K4's, "
              f"{nd} lanes with another t (rtol 2e-5)")
    # K17.
    c17s, c17, k17 = ck.build_clusters(stress.tris, 128)
    rows17 = c17s.rows()
    cornell = scenes["cornell"]
    c7s, _, k7 = ck.build_clusters(cornell.tris, 128)
    for sname, csc, kk, rays in (
            ("stress camera", c17s, k17, cam_rays),
            ("cornell first-bounce", c7s, k7,
             bounce_rays(torch, cornell, cam, cam_rays,
                         make_intersect_fn(cornell, "auto")))):
        rr8 = ck.pack_rays_rows(rays.p, rays.d, -(-rays.count // 256) * 256)
        ids17, cnt, ent = ck._tile_cluster_lists(rr8, csc.boxes, 256)
        crows = csc.rows()
        csub = ck.cluster_sub_boxes(crows, kk)
        for ee in (False, True):
            o = ck.run_cluster(rr8, cnt, ids17, ent, crows, kk, 256, ee,
                               csub)
            plain, ms = timed(torch, lambda: ck.cluster_plain(
                rr8, cnt, ids17, ent, crows, kk, 256, ee))
            compare("cluster", o, plain, f"{sname} rays (early_exit {ee})")
            if sname == "stress camera" and not ee:
                inputs["cluster"] = (rr8, cnt, ids17, ent, crows, kk, csub,
                                     ms)
                inputs["cluster boxes"] = csc.boxes
        print(f"cluster on {rays.count} {sname} rays ({csc.boxes.shape[0]} "
              f"clusters of {kk}; {float(cnt.float().mean()):.1f} listed per "
              f"tile of 256): {int((o[0] < k1.BIG).sum())} hits; equal to "
              "its plain version with early_exit off and on (torch.equal)")
    isect = make_intersect_fn(stress, "cluster")
    for rname, rays in (("camera", cam_rays),
                        ("bounce", bounce_rays(torch, stress, cam, cam_rays,
                                               isect))):
        t4 = k1.dense(k1.pack_rays(rays.p, rays.d).contiguous(), pack)[0]
        nd = exact_vs_k4(torch, "cluster", isect(rays), t4,
                         f"stress {rname}")
        print(f"stress 'cluster' on {rname} rays: hit or miss equal to K4's, "
              f"{nd} lanes with another t (rtol 2e-5)")
    # K16.
    ref = scenes["reference"]
    rcam = library.reference_camera(W, H, device="cuda")
    gscene, c16, k16 = ck.build_clusters(ref.tris, 128, split_large=True)
    grows = gscene.rows()
    gsub = ck.cluster_sub_boxes(grows, k16)
    rpack = k1.build_tri_pack(ref.tris)
    isect = make_intersect_fn(ref, "group")
    rcam_rays = camera_rays(rcam)
    for rname, rays in (("camera", rcam_rays),
                        ("bounce", bounce_rays(torch, ref, rcam, rcam_rays,
                                               isect))):
        _, union, g8 = si.group_inputs(rays, gscene.boxes, 2048)
        o = si.run_group(union, g8, grows, k16, 2048, gsub)
        plain, ms = timed(torch, lambda: si.group_plain(union, g8, grows,
                                                        k16, 2048))
        compare("group", o, plain, f"reference {rname} rays")
        inputs[f"group {rname}"] = (union, g8, grows, k16, gsub, ms)
        t4 = k1.dense(k1.pack_rays(rays.p, rays.d).contiguous(), rpack)[0]
        nd = exact_vs_k4(torch, "group", isect(rays), t4,
                         f"reference {rname}")
        bits = sum(int(((union >> b) & 1).sum()) for b in range(c16))
        print(f"group on {rays.count} reference {rname} rays ({c16} "
              f"clusters; {bits / union.shape[0]:.2f} in a block's union): "
              f"{int((o[0] < k1.BIG).sum())} hits, equal to its plain "
              f"version (torch.equal); 'group' hit or miss equal to K4's, "
              f"{nd} lanes with another t (rtol 2e-5)")
    return inputs


def march_round1(torch, scene, rays, cs, tr, K):
    """'march' round 1's K18 inputs for rays: the scene's march packs, the
    lanes in sort order, their features and block lists."""
    from opencl_path_tracer_tpu_torch.ops.kernels import (
        intersect_kernel as k1, march_kernel as mk)
    from opencl_path_tracer_tpu_torch.ops.kernels.plucker_kernel import (
        plucker_feat)
    ms, rt, c = mk.build_march_scene(scene.tris, cs)
    r8 = k1.pack_rays(rays.p, rays.d, -(-rays.count // tr) * tr)
    order = torch.sort(mk.lane_key(r8[0:3], r8[3:6], ms), stable=True).indices
    r8s = r8[:, order].contiguous()
    feat = plucker_feat(r8s)
    ent, need = mk._slab_entries(r8s, ms, torch.full(
        (r8s.shape[1],), k1.BIG, device=r8s.device))
    return ms, rt, c, r8s, feat, ent, mk._block_lists(ent, need, tr, K)


def hits_vs_k4(torch, name, h, rays, pack):
    """An accel's hits against K4's over the reordered triangles: t, mati
    and, on hits, the normal bit-equal (the JAX contract,
    march_kernel.py:493-496 and flat_march.py:327). Returns the hits."""
    from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
    t4, _, nx, ny, nz, m = k1.dense(
        k1.pack_rays(rays.p, rays.d).contiguous(), pack)
    torch.cuda.synchronize()
    hit = t4 < k1.BIG
    need(torch.equal(h.t, torch.where(hit, t4, torch.full_like(t4, -1.0))),
         f"{name}: t differs from K4's")
    need(torch.equal(h.mati, torch.where(hit, m, torch.zeros_like(m)).to(
        torch.int32)), f"{name}: mati differs from K4's")
    need(all(torch.equal(a[hit], b[hit]) for a, b in zip(h.n, (nx, ny, nz))),
         f"{name}: the hit normal differs from K4's")
    return int(hit.sum())


def check_slice7(torch, scenes, cam, cam_rays, errs):
    """K18 (after its K18m copy) on 'march' round 1 of the stress camera
    rays (cs = tr = 512, K1 = 24), K19 on 'flat' round 1 (cs = tr = 256,
    K0 = 4), K20 on the second step of the lazy pipeline (cs 512, tr 256,
    K 4), each against its plain version on the first PLAIN_BLOCKS blocks
    (K18m on the whole input), torch.equal; the 'march' and 'flat' hits
    equal to K4's over the reordered triangles on the camera and
    first-bounce rays; the lazy lanes certified with a hit hold K4's hit.
    Returns the inputs at which K18, K18m, K19 and K20 are timed, with
    their plain versions' times (ms) from these checks, and the K19 and
    K20 launches of these runs (for check_slice12)."""
    from opencl_path_tracer_tpu_torch.models import lazy
    from opencl_path_tracer_tpu_torch.ops import rng
    from opencl_path_tracer_tpu_torch.ops.kernels import (
        flat_march as fm, intersect_kernel as k1, lazy_march as lm,
        march_kernel as mk)
    stress = scenes["stress"]

    def compare(name, outs, plain, where):
        torch.cuda.synchronize()
        for a, b in zip(outs, plain):
            errs[name] = max(errs[name], float(
                (a.double() - b.double()).abs().max()) if a.numel() else 0.0)
        need(all(torch.equal(a, b) for a, b in zip(outs, plain)),
             f"{name} differs from its plain version on {where}")

    inputs = {}
    # K18m and K18: 'march' round 1.
    cs, tr, K = 512, 512, 24
    ms, rt, c, r8s, feat, _, clist = march_round1(torch, stress, cam_rays, cs,
                                                  tr, K)
    copies = mk.materialize(clist, r8s, feat)
    compare("materialize", copies, mk.materialize_plain(clist, r8s, feat),
            "'march' round 1's operands")
    out = mk.run_march(*copies, ms, cs, K, tr)
    p = PLAIN_BLOCKS
    plain, plain_ms = timed(torch, lambda: mk.march_plain(
        clist[:p * K], r8s[:, :p * tr].contiguous(), feat[:, :p * tr].contiguous(),
        ms, cs, K, tr))
    compare("march", (out[:, :p * tr],), (plain,),
            f"'march' round 1 of the stress camera rays (first {p} blocks)")
    nv = int((clist >= 0).sum())
    print(f"stress 'march': {c} clusters of {cs}; materialize on round 1's "
          f"operands equal to its plain version; march on "
          f"{r8s.shape[1]} camera lanes ({nv} visits of {clist.numel()}, "
          f"{int((out[0] < k1.BIG).sum())} hits, {int(out[6].sum())} "
          f"pending) equal to its plain version on the first {p} blocks "
          "(torch.equal)")
    inputs["march"] = (clist, r8s, feat, ms, cs, K, tr, nv, plain_ms)
    inputs["materialize"] = (clist, r8s, feat)
    # K19: 'flat' round 1 (K18 round 0 at K0 = 4).
    cs, tr, K0 = 256, 256, 4
    fs, frt, fc, f8, ffeat, ent, clist0 = march_round1(torch, stress,
                                                       cam_rays, cs, tr, K0)
    rows0 = mk.run_march(clist0, f8, ffeat, fs, cs, K0, tr)
    b = f8.shape[1] // tr
    bu = (mk._need(ent, rows0[0]).view(fc, b, tr).any(dim=2)
          & ~mk._visited_from(clist0, fc, K0))
    del ent
    vcap = -(-max(f8.shape[1] // 4, 4096) // 256) * 256
    vb, vc, _, ovf = fm._build_visit_list(bu, vcap)
    out = fm.run_flat(vb, vc, f8, ffeat, rows0, fs, cs, tr)
    m = int((vb < p).sum())
    plain, fplain_ms = timed(torch, lambda: fm.flat_plain(
        vb[:m], vc[:m], f8[:, :p * tr].contiguous(),
        ffeat[:, :p * tr].contiguous(), rows0[:, :p * tr].contiguous(), fs,
        cs, tr))
    compare("flat_march", (out[:, :p * tr],), (plain,),
            f"'flat' round 1 of the stress camera rays (first {p} blocks)")
    fv = int((vc >= 0).sum())
    print(f"stress 'flat': {fc} clusters of {cs}; flat_march on "
          f"{f8.shape[1]} camera lanes ({fv} visits in a list of {vcap}, "
          f"{int(ovf.sum())} blocks over it, "
          f"{int((out[0] < rows0[0]).sum())} lanes closer than round 0) "
          f"equal to its plain version on the first {p} blocks (torch.equal)")
    inputs["flat_march"] = (vb, vc, f8, ffeat, rows0, fs, cs, tr, fv,
                            fplain_ms)
    # The hits of both accels against K4 over their reordered triangles;
    # the K19 launches of 'flat' captured for check_slice12.
    real_flat, flats = fm.run_flat, []

    def capture_flat(*a):
        out = real_flat(*a)
        flats.append((a, out))
        return out

    fm.run_flat = capture_flat
    try:
        for name, (isect, rt_) in (
                ("march", mk.make_march_intersect(stress.tris)),
                ("flat", fm.make_flat_march_intersect(stress.tris))):
            pack = k1.build_tri_pack(rt_)
            for rname, rays in (("camera", cam_rays),
                                ("bounce", bounce_rays(torch, stress, cam,
                                                       cam_rays, isect))):
                nh = hits_vs_k4(torch, f"'{name}' on stress {rname} rays",
                                isect(rays), rays, pack)
                print(f"stress '{name}' on {rname} rays: t, mati and the "
                      f"hit normals equal to K4's over the reordered "
                      f"triangles ({nh} hits)")
    finally:
        fm.run_flat = real_flat
    # Made while shading the camera hits, then on the camera rays and on
    # the first-bounce rays.
    need(len(flats) == 3, f"'flat' made {len(flats)} K19 launches in its "
         "checks, not 3")
    inputs["flat launches"] = flats[1:]
    # K20: the second step of the lazy pipeline, its call captured.
    step, init, lrt = lazy.make_lazy_pipeline(stress.tris, cs=512, tr=256,
                                              K=4, tail=4096)
    lpack = k1.build_tri_pack(lrt)
    real_run, real_shade, got = lazy.run_lazy_march, lazy.shade, {}
    lazies = []

    def capture_run(*a):
        got["args"] = a
        out = real_run(*a)
        # For check_slice12 (the step then writes the dense net's hits
        # into these outputs).
        lazies.append((a, tuple(x.clone() for x in out)))
        return out

    def capture_shade(cam_, mat, hit, ray_p, ray_d, inside, r1, r2, has_hit):
        got["shade"] = (hit, ray_p, ray_d, has_hit)
        return real_shade(cam_, mat, hit, ray_p, ray_d, inside, r1, r2,
                          has_hit)

    key = rng.key(1)
    st = init(cam, W * H, mode="fast", key=key)
    lazy.run_lazy_march, lazy.shade = capture_run, capture_shade
    try:
        certified = []
        for _ in range(2):
            c0 = int(st.completions)
            st = step(cam, stress.mats, st, iterations=BOUNCES, mode="fast",
                      key=key)
            certified.append(int(st.completions) - c0)
            hit, ray_p, ray_d, has_hit = got["shade"]
            sel = torch.nonzero(has_hit).flatten()
            sub = type(cam_rays)(p=tuple(x[sel] for x in ray_p),
                                 d=tuple(x[sel] for x in ray_d))
            sub_hits = type(hit)(t=hit.t[sel], p=tuple(x[sel] for x in hit.p),
                                 n=tuple(x[sel] for x in hit.n),
                                 mati=hit.mati[sel])
            hits_vs_k4(torch, "lazy certified lanes", sub_hits, sub, lpack)
    finally:
        lazy.run_lazy_march, lazy.shade = real_run, real_shade
    clist_l, l8, lfeat, rows_in, vis, lsc, lcs, lk, ltr = got["args"]
    o20, v20 = lm.run_lazy_march(*got["args"])
    pl = p * ltr
    plain, lplain_ms = timed(torch, lambda: lm.lazy_plain(
        clist_l[:p * lk], l8[:, :pl].contiguous(), lfeat[:, :pl].contiguous(),
        rows_in[:, :pl].contiguous(), vis[:, :pl].contiguous(), lsc, lcs, lk,
        ltr))
    compare("lazy_march", (o20[:, :pl], v20[:, :pl]), plain,
            f"the lazy pipeline's second step (first {p} blocks)")
    lv = int((clist_l >= 0).sum())
    print(f"lazy stress: {W * H} lanes certified {certified} in its first "
          f"two steps, each certified hit equal to K4's; lazy_march on the "
          f"second step ({lv} visits, {int(o20[6].sum())} pending, "
          f"{vis.shape[0]} mask words) equal to its plain version on the "
          f"first {p} blocks (torch.equal)")
    inputs["lazy_march"] = (got["args"], lv, lplain_ms)
    inputs["lazy launches"] = lazies
    return inputs


def check_slice8(torch, scenes, cam, cam_rays, errs):
    """K14 against its plain version and against K1 + K2 on the card, on
    the cornell camera and first-bounce rays and on the reference camera
    rays (1,838 triangles); K15 against its plain version on all six
    outputs on the cornell rays, and its lanes whose t, index or hit/miss
    differ from K4's counted (information: the two round their dots
    differently by design); every comparison torch.equal. Both take their
    pack's table of the skip rule (`cluster_kernel.sub_boxes` over the one
    span [0, T), its host build timed here). Returns the inputs at which
    K14 and K15 are checked further and timed (check_slice16), with their
    plain versions' times (ms) from these checks."""
    from opencl_path_tracer_tpu_torch.ops.kernels import (
        cluster_kernel as ck, intersect_kernel as k1, plucker_kernel as k2)
    from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
    from opencl_path_tracer_tpu_torch.scene import library

    def table(pack):
        t0 = time.perf_counter()
        sub = ck.sub_boxes(pack, [(0, pack.shape[0])])
        torch.cuda.synchronize()
        print(f"the skip rule's table of {pack.shape[0]} rows in one span "
              f"({sub.shape[0]} sub-blocks): built on the host in "
              f"{(time.perf_counter() - t0) * 1e3:.2f} ms")
        return sub

    def compare(name, outs, plain, where):
        torch.cuda.synchronize()
        for a, b in zip(outs, plain):
            errs[name] = max(errs[name], float((a - b).abs().max()))
        need(all(torch.equal(a, b) for a, b in zip(outs, plain)),
             f"{name} differs from its plain version on {where}")

    inputs = {}
    corn = scenes["cornell"]
    pack = k1.build_tri_pack(corn.tris)
    sub = table(pack)
    isect = make_intersect_fn(corn, "auto")
    for rname, rays in (("camera", cam_rays),
                        ("bounce", bounce_rays(torch, corn, cam, cam_rays,
                                               isect))):
        where = f"cornell {rname} rays"
        rays8 = k1.pack_rays(rays.p, rays.d).contiguous()
        f = k2.minarg_fused(rays8, pack, sub)
        plain, f_ms = timed(torch,
                            lambda: k2.minarg_fused_plain(rays8, pack))
        compare("minarg_fused", f, plain, where)
        need(all(torch.equal(a, b) for a, b in zip(
            f, k2.refine1(*k1.minarg(rays8, pack), pack))),
             f"minarg_fused differs from minarg + refine1 on {where}")
        o = k1.mxu(rays8, pack, sub)
        plain, m_ms = timed(torch, lambda: k1.mxu_plain(rays8, pack))
        compare("mxu", o, plain, where)
        d = k1.dense(rays8, pack)
        h15, h4 = o[0] < k1.BIG, d[0] < k1.BIG
        print(f"{where} ({rays8.shape[1]}): minarg_fused ({int(h15.sum())} "
              "hits) equal to its plain version and to minarg + refine1, "
              f"mxu equal to its plain version (torch.equal); mxu against "
              f"dense: {int((o[0] != d[0]).sum())} lanes with another t, "
              f"{int((o[1] != d[1]).sum())} with another index, "
              f"{int((h15 != h4).sum())} with another hit or miss")
        inputs[f"dense16 cornell {rname}"] = (rays8, pack, sub, f_ms, m_ms)
    # K4 at the stress tails' shape: 16,384 lanes of the camera rays.
    stress = scenes["stress"]
    sl = slice(None, 126 * 16384, 126)
    inputs["dense stress tail"] = (
        k1.pack_rays(tuple(x[sl] for x in cam_rays.p),
                     tuple(x[sl] for x in cam_rays.d)).contiguous(),
        k1.build_tri_pack(stress.tris))
    # A second, larger table: the reference scene.
    ref = scenes["reference"]
    rpack = k1.build_tri_pack(ref.tris)
    rsub = table(rpack)
    rays = camera_rays(library.reference_camera(W, H, device="cuda"))
    r8 = k1.pack_rays(rays.p, rays.d).contiguous()
    f = k2.minarg_fused(r8, rpack, rsub)
    compare("minarg_fused", f, k2.minarg_fused_plain(r8, rpack),
            "reference camera rays")
    need(all(torch.equal(a, b) for a, b in zip(
        f, k2.refine1(*k1.minarg(r8, rpack), rpack))),
         "minarg_fused differs from minarg + refine1 on reference camera rays")
    o = k1.mxu(r8, rpack, rsub)
    compare("mxu", o, k1.mxu_plain(r8, rpack), "reference camera rays")
    print(f"reference camera rays ({ref.tris.count} triangles): minarg_fused "
          "equal to its plain version and to minarg + refine1, mxu equal to "
          "its plain version (torch.equal)")
    inputs["dense16 reference camera"] = (r8, rpack, rsub)
    return inputs


def check_slice9(torch, scenes, cam_rays, inputs, errs):
    """K4 and K18m as redesigned for the H100. K4 against its plain
    version in both layouts (the hit rows into a column slice of a wider
    (6, N) from a column slice of wider rays) at three shapes: the 2,073,600
    cornell camera rays (one loop, splits 1), the stress tails' 16,384
    lanes x 99,380 triangles, and 300 lanes x 20,000 triangles whose rows
    10,000-19,999 repeat rows 0-9,999 (exact-t ties across chunks); the
    splits each shape takes are printed. K18m against its plain version on
    an odd L and on views with storage offsets; every comparison
    torch.equal."""
    from opencl_path_tracer_tpu_torch.ops.kernels import (
        intersect_kernel as k1, march_kernel as mk)
    dev = cam_rays.p[0].device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def compare(name, outs, plain, where):
        torch.cuda.synchronize()
        for a, b in zip(outs, plain):
            errs[name] = max(errs[name], float((a - b).abs().max()))
        need(all(torch.equal(a, b) for a, b in zip(outs, plain)),
             f"{name} differs from its plain version on {where}")

    def both_layouts(where, rays8, pack):
        n = rays8.shape[1]
        t = k1.dense(rays8, pack)
        compare("dense", t, k1.dense_plain(rays8, pack), where)
        wide = torch.zeros((8, n + 96), device=dev)
        wide[:, 40:40 + n] = rays8
        hk = torch.full((6, n + 64), 7.0, device=dev)
        hp = hk.clone()
        k1.dense(wide[:, 40:40 + n], pack, out=hk[:, 24:24 + n])
        k1.dense_plain(wide[:, 40:40 + n], pack, out=hp[:, 24:24 + n])
        compare("dense", (hk,), (hp,), where + " (hit rows, in place)")
        splits, chunk = k1.dense_splits(n, pack.shape[0], sms)
        print(f"dense on {where} ({n} lanes x {pack.shape[0]} triangles): "
              f"{splits} split(s) of {chunk} triangles on {sms} SMs, "
              f"{int((t[0] < k1.BIG).sum())} hits; both layouts equal to the "
              "plain version (torch.equal)")
        return splits

    pack = k1.build_tri_pack(scenes["cornell"].tris)
    need(both_layouts("cornell camera rays",
                      k1.pack_rays(cam_rays.p, cam_rays.d).contiguous(),
                      pack) == 1,
         "dense splits the 2,073,600 cornell camera rays")
    r8t, spack = inputs["dense stress tail"]
    need(both_layouts("the stress tails' shape", r8t, spack) > 1,
         "dense does not split the stress tails' shape")
    twins = torch.cat([spack[:10_000], spack[:10_000]])
    small = r8t[:, ::54][:, :300].contiguous()
    g = k1.dense_plain(small, twins)[1]
    need(bool(((g > 0) & (g < 10_000)).any()),
         "no lane of the tie check hits a repeated triangle")
    need(both_layouts("300 lanes against repeated rows", small, twins) > 1,
         "dense does not split 300 lanes x 20,000 triangles")
    # K18m on an odd L and on views whose storage starts off 16-byte
    # boundaries (the bf16 one off 4-byte boundaries too).
    clist, r8s, feat = inputs["march"][:3]
    n = r8s.shape[1]
    lbuf = torch.empty(clist.numel() + 2, dtype=torch.int32, device=dev)
    lbuf[1:1 + clist.numel()] = clist
    odd = lbuf[1:1 + clist.numel() - (1 - clist.numel() % 2)]
    rbuf = torch.empty(8 * n + 3, device=dev)
    r8v = rbuf[3:].view(8, n)
    r8v.copy_(r8s)
    fbuf = torch.empty(32 * n + 1, dtype=torch.bfloat16, device=dev)
    fv = fbuf[1:].view(32, n)
    fv.copy_(feat)
    for what, args in (("odd L", (odd, r8s, feat)),
                       ("storage offsets", (lbuf[1:1 + clist.numel()], r8v,
                                            fv))):
        compare("materialize", mk.materialize(*args),
                mk.materialize_plain(*args), f"'march' round 1, {what}")
    print(f"materialize on 'march' round 1 with an odd L ({odd.numel()}) "
          "and with views at storage offsets of 4, 12 and 2 bytes: equal "
          "to its plain version (torch.equal)")


def check_slice10(torch, scenes, cam_rays, inputs):
    """K18 as redesigned for the H100 (the edge values on the tensor
    cores behind a certified margin) against its first kernel, every
    product on the float32 cores (`run_march_simt`), on whole launches:
    each K18 launch of the 'march' intersector (rounds 1 and 2) and of
    the 'flat' intersector (round 0) on the 1080p stress camera rays,
    captured from the intersectors themselves, torch.equal; the counting
    entry's rows equal too, and the edge tests its margin sent to the
    float32 chain are printed per launch. Then the two bodies timed in
    turns (first, new, new, first) on 'march' round 1's inputs."""
    from opencl_path_tracer_tpu_torch.ops.kernels import (
        flat_march as fm, march_kernel as mk)
    stress = scenes["stress"]
    real, launches = mk.run_march, []

    def capture(*a):
        out = real(*a)
        launches.append((a, out))
        return out

    mk.run_march = capture
    try:
        for name, make in (("march", mk.make_march_intersect),
                           ("flat", fm.make_flat_march_intersect)):
            launches.append(name)
            make(stress.tris)[0](cam_rays)
    finally:
        mk.run_march = real
    name, rnd = None, 0
    for item in launches:
        if isinstance(item, str):
            name, rnd = item, (1 if item == "march" else 0)
            continue
        args, out = item
        clist, r8, _, _, cs, K, tr = args
        torch.cuda.synchronize()
        where = f"'{name}' round {rnd} of the stress camera rays"
        need(torch.equal(out, mk.run_march_simt(*args)),
             f"march differs from its first kernel on {where}")
        counted, exact = mk.run_march_counted(*args)
        need(torch.equal(counted, out),
             f"march's counting entry differs from it on {where}")
        tests = int((clist >= 0).sum()) * tr * cs
        print(f"march on {where} ({r8.shape[1]} lanes, {tests} (lane, "
              f"triangle) tests): equal to its first kernel (torch.equal); "
              f"{exact} of {3 * tests} edge tests took the float32 chain "
              f"({exact / max(3 * tests, 1):.3e})")
        rnd += 1
    clist, r8s, feat, ms, cs, K, tr = inputs["march"][:7]

    def first():
        mk.run_march_simt(clist, r8s, feat, ms, cs, K, tr)

    def new():
        mk.run_march(clist, r8s, feat, ms, cs, K, tr)

    turns = [time_ms(torch, f, 5) for f in (first, new, new, first)]
    print("march on 'march' round 1 in turns (first kernel, tensor-core "
          "kernel, tensor-core kernel, first kernel): "
          + ", ".join(f"{x:.4f}" for x in turns) + " ms")


def check_slice11(torch, scenes, cam, cam_rays, inputs):
    """K13a and K1 as redesigned for the H100. K13a (the edge values on
    the tensor cores behind K18's certified margin, the scan stopped at
    the live triangle count) against its first kernel
    (`run_candidates_simt`) and its plain version on every K13a launch of
    the fused pipeline's first two steps at 1080p, captured from
    `make_plucker_intersect` itself, torch.equal, with the edge tests the
    margin sent to the float32 chain printed per launch; and on packs
    whose live count ends a chunk before whole chunks of padding (1,280
    and 1,792 parallel planes) with lanes that accept t above BIG on every
    live row, where the first padding chunk's fill wins. K1 (pairs
    settled by sign or distance before the divide in warps of coherent
    rays, the joint loop in the others) against its first kernel
    (`minarg_simt`) and `minarg_plain` on the cornell and reference
    camera and first-bounce rays, the stress-analytic triangles and
    tests/minarg_rays.py's adversarial batch (with a pack whose rows
    repeat: exact t ties), torch.equal, with the shares of warps that ran
    the joint loop and of pairs that reached the divide and the edges.
    Then each timed in turns (first, new, new, first): K13a on its table
    inputs, K1 on the cornell and reference camera and first-bounce
    rays."""
    from opencl_path_tracer_tpu_torch.models import pipeline
    from opencl_path_tracer_tpu_torch.ops import rng
    from opencl_path_tracer_tpu_torch.ops.kernels import (
        intersect_kernel as k1, plucker_kernel as k2)
    from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
    from opencl_path_tracer_tpu_torch.scene import library
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from minarg_rays import (adversarial_rays, planes, t_above_big_rays,
                             tie_pack)

    corn = scenes["cornell"]
    real, seen = k2.candidates, []

    def capture(rays8, trig, tric, chunk=256, *, live):
        out = real(rays8, trig, tric, chunk, live=live)
        torch.cuda.synchronize()
        where = f"fused step {len(seen) + 1} ({rays8.shape[1]} lanes)"
        need(torch.equal(out, k2.run_candidates_simt(rays8, trig, tric,
                                                     chunk)),
             f"plucker_cand differs from its first kernel on {where}")
        need(torch.equal(out, k2.candidates_plain(rays8, trig, tric, chunk)),
             f"plucker_cand differs from its plain version on {where}")
        counted, chain = k2.candidates_counted(rays8, trig, tric, chunk,
                                               live=live)
        need(torch.equal(counted, out),
             f"plucker_cand's counting entry differs from it on {where}")
        tests = 3 * rays8.shape[1] * live
        print(f"plucker_cand on {where}, {live} live of {tric.shape[0]} "
              f"rows: equal to its first kernel and its plain version "
              f"(torch.equal); {chain} of {tests} edge tests took the "
              f"float32 chain ({chain / tests:.3e})")
        seen.append(live)
        return out

    k2.candidates = capture
    try:
        state, step, _ = pipeline.make_fast_pipeline(
            corn, cam, width=W, height=H, iterations=BOUNCES, key=rng.key(1))
        for _ in range(2):
            state = step(*state)
    finally:
        k2.candidates = real
    need(seen == [corn.tris.count] * 2,
         f"the fused pipeline's first two steps made {len(seen)} K13a "
         "launches, not 2 with the live count")
    for count in (1280, 1792):
        ptris = planes(count).to("cuda")
        trig, tric, _ = k2.build_plucker_packs(ptris)
        r8 = torch.cat([t_above_big_rays(65_536), torch.as_tensor(
            adversarial_rays(ptris, 65_536, 19))], 1).cuda()
        out = k2.candidates(r8, trig, tric, live=count)
        torch.cuda.synchronize()
        where = f"{count} planes in {tric.shape[0]} rows"
        need(torch.equal(out, k2.run_candidates_simt(r8, trig, tric)),
             f"plucker_cand differs from its first kernel on {where}")
        need(torch.equal(out, k2.candidates_plain(r8, trig, tric)),
             f"plucker_cand differs from its plain version on {where}")
        fill = int((out[1, :65_536] == count).sum())
        need(fill == 65_536, f"plucker_cand on {where}: {fill} of 65536 "
             "lanes took the first padding chunk's fill")
        print(f"plucker_cand on {where} (lanes accepting t above BIG on "
              "every live row, and adversarial lanes): equal to its first "
              "kernel and its plain version (torch.equal); the first "
              "padding chunk's fill on every such lane")

    def minarg_case(where, rays8, pack):
        t, g = k1.minarg(rays8, pack)
        torch.cuda.synchronize()
        need(all(torch.equal(a, b) for a, b in zip(
            (t, g), k1.minarg_simt(rays8, pack))),
             f"minarg differs from its first kernel on {where}")
        need(all(torch.equal(a, b) for a, b in zip(
            (t, g), k1.minarg_plain(rays8, pack))),
             f"minarg differs from its plain version on {where}")
        (tc, gc), divides, edges, joint = k1.minarg_counted(rays8, pack)
        need(torch.equal(tc, t) and torch.equal(gc, g),
             f"minarg's counting entry differs from it on {where}")
        pairs = rays8.shape[1] * pack.shape[0]
        warps = -(-rays8.shape[1] // 512) * 8
        print(f"minarg on {where} ({rays8.shape[1]} rays x {pack.shape[0]} "
              f"triangles, {int((t < k1.BIG).sum())} hits): equal to its "
              f"first kernel and its plain version (torch.equal); warps "
              f"in the joint loop {joint / warps:.4f}; pairs that reached "
              f"the divide {divides / pairs:.4f}, the edge tests "
              f"{edges / pairs:.4f}")

    ref = scenes["reference"]
    rcam = library.reference_camera(W, H, device="cuda")
    rcam_rays = camera_rays(rcam)
    turns_on = {}
    for sname, scene, c, crays in (("cornell", corn, cam, cam_rays),
                                   ("reference", ref, rcam, rcam_rays)):
        pack = k1.build_tri_pack(scene.tris)
        isect = make_intersect_fn(scene, "auto")
        for rname, rays in (("camera", crays),
                            ("bounce", bounce_rays(torch, scene, c, crays,
                                                   isect))):
            r8 = k1.pack_rays(rays.p, rays.d).contiguous()
            minarg_case(f"{sname} {rname} rays", r8, pack)
            turns_on[f"{sname} {rname}"] = (r8, pack)
        adv = torch.as_tensor(adversarial_rays(scene.tris, 100_003,
                                               3)).cuda()
        minarg_case(f"{sname} adversarial rays", adv, pack)
        minarg_case(f"{sname} adversarial rays, rows repeated", adv,
                    tie_pack(pack))
    sa = scenes["stress-analytic"]
    minarg_case("stress-analytic reference-camera rays",
                k1.pack_rays(rcam_rays.p, rcam_rays.d).contiguous(),
                k1.build_tri_pack(sa.tris))

    rays8c, trig, tric, tp = inputs["plucker_cand"]
    turns = [time_ms(torch, f, 10) for f in (
        lambda: k2.run_candidates_simt(rays8c, trig, tric),
        lambda: k2.candidates(rays8c, trig, tric, live=tp),
        lambda: k2.candidates(rays8c, trig, tric, live=tp),
        lambda: k2.run_candidates_simt(rays8c, trig, tric))]
    print("plucker_cand on the fused lanes in turns (first kernel, "
          "tensor-core kernel, tensor-core kernel, first kernel): "
          + ", ".join(f"{x:.4f}" for x in turns) + " ms")
    for where, (r8, pack) in turns_on.items():
        turns = [time_ms(torch, f, 20) for f in (
            lambda: k1.minarg_simt(r8, pack), lambda: k1.minarg(r8, pack),
            lambda: k1.minarg(r8, pack), lambda: k1.minarg_simt(r8, pack))]
        print(f"minarg on the {where} rays in turns (first kernel, "
              "new kernel, new kernel, first kernel): "
              + ", ".join(f"{x:.4f}" for x in turns) + " ms")


def check_slice12(torch, inputs):
    """K19 and K20 as redesigned for the H100: both on K18's tensor-core
    visit (march_mma.cuh), K19 over its segments cut into chunks of at
    most CHUNK real visits, longest segments first. Each K19 launch of
    the 'flat' intersector on the 1080p stress camera rays and
    first-bounce rays, and each K20 launch of the lazy pipeline's first
    two steps, captured from the intersector and the pipeline themselves
    in check_slice7, against its first kernel (`run_flat_simt`,
    `run_lazy_march_simt`) whole and its plain version on the first
    PLAIN_BLOCKS blocks, torch.equal; the counting entries' outputs
    equal too, with the edge tests the margin sent to the float32 chain
    and K19's segment statistics printed per launch. Then, in turns
    (first, new, new, first): K19 on round 1 of the camera and of the
    first-bounce rays (with the kernel unsplit, one chunk per block in
    block order and longest first, and at other chunk sizes beside), K20
    on the second lazy step. Returns the first-bounce K19 input for the
    kernels line."""
    from opencl_path_tracer_tpu_torch.ops.kernels import (
        flat_march as fm, lazy_march as lm)
    p = PLAIN_BLOCKS
    out_inputs = {}
    for rname, (args, out) in zip(("camera", "first-bounce"),
                                  inputs["flat launches"]):
        vb, vc, r8, feat, rows0, fs, cs, tr = args
        torch.cuda.synchronize()
        where = f"'flat' round 1 of the stress {rname} rays"
        need(torch.equal(out, fm.run_flat_simt(*args)),
             f"flat_march differs from its first kernel on {where}")
        counted, chain = fm.run_flat_counted(*args)
        need(torch.equal(counted, out),
             f"flat_march's counting entry differs from it on {where}")
        m = int((vb < p).sum())
        plain, plain_ms = timed(torch, lambda: fm.flat_plain(
            vb[:m], vc[:m], r8[:, :p * tr].contiguous(),
            feat[:, :p * tr].contiguous(), rows0[:, :p * tr].contiguous(),
            fs, cs, tr))
        need(torch.equal(out[:, :p * tr], plain),
             f"flat_march differs from its plain version on {where} (first "
             f"{p} blocks)")
        nv = int((vc >= 0).sum())
        tests = nv * tr * cs
        # The segments: real visits per tr-block, and the work list.
        items, _, counts = fm.flat_chunks(vb, vc, r8.shape[1] // tr,
                                          fm.CHUNK)
        c = counts.double()
        print(f"flat_march on {where} ({r8.shape[1]} lanes, {nv} visits, "
              f"{tests} (lane, triangle) tests): equal to its first kernel "
              f"and, on the first {p} blocks, its plain version "
              f"(torch.equal); {chain} of {3 * tests} edge tests took the "
              f"float32 chain ({chain / max(3 * tests, 1):.3e}); real "
              f"visits per tr-block mean {float(c.mean()):.2f}, p99 "
              f"{float(torch.quantile(c, 0.99)):.0f}, max {int(c.max())}; "
              f"{int((items[0] >= 0).sum())} chunks of at most S = "
              f"{fm.CHUNK}")
        turns = [time_ms(torch, f, 5) for f in (
            lambda: fm.run_flat_simt(*args), lambda: fm.run_flat(*args),
            lambda: fm.run_flat(*args), lambda: fm.run_flat_simt(*args))]
        whole = 1 << 30   # one chunk per block
        in_order = time_ms(torch, lambda: fm._launch_chunks(
            "flat_march", *args, whole, longest_first=False), 5)
        sizes = {s: time_ms(torch, lambda: fm._launch_chunks(
            "flat_march", *args, s), 5) for s in (8, 16, 64, whole)}
        print(f"flat_march on {where} in turns (first kernel, new kernel, "
              "new kernel, first kernel): "
              + ", ".join(f"{x:.4f}" for x in turns) + f" ms (S = "
              f"{fm.CHUNK}); one chunk per block in block order "
              f"{in_order:.4f} ms, longest first {sizes.pop(whole):.4f} ms; "
              + ", ".join(f"S = {s} {x:.4f} ms" for s, x in sizes.items()))
        out_inputs[rname] = (args, nv, plain_ms)

    lazies = inputs["lazy launches"]
    need(len(lazies) == 2, f"the lazy pipeline's first two steps made "
         f"{len(lazies)} K20 launches, not 2")
    for k, (args, (o20, v20)) in enumerate(lazies):
        clist, l8, lfeat, rows_in, vis, lsc, lcs, lk, ltr = args
        torch.cuda.synchronize()
        where = f"lazy step {k + 1}"
        first = lm.run_lazy_march_simt(*args)
        need(torch.equal(o20, first[0]) and torch.equal(v20, first[1]),
             f"lazy_march differs from its first kernel on {where}")
        c20, cv20, chain = lm.run_lazy_march_counted(*args)
        need(torch.equal(c20, o20) and torch.equal(cv20, v20),
             f"lazy_march's counting entry differs from it on {where}")
        pl = p * ltr
        plain = lm.lazy_plain(
            clist[:p * lk], l8[:, :pl].contiguous(), lfeat[:, :pl].contiguous(),
            rows_in[:, :pl].contiguous(), vis[:, :pl].contiguous(), lsc, lcs,
            lk, ltr)
        need(torch.equal(o20[:, :pl], plain[0])
             and torch.equal(v20[:, :pl], plain[1]),
             f"lazy_march differs from its plain version on {where} (first "
             f"{p} blocks)")
        nv = int((clist >= 0).sum())
        tests = nv * ltr * lcs
        print(f"lazy_march on {where} ({l8.shape[1]} lanes, {nv} visits, "
              f"{tests} (lane, triangle) tests, {vis.shape[0]} mask words): "
              f"equal to its first kernel and, on the first {p} blocks, its "
              f"plain version (torch.equal); {chain} of {3 * tests} edge "
              f"tests took the float32 chain ({chain / max(3 * tests, 1):.3e})")
    args = lazies[1][0]
    turns = [time_ms(torch, f, 5) for f in (
        lambda: lm.run_lazy_march_simt(*args), lambda: lm.run_lazy_march(*args),
        lambda: lm.run_lazy_march(*args), lambda: lm.run_lazy_march_simt(*args))]
    print("lazy_march on the second lazy step in turns (first kernel, new "
          "kernel, new kernel, first kernel): "
          + ", ".join(f"{x:.4f}" for x in turns) + " ms")
    return {"flat_march bounce": out_inputs["first-bounce"]}


def check_slice13(torch, inputs):
    """K10 and K12 as redesigned for the H100: K10 on K18's tensor-core
    visit (march_mma.cuh) with the features computed in the kernel, K12
    skipping the sub-blocks its rule proves cannot hold a hit. Each on
    round 1 of the stress camera pairs and of the first-bounce pairs (K10
    at PAIR_TPU_WINNER, K12 at the 'pair' defaults) against its first
    kernel (`pair_visits_simt`, `run_pairs_simt`) and its counting entry
    whole and its plain version (on the camera pairs in check_pairs and
    check_slice6; K12's on the first K12_PREFIX pairs where the pairs
    exceed K12_PLAIN_CELLS tests), torch.equal, with the counts printed
    (K10: the edge tests its margin sent to the float32 chain; K12: the
    tests that reached the divide, the sub-blocks whose box test passed
    and those the whole warp ran); then each timed in turns (first, new,
    new, first) on both inputs. Returns the first-bounce inputs for the
    kernels line."""
    from opencl_path_tracer_tpu_torch.ops.kernels import (
        intersect_kernel as k1, pair_mxu as pm, sorted_intersect as si)
    bounce = inputs["stress bounce rays"]
    rb8 = k1.pack_rays(bounce.p, bounce.d).contiguous()
    out = {}

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def in_turns(first, new):
        return ", ".join(f"{time_ms(torch, f, 5):.4f}"
                         for f in (first, new, new, first))

    keys_s, r8p, ms, cs, trp, c, nv = inputs["pair_visit"]
    _, boxes_r, _ = inputs["pair_cand"]
    ids = si.run_candidates(rb8, boxes_r, 2, c)
    keys_b, r8p_b, _ = pm.sort_pairs([rb8[j] for j in range(6)], ids[0], c,
                                     trp)
    nv_b = int((pm.build_visits(keys_b, trp, c)[1] >= 0).sum())
    for rname, keys, r8 in (("camera", keys_s, r8p),
                            ("first-bounce", keys_b, r8p_b)):
        args = (keys, r8, ms.trig, ms.tric, cs, trp, c)
        where = f"round 1's pairs of the stress {rname} rays"
        new = pm.pair_visits(*args)
        torch.cuda.synchronize()
        need(same(new, pm.pair_visits_simt(*args)),
             f"pair_visit differs from its first kernel on {where}")
        counted, chain = pm.pair_visits_counted(*args)
        need(same(counted, new),
             f"pair_visit's counting entry differs from it on {where}")
        if rname == "first-bounce":   # the camera pairs' in check_pairs
            plain, plain_ms = timed(torch,
                                    lambda: pm.pair_visits_plain(*args))
            need(same(new, plain),
                 f"pair_visit differs from its plain version on {where}")
        n_v = nv if rname == "camera" else nv_b
        tests = n_v * trp * cs
        hits = int((new[0] < k1.BIG).sum())
        print(f"pair_visit on {where} ({keys.shape[0]} pairs, {n_v} visits, "
              f"{tests} (pair, triangle) tests, {hits} hits, "
              f"{int((new[1] % 2).sum())} pending): equal to its first "
              f"kernel and its plain version (torch.equal); {chain} of "
              f"{3 * tests} edge tests took the float32 chain "
              f"({chain / max(3 * tests, 1):.3e})")
        print(f"pair_visit on {where} in turns (first kernel, new kernel, "
              "new kernel, first kernel): "
              + in_turns(lambda: pm.pair_visits_simt(*args),
                         lambda: pm.pair_visits(*args)) + " ms")
        if rname == "first-bounce":
            out["pair_visit bounce"] = (keys, r8, ms, cs, trp, c, n_v,
                                        plain_ms)

    keys_n, r8p_n, rows, k, _ = inputs["pair_vpu"]
    sub, boxes8, c8 = inputs["pair_vpu scene"]
    ids = si.run_candidates(rb8, boxes8, 8, c8)
    keys_b, r8p_b, _ = pm.sort_pairs([rb8[j] for j in range(6)], ids[0], c8,
                                     1024)
    nsb = -(-k // si.SUB)
    for rname, keys, r8 in (("camera", keys_n, r8p_n),
                            ("first-bounce", keys_b, r8p_b)):
        where = f"round 1's pairs of the stress {rname} rays"
        new = si.run_pairs(keys, r8, rows, k, sub)
        torch.cuda.synchronize()
        need(same(new, si.run_pairs_simt(keys, r8, rows, k)),
             f"pair_vpu differs from its first kernel on {where}")
        counted, (n_div, n_box, n_coop, n_edge) = si.run_pairs_counted(
            keys, r8, rows, k, sub)
        need(same(counted, new),
             f"pair_vpu's counting entry differs from it on {where}")
        real = int((keys < c8).sum())
        n = (keys.shape[0] if real * k <= K12_PLAIN_CELLS
             else min(K12_PREFIX, keys.shape[0]))
        if rname == "first-bounce":   # the camera pairs' in check_slice6
            kp, rp = keys[:n].contiguous(), r8[:, :n].contiguous()
            plain, plain_ms = timed(torch, lambda: si.pairs_plain(
                kp, rp, rows, k))
            need(same(tuple(x[:n] for x in new), plain),
                 f"pair_vpu differs from its plain version on {where}")
        print(f"pair_vpu on {where} ({keys.shape[0]} pairs, {real} not "
              f"dummy, {int((new[0] < k1.BIG).sum())} hits): equal to its "
              f"first kernel and, on {n} pairs, its plain version "
              f"(torch.equal); {n_div} of {real * k} (pair, triangle) tests "
              f"reached the divide ({n_div / max(real * k, 1):.4f}) and "
              f"{n_edge} edge tests; {n_box} of {real * nsb} sub-block box "
              f"tests passed ({n_box / max(real * nsb, 1):.4f}), {n_coop} "
              "of them run by the whole warp")
        print(f"pair_vpu on {where} in turns (first kernel, new kernel, new "
              "kernel, first kernel): "
              + in_turns(lambda: si.run_pairs_simt(keys, r8, rows, k),
                         lambda: si.run_pairs(keys, r8, rows, k, sub))
              + " ms")
        if rname == "first-bounce":
            out["pair_vpu bounce"] = (keys, r8, rows, k, plain_ms)
    return out


def check_slice14(torch, scenes, cam, cam_rays, inputs):
    """K17 and K7 as redesigned for the H100: a ray skips each sub-block
    of 32 rows whose box (`cluster_kernel.sub_boxes`) its segment to its
    running best (K17) or to rmax (K7) misses, and nothing is staged for
    a block. K17 on the stress camera rays (its plain version's check is
    in check_slice6) and first-bounce rays, K7 on the NEE shadow rays of
    bounces 0, 1 and 2 of cornell and of reference, each against its
    first kernel (`run_cluster_simt`, `anyhit_simt`) and its counting
    entry, K7 also against its plain version, K17 on the first-bounce
    rays on its first CLUSTER_PLAIN_TILES tiles (torch.equal), with the
    clusters listed per tile and the counts printed; then each timed in
    turns (first, new, new, first). Returns the inputs of the kernels
    line's rows on bounce rays, with the counts their bounds read."""
    from opencl_path_tracer_tpu_torch.ops.kernels import (
        cluster_kernel as ck, intersect_kernel as k1, tilecull_kernel as tk)
    from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
    from opencl_path_tracer_tpu_torch.scene import library
    out = {}

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def in_turns(first, new, reps):
        return ", ".join(f"{time_ms(torch, f, reps):.4f}"
                         for f in (first, new, new, first))

    rr8, cnt, ids, ent, crows, kk, csub, _ = inputs["cluster"]
    boxes = inputs["cluster boxes"]
    bounce = inputs["stress bounce rays"]
    br8 = ck.pack_rays_rows(bounce.p, bounce.d,
                            -(-bounce.count // 256) * 256)
    bids, bcnt, bent = ck._tile_cluster_lists(br8, boxes, 256)
    c = boxes.shape[0]
    for rname, args, reps in (
            ("camera", (rr8, cnt, ids, ent, crows, kk, 256), 5),
            ("first-bounce", (br8, bcnt, bids, bent, crows, kk, 256), 2)):
        where = f"the stress {rname} rays"
        t0 = time.perf_counter()
        new = ck.run_cluster(*args, False, csub)
        need(same(new, ck.run_cluster_simt(*args, False)),
             f"cluster differs from its first kernel on {where}")
        counted, counts = ck.run_cluster_counted(*args, False, csub)
        need(same(counted, new),
             f"cluster's counting entry differs from it on {where}")
        plain_ms = None
        if rname == "first-bounce":
            # Every first-bounce tile lists nearly every cluster: the plain
            # version would take minutes on all of them.
            m = CLUSTER_PLAIN_TILES
            pre = (args[0][:m * 256], args[1][:m], args[2][:m],
                   args[3][:m]) + args[4:]
            plain, plain_ms = timed(torch, lambda: ck.cluster_plain(
                *pre, False))
            need(same(tuple(x[:m * 256] for x in new), plain),
                 f"cluster differs from its plain version on {where}' "
                 f"first {m} tiles")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n_div, n_box, n_coop, n_edge, n_made = counts
        r, g = args[0].shape[0], args[1].shape[0]
        listed = int(args[1].sum())
        tests = listed * 256 * kk
        print(f"cluster on {where} ({g} tiles of 256): {listed / g:.1f} of "
              f"{c} clusters listed per tile, {tests} (ray, triangle) tests "
              f"over them; {n_box / r:.2f} sub-blocks passed per ray of "
              f"{n_made / r:.1f} box tests ({n_coop} of the {n_box} run by "
              f"the whole warp), {n_div} tests reached the divide "
              f"({n_div / tests:.5f} of the listed), {n_edge} edge tests; "
              f"{int((new[0] < k1.BIG).sum())} hits; equal to its first "
              "kernel and its counting entry"
              + (f", and on its first {CLUSTER_PLAIN_TILES} tiles its plain "
                 f"version ({plain_ms:.1f} ms)" if plain_ms else "")
              + f" (torch.equal); checks {dt:.2f} s")
        print(f"cluster on {where} in turns (first kernel, new kernel, new "
              "kernel, first kernel): "
              + in_turns(lambda: ck.run_cluster_simt(*args, False),
                         lambda: ck.run_cluster(*args, False, csub), reps)
              + " ms")
        if rname == "first-bounce":
            out["cluster bounce"] = (args, csub, counts, plain_ms)
    for sname in ("cornell", "reference"):
        scene = scenes[sname]
        scam = (cam if sname == "cornell"
                else library.reference_camera(W, H, device="cuda"))
        rays = cam_rays if sname == "cornell" else camera_rays(scam)
        isect = make_intersect_fn(scene, "auto")
        pack, groups, _ = tk.grouped_pack(scene.tris, 128)
        sub = tk.anyhit_sub_boxes(pack, groups)
        for b in range(3):
            if b:
                rays = bounce_rays(torch, scene, scam, rays, isect)
            shadow, rmax = nee_shadow_rays(torch, scene, scam, rays, isect)
            s8 = k1.pack_rays(shadow.p, shadow.d).contiguous()
            where = f"the {sname} bounce-{b} NEE shadow rays"
            t0 = time.perf_counter()
            new = tk.anyhit(s8, rmax, pack, groups, sub)
            need(torch.equal(new, tk.anyhit_simt(s8, rmax, pack, groups)),
                 f"anyhit differs from its first kernel on {where}")
            plain, plain_ms = timed(torch, lambda: tk.anyhit_plain(
                s8, rmax, pack, groups, ANYHIT_PLAIN_CHUNK))
            need(torch.equal(new, plain),
                 f"anyhit differs from its plain version on {where}")
            counted, counts = tk.anyhit_counted(s8, rmax, pack, groups, sub)
            need(torch.equal(counted, new),
                 f"anyhit's counting entry differs from it on {where}")
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            n_div, n_box, n_coop, n_edge, n_made = counts
            r = s8.shape[1]
            print(f"anyhit on {where} ({r} rays, {groups.shape[0]} groups, "
                  f"{int(new.sum())} occluded): {n_box / r:.3f} sub-blocks "
                  f"passed per ray ({n_coop} of {n_box} by the whole warp), "
                  f"{n_div} tests reached the divide, {n_edge} edge tests, "
                  f"{n_made} slab and box tests; equal to its first kernel, "
                  "its plain version and its counting entry (torch.equal); "
                  f"checks {dt:.2f} s")
            print(f"anyhit on {where} in turns (first kernel, new kernel, "
                  "new kernel, first kernel): "
                  + in_turns(lambda: tk.anyhit_simt(s8, rmax, pack, groups),
                             lambda: tk.anyhit(s8, rmax, pack, groups, sub),
                             10) + " ms")
            if sname == "cornell":
                out[f"anyhit bounce {b}"] = (s8, rmax, pack, groups, sub,
                                             counts, plain_ms)
    return out


def check_slice15(torch, scenes, inputs):
    """K6 and K16 as redesigned for the H100: a ray skips each sub-block
    of 32 rows whose box (`tilecull_kernel.anyhit_sub_boxes`,
    `cluster_kernel.cluster_sub_boxes`) its segment to its running best
    misses, and nothing is staged for a block. K6 on the cornell camera
    and first-bounce rays (its plain version's checks are in
    check_slice3), K16 on the reference camera and first-bounce rays (in
    check_slice6) and on the launches of the 'group' accel on the cornell
    camera and first-bounce rays (its plain version here), each against
    its first kernel (`tilecull_simt`, `run_group_simt`) and its counting
    entry (torch.equal), with the groups or clusters a first kernel's
    block of 256 rays stages, the tests it runs and the counts printed;
    then each timed in turns (first, new, new, first). Returns the counts
    that the kernels line's bounds read."""
    from opencl_path_tracer_tpu_torch.core.types import Rays
    from opencl_path_tracer_tpu_torch.ops.kernels import (
        intersect_kernel as k1, sorted_intersect as si, tilecull_kernel as tk)
    from opencl_path_tracer_tpu_torch.runtime.cull_ab import tilecull_staging
    from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
    out = {}

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def in_turns(first, new, reps):
        return ", ".join(f"{time_ms(torch, f, reps):.4f}"
                         for f in (first, new, new, first))

    for rname, key in (("camera", "tilecull"), ("first-bounce",
                                                "bounce rays")):
        r8, pack, groups, sub = inputs[key][:4]
        where = f"the cornell {rname} rays"
        t0 = time.perf_counter()
        new = tk.tilecull(r8, pack, groups, sub)
        need(same(new, tk.tilecull_simt(r8, pack, groups)),
             f"tilecull differs from its first kernel on {where}")
        counted, counts = tk.tilecull_counted(r8, pack, groups, sub)
        need(same(counted, new),
             f"tilecull's counting entry differs from it on {where}")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        staged, tests = tilecull_staging(r8, pack, groups)
        n_div, n_box, n_coop, n_edge, n_made = counts
        r = r8.shape[1]
        print(f"tilecull on {where} ({r} rays, {groups.shape[0]} groups): "
              f"the first kernel stages {staged:.2f} groups a block of 256 "
              f"and runs {tests} (ray, triangle) tests; {n_box / r:.3f} "
              f"sub-blocks passed per ray ({n_coop} of {n_box} by the whole "
              f"warp), {n_div} tests reached the divide "
              f"({n_div / max(tests, 1):.4f} of the first kernel's), "
              f"{n_edge} edge tests, {n_made} slab and box tests; "
              f"{int((new[0] < k1.BIG).sum())} hits; equal to its first "
              f"kernel and its counting entry (torch.equal); checks "
              f"{dt:.2f} s")
        print(f"tilecull on {where} in turns (first kernel, new kernel, new "
              "kernel, first kernel): "
              + in_turns(lambda: tk.tilecull_simt(r8, pack, groups),
                         lambda: tk.tilecull(r8, pack, groups, sub), 10)
              + " ms")
        out[f"counts tilecull {rname}"] = counts
    # K16 on the 'group' accel's own launches on cornell.
    cornell = scenes["cornell"]
    b8 = inputs["bounce rays"][0]
    got = []
    real = si.run_group

    def capture(*a):
        got.append(a)
        return real(*a)

    si.run_group = capture
    try:
        isect = make_intersect_fn(cornell, "group")
        for r8 in (inputs["tilecull"][0], b8):
            isect(Rays(p=tuple(r8[j] for j in range(3)),
                       d=tuple(r8[j] for j in range(3, 6))))
    finally:
        si.run_group = real
    need(len(got) == 2, f"the 'group' accel launched K16 {len(got)} times "
         "on two batches")
    cases = [(f"the reference {r} rays", inputs[f"group {r}"][:5],
              inputs[f"group {r}"][5]) for r in ("camera", "bounce")]
    for rname, a in zip(("camera", "first-bounce"), got):
        cases.append((f"the cornell {rname} rays", a[:4] + a[5:],
                      si.group_plain(*a[:5])))
    for where, (union, g8, rows, k, sub), plain in cases:
        block = g8.shape[0] // union.shape[0]
        args = (union, g8, rows, k, block)
        t0 = time.perf_counter()
        new = si.run_group(*args, sub)
        need(same(new, si.run_group_simt(*args)),
             f"group differs from its first kernel on {where}")
        if not isinstance(plain, float):
            need(same(new, plain),
                 f"group differs from its plain version on {where}")
        counted, counts = si.run_group_counted(*args, sub)
        need(same(counted, new),
             f"group's counting entry differs from it on {where}")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        c = rows.shape[0] // k
        bits = sum(((union >> b) & 1).long() for b in range(c))
        tests = int(bits.sum()) * block * k
        n_div, n_box, n_coop, n_edge, n_made = counts
        rg = g8.shape[0]
        print(f"group on {where} ({rg} rays, {c} clusters of {k}): the first "
              f"kernel stages {float(bits.float().mean()):.2f} clusters a "
              f"block of 256 and runs {tests} (ray, triangle) tests; "
              f"{n_box / rg:.3f} sub-blocks passed per ray ({n_coop} of "
              f"{n_box} by the whole warp), {n_div} tests reached the divide "
              f"({n_div / max(tests, 1):.4f} of the first kernel's), "
              f"{n_edge} edge tests, {n_made} box tests; "
              f"{int((new[0] < k1.BIG).sum())} hits; equal to its first "
              "kernel" + ("" if isinstance(plain, float) else
                          ", its plain version")
              + f" and its counting entry (torch.equal); checks {dt:.2f} s")
        print(f"group on {where} in turns (first kernel, new kernel, new "
              "kernel, first kernel): "
              + in_turns(lambda: si.run_group_simt(*args),
                         lambda: si.run_group(*args, sub), 10) + " ms")
        if where.startswith("the reference"):
            out[f"counts group {where.split()[2]}"] = counts
    return out


def check_slice16(torch, scenes, inputs):
    """K14 and K15 as redesigned for the H100: a ray walks the pack's
    sub-blocks of 32 rows in row order and skips each whose box (the
    one-span `sub_boxes` table) its segment to its running best misses
    (K15 none while its best is above BIG), with nothing staged for a
    block. Each against its first kernel (`minarg_fused_simt`,
    `mxu_simt`) and its counting entry on the cornell camera and
    first-bounce rays and the reference camera rays (their plain versions'
    checks are in check_slice8), and on tests/sub_cull_mirror.py's crafted
    batches (exact-t ties across sub-blocks, rows accepted above BIG for
    K15, -0.0 normals, D = 0 rays; T = 1, 31, 33 and 804) against its plain
    version and its first kernel, K14 also against K1 + K2 and, on batches
    with rows accepted above BIG, against K1 + K2, its first kernel and
    its plain version; every comparison torch.equal on the float32
    bits, with the sub-blocks passed per ray and the tests that reached
    the divide printed. Then each timed in turns (first, new, new, first)
    on the cornell camera and first-bounce rays. Returns the counts that
    the kernels line's bounds read."""
    from opencl_path_tracer_tpu_torch.ops.kernels import (
        cluster_kernel as ck, intersect_kernel as k1, plucker_kernel as k2)
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from sub_cull_mirror import ABOVE_BIG_CASES, CRAFTED_CASES, crafted_dense

    def bits(a):
        return [x.view(torch.int32) for x in a]

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(bits(a), bits(b)))

    def k1_k2(r8, pack):
        return k2.refine1(*k1.minarg(r8, pack), pack)

    entries = {"minarg_fused": (k2.minarg_fused, k2.minarg_fused_simt,
                                k2.minarg_fused_counted,
                                k2.minarg_fused_plain),
               "mxu": (k1.mxu, k1.mxu_simt, k1.mxu_counted, k1.mxu_plain)}
    out = {}
    for where, key in (("the cornell camera rays", "dense16 cornell camera"),
                       ("the cornell first-bounce rays",
                        "dense16 cornell bounce"),
                       ("the reference camera rays",
                        "dense16 reference camera")):
        r8, pack, sub = inputs[key][:3]
        r, t = r8.shape[1], pack.shape[0]
        for name, (fn, simt, counted, _) in entries.items():
            t0 = time.perf_counter()
            new = fn(r8, pack, sub)
            need(same(new, simt(r8, pack)),
                 f"{name} differs from its first kernel on {where}")
            c_out, counts = counted(r8, pack, sub)
            need(same(c_out, new),
                 f"{name}'s counting entry differs from it on {where}")
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            n_div, n_box, n_coop, n_edge, n_made = counts
            hits = int((new[0] > 0.0).sum() if name == "minarg_fused"
                       else (new[0] < k1.BIG).sum())
            print(f"{name} on {where} ({r} rays, {t} triangles in "
                  f"{sub.shape[0]} sub-blocks): {n_box / r:.3f} sub-blocks "
                  f"passed per ray ({n_coop} of {n_box} by the whole warp), "
                  f"{n_div} tests reached the divide ({n_div / (r * t):.4f} "
                  f"of the first kernel's {r * t}), {n_edge} edge tests, "
                  f"{n_made} box tests; {hits} hits; equal to its first "
                  "kernel and its counting entry (torch.equal on the bits); "
                  f"checks {dt:.2f} s")
            out[f"counts {name} {key.split()[-2]} {key.split()[-1]}"] = counts
    tris = scenes["cornell"].tris
    n_lanes = 0
    for name, n_rows, n_deg in CRAFTED_CASES:
        fn, simt, _, plain = entries[name]
        pack, r8 = crafted_dense(tris, n_rows, n_deg)
        pack, r8 = pack.cuda(), torch.as_tensor(r8).cuda()
        sub = ck.sub_boxes(pack, [(0, n_rows)])
        new = fn(r8, pack, sub)
        where = f"the crafted batch of {n_rows} rows ({n_deg} degenerate)"
        need(same(new, plain(r8, pack)),
             f"{name} differs from its plain version on {where}")
        need(same(new, simt(r8, pack)),
             f"{name} differs from its first kernel on {where}")
        if name == "minarg_fused":
            need(same(new, k1_k2(r8, pack)),
                 f"minarg_fused differs from minarg + refine1 on {where}")
        n_lanes += r8.shape[1]
    for n_rows, n_deg in ABOVE_BIG_CASES:
        pack, r8 = crafted_dense(tris, n_rows, n_deg)
        pack, r8 = pack.cuda(), torch.as_tensor(r8).cuda()
        sub = ck.sub_boxes(pack, [(0, n_rows)])
        new = k2.minarg_fused(r8, pack, sub)
        where = f"the crafted batch of {n_rows} rows ({n_deg} accepted " \
            "above BIG)"
        need(same(new, k2.minarg_fused_simt(r8, pack))
             and same(new, k1_k2(r8, pack)),
             f"minarg_fused differs from its first kernel or minarg + "
             f"refine1 on {where}")
        need(same(new, k2.minarg_fused_plain(r8, pack)),
             f"minarg_fused differs from its plain version on {where}")
    print(f"crafted batches ({len(CRAFTED_CASES)}, {n_lanes} lanes): "
          "minarg_fused and mxu equal to their plain versions and first "
          "kernels, minarg_fused to minarg + refine1; with rows accepted "
          f"above BIG ({len(ABOVE_BIG_CASES)} batches) minarg_fused equal to "
          "its plain version, its first kernel and minarg + refine1 "
          "(torch.equal on the bits)")

    def in_turns(first, new, reps):
        return ", ".join(f"{time_ms(torch, f, reps):.4f}"
                         for f in (first, new, new, first))

    for rname, key in (("camera", "dense16 cornell camera"),
                       ("first-bounce", "dense16 cornell bounce")):
        r8, pack, sub = inputs[key][:3]
        for name, (fn, simt, _, _) in entries.items():
            print(f"{name} on the cornell {rname} rays in turns (first "
                  "kernel, new kernel, new kernel, first kernel): "
                  + in_turns(lambda: simt(r8, pack),
                             lambda: fn(r8, pack, sub), 10) + " ms")
    return out


def check_slice17(torch, scenes, cam, cam_rays, inputs):
    """K1's and K14's start, and K3b as redesigned for the H100.

    K1 (its kernel, first kernel and counting entry) and K14 (the same
    three) on tests/sub_cull_mirror.py's batches whose rays accept row 0
    above BIG: torch.equal to minarg_plain and minarg_fused_plain, the
    reference's argmin (csrc/argmin_start.cuh).

    K3b walks groups of at most eight spheres (`sphere_groups`, Morton
    order) and skips per ray each whose box, widened by the sphere margin
    (csrc/sphere_table.cu), its segment to its running best misses; it
    runs the sqrt only where some lane of the warp has disc > 0. It is held
    torch.equal to its plain version, its first kernel
    (`sphere_table_simt`) and its counting entry on the 1080p many-lights
    camera and first-bounce rays and the stress-analytic camera rays, with
    the groups entered, the pairs computing disc and those reaching the
    sqrt per ray printed; on 300 random spheres (38 groups) and
    tests/sphere_cull_mirror.py's crafted batch at 1080p (grazing rays,
    tangents on box faces, origins inside spheres, exact-t ties across
    groups, radii 1e-3 to 1e4). Then timed in turns against its first
    kernel, five readings each. Returns the inputs and counts of the kernels line's K3b rows."""
    import numpy as np
    from opencl_path_tracer_tpu_torch.core.spheres import SpheresSoA
    from opencl_path_tracer_tpu_torch.ops.kernels import (
        cluster_kernel as ck, intersect_kernel as k1, plucker_kernel as k2,
        sphere_kernel as k3)
    from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from sphere_cull_mirror import KINDS, crafted_rays, crafted_spheres
    from sub_cull_mirror import ABOVE_BIG_CASES, crafted_dense

    def same(a, b):
        return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                   for x, y in zip(a, b))

    tris = scenes["cornell"].tris
    n_above = 0
    for n_rows, n_deg in ABOVE_BIG_CASES:
        pack, r8 = crafted_dense(tris, n_rows, n_deg)
        pack, r8 = pack.cuda(), torch.as_tensor(r8).cuda()
        sub = ck.sub_boxes(pack, [(0, n_rows)])
        where = f"the crafted batch of {n_rows} rows ({n_deg} accepted " \
            "above BIG)"
        want = k1.minarg_plain(r8, pack)
        for name, got in (("minarg", k1.minarg(r8, pack)),
                          ("minarg_simt", k1.minarg_simt(r8, pack)),
                          ("minarg's counting entry",
                           k1.minarg_counted(r8, pack)[0])):
            need(same(got, want), f"{name} differs from minarg_plain on "
                 f"{where}")
        t, ok = k1.exact_test(pack, r8)
        above = ok[0] & (t[0] > k1.BIG) & (want[0] == k1.BIG)
        need(bool((want[1][above] == n_deg).all()),
             f"minarg_plain misses at a row other than {n_deg} on {where}")
        n_above += int(above.sum())
        want = k2.minarg_fused_plain(r8, pack)
        for name, got in (("minarg_fused", k2.minarg_fused(r8, pack, sub)),
                          ("minarg_fused_simt",
                           k2.minarg_fused_simt(r8, pack)),
                          ("minarg_fused's counting entry",
                           k2.minarg_fused_counted(r8, pack, sub)[0])):
            need(same(got, want), f"{name} differs from minarg_fused_plain "
                 f"on {where}")
    print(f"the reference's start: on {len(ABOVE_BIG_CASES)} crafted batches "
          f"({n_above} rays accept row 0 above BIG and miss at the first row "
          "that does not accept) minarg, minarg_simt, minarg_count, "
          "minarg_fused, minarg_fused_simt and minarg_fused_count equal to "
          "minarg_plain and minarg_fused_plain (torch.equal on the bits)")

    many = k3.build_sphere_table(scenes["many-lights"].spheres)
    cam8 = k1.pack_rays(cam_rays.p, cam_rays.d).contiguous()
    bounce = bounce_rays(torch, scenes["many-lights"], cam, cam_rays,
                         make_intersect_fn(scenes["many-lights"], "auto"))
    c, r, m = crafted_spheres()
    rs = np.random.default_rng(17)
    rand = SpheresSoA.build(np.float32(rs.uniform(-200, 1200, (300, 3))),
                            np.float32(rs.uniform(2, 40, 300)),
                            np.int32(np.arange(300) % 9), device="cuda")
    # (the kernels line's row or None, where, table, rays)
    cases = [
        ("sphere_table", "the many-lights camera rays", many, cam8),
        ("sphere_table bounce", "the many-lights first-bounce rays", many,
         k1.pack_rays(bounce.p, bounce.d).contiguous()),
        ("sphere_table stress", "the stress-analytic camera rays",
         k3.build_sphere_table(scenes["stress-analytic"].spheres), cam8),
        (None, "300 random spheres on the many-lights camera rays",
         k3.build_sphere_table(rand), cam8),
        (None, f"the crafted batch ({W * H} lanes of {KINDS} kinds)",
         k3.build_sphere_table(SpheresSoA.build(c, r, m, device="cuda")),
         torch.as_tensor(crafted_rays(c, r, W * H)).cuda())]
    out = {}
    for key, where, table, r8 in cases:
        groups = k3.sphere_groups(table)
        want, plain_ms = timed(torch, lambda: k3.sphere_table_plain(r8,
                                                                    table))
        need(same(k3.sphere_table_simt(r8, table), want),
             f"sphere_table_simt differs from its plain version on {where}")
        need(same(k3.sphere_table(r8, table, groups), want),
             f"sphere_table differs from its plain version on {where}")
        got, counts = k3.sphere_table_counted(r8, table, groups)
        need(same(got, want), "sphere_table's counting entry differs from "
             f"its plain version on {where}")
        made, passed, n_disc, n_sqrt, n_warp = counts
        n, g = r8.shape[1], groups.data.shape[0]
        hits = int((want[0] > 0).sum())
        print(f"sphere_table on {where} ({n} rays, {table.shape[0]} spheres "
              f"in {g} groups): {passed / n:.3f} groups entered per ray "
              f"({n_warp * 32 / n:.3f} per warp), {n_disc / n:.3f} pairs "
              f"computing disc and {n_sqrt / n:.4f} reaching the sqrt per ray "
              f"(the first kernel: {table.shape[0]} each); {hits} hits; equal "
              "to the plain version, the first kernel and the counting entry "
              "(torch.equal on the bits)")
        if key is not None:
            out[key] = (r8, table, groups, plain_ms, counts, hits)
    for key, where, _, _ in cases[:3]:
        r8, table, groups = out[key][:3]
        first = lambda: k3.sphere_table_simt(r8, table)
        new = lambda: k3.sphere_table(r8, table, groups)
        firsts, news = [], []
        for _ in range(5):
            firsts.append(time_ms(torch, first, 20))
            news.append(time_ms(torch, new, 20))
        print(f"sphere_table on {where} in turns (first kernel, new kernel) "
              "x 5: first " + ", ".join(f"{x:.4f}" for x in firsts)
              + "; new " + ", ".join(f"{x:.4f}" for x in news) + " ms")
    return out


def check_goldens(torch, np):
    from opencl_path_tracer_tpu_torch.models import megakernel
    from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
    from opencl_path_tracer_tpu_torch.scene import library
    for fname, kw, bounces in GOLDENS:
        scene = library.cornell_box(device="cuda", **kw)
        cam = library.cornell_camera(16, 16, device="cuda")
        st = megakernel.render(cam, scene.mats,
                               intersect_fn=make_intersect_fn(scene, "auto"),
                               num_pixels=256, iterations=bounces, spp=4,
                               mode="parity", device="cuda")
        img = megakernel.colors_array(st).cpu().numpy().reshape(-1)
        gold = np.load(os.path.join(HERE, "tests", "golden", fname + ".npy"))
        rel = np.abs(img - gold[3:]) / np.maximum(np.abs(gold[3:]), 1e-30)
        ok = np.allclose(img, gold[3:], rtol=1e-4, atol=1e-6)
        print(f"golden {fname}: max rel {rel.max():.3g} "
              f"(rtol 1e-4, atol 1e-6) {'ok' if ok else 'FAILED'}")
        need(ok, f"golden {fname} does not match through the kernels")


def check_no_fallback(torch, scenes):
    """With the kernel loader broken, a CUDA call must raise (K1 and its
    two check-only entries, K13a and its two, K4, K7 and its two, K6 and
    its two, K3b, K8, K9, K10 and its two, K11, K12 and its two, K17 and
    its two, K16 and its two, K18, K18m, K19 and its two, K20 and its two,
    K14 and its two, K15 and its two, K3b's two)."""
    from opencl_path_tracer_tpu_torch.ops.kernels import _build
    from opencl_path_tracer_tpu_torch.ops.kernels import (
        cluster_kernel as ck, flat_march as fm, intersect_kernel as k1,
        lazy_march as lm, march_kernel as mk, pair_mxu as pm,
        plucker_kernel as k2, shading_kernel as k8, sorted_intersect as si,
        sphere_kernel as k3, tilecull_kernel as tk)
    pack = k1.build_tri_pack(scenes["cornell"].tris)
    ppack = k2.build_plucker_packs(scenes["cornell"].tris)[:2]
    smooth = scenes["cornell-smooth"]
    spack = (k1.build_tri_pack(smooth.tris),
             k8.build_shading_pack(smooth.attribs))
    gpack, groups, _ = tk.grouped_pack(scenes["cornell"].tris, 128)
    table = k3.build_sphere_table(scenes["many-lights"].spheres)
    sgroups = k3.sphere_groups(table)
    rays8 = torch.zeros((8, 64), device="cuda")
    msc = mk.build_march_scene(scenes["cornell"].tris, 256)[0]
    mlist = torch.zeros(1, dtype=torch.int32, device="cuda")
    m8 = torch.zeros((8, 128), device="cuda")
    mfeat = torch.zeros((32, 128), dtype=torch.bfloat16, device="cuda")
    flat_args = (torch.zeros(1, dtype=torch.int32, device="cuda"),
                 torch.zeros(1, dtype=torch.int32, device="cuda"), m8, mfeat,
                 mk.miss_rows(128, "cuda"), msc, 256, 128)
    lazy_args = (mlist, m8, mfeat, mk.miss_rows(128, "cuda")[:6].contiguous(),
                 torch.zeros((1, 128), dtype=torch.int32, device="cuda"), msc,
                 256, 1, 128)
    visit_args = (torch.zeros(1024, dtype=torch.int32, device="cuda"),
                  torch.zeros((8, 1024), device="cuda"),
                  torch.zeros((768, 32), dtype=torch.bfloat16, device="cuda"),
                  torch.zeros((256, 24), device="cuda"), 256, 1024, 1)
    vpu_args = (torch.zeros(64, dtype=torch.int32, device="cuda"), rays8,
                torch.zeros((256, 24), device="cuda"), 128)
    vpu_sub = si.pair_sub_boxes(vpu_args[2], 128)
    ones = torch.ones(64, device="cuda")
    gsub = tk.anyhit_sub_boxes(gpack, groups)
    cluster_args = (torch.zeros((256, 8), device="cuda"),
                    torch.zeros((1, 1), dtype=torch.int32, device="cuda"),
                    torch.zeros((1, 1), dtype=torch.int32, device="cuda"),
                    torch.zeros((1, 1), device="cuda"),
                    torch.zeros((128, 24), device="cuda"), 128, 256)
    csub = ck.cluster_sub_boxes(cluster_args[4], 128)
    dsub = ck.sub_boxes(pack, [(0, pack.shape[0])])
    group_args = (torch.zeros(1, dtype=torch.int32, device="cuda"),
                  torch.zeros((2048, 8), device="cuda"),
                  torch.zeros((128, 24), device="cuda"), 128, 2048)
    calls = {
        "minarg": lambda: k1.minarg(rays8, pack),
        "minarg_simt": lambda: k1.minarg_simt(rays8, pack),
        "minarg_count": lambda: k1.minarg_counted(rays8, pack),
        "plucker_cand": lambda: k2.candidates(
            rays8, *ppack, live=scenes["cornell"].tris.count),
        "plucker_cand_simt": lambda: k2.run_candidates_simt(rays8, *ppack),
        "plucker_cand_count": lambda: k2.candidates_counted(
            rays8, *ppack, live=scenes["cornell"].tris.count),
        "dense": lambda: k1.dense(rays8, pack),
        "anyhit": lambda: tk.anyhit(rays8, ones, gpack, groups, gsub),
        "anyhit_simt": lambda: tk.anyhit_simt(rays8, ones, gpack, groups),
        "anyhit_count": lambda: tk.anyhit_counted(rays8, ones, gpack, groups,
                                                  gsub),
        "tilecull": lambda: tk.tilecull(rays8, gpack, groups, gsub),
        "tilecull_simt": lambda: tk.tilecull_simt(rays8, gpack, groups),
        "tilecull_count": lambda: tk.tilecull_counted(rays8, gpack, groups,
                                                      gsub),
        "sphere_table": lambda: k3.sphere_table(rays8, table, sgroups),
        "sphere_table_simt": lambda: k3.sphere_table_simt(rays8, table),
        "sphere_table_count": lambda: k3.sphere_table_counted(rays8, table,
                                                              sgroups),
        "smooth_refine": lambda: k8.smooth_refine(
            rays8, torch.full((64,), k1.BIG, device="cuda"),
            torch.zeros(64, device="cuda"), *spack),
        "pair_cand": lambda: si.run_candidates(
            rays8, torch.zeros((128, 16), device="cuda"), 2, 1),
        "pair_visit": lambda: pm.pair_visits(*visit_args),
        "pair_visit_simt": lambda: pm.pair_visits_simt(*visit_args),
        "pair_visit_count": lambda: pm.pair_visits_counted(*visit_args),
        "pair_visit_full": lambda: pm.pair_visits_full(*visit_args),
        "attr_fetch": lambda: pm.fetch_attrs(
            torch.zeros(64, device="cuda"),
            torch.zeros((256, 24), device="cuda")),
        "pair_vpu": lambda: si.run_pairs(*vpu_args, vpu_sub),
        "pair_vpu_simt": lambda: si.run_pairs_simt(*vpu_args),
        "pair_vpu_count": lambda: si.run_pairs_counted(*vpu_args, vpu_sub),
        "cluster": lambda: ck.run_cluster(*cluster_args, False, csub),
        "cluster_simt": lambda: ck.run_cluster_simt(*cluster_args),
        "cluster_count": lambda: ck.run_cluster_counted(*cluster_args, False,
                                                        csub),
        "group": lambda: si.run_group(*group_args, csub),
        "group_simt": lambda: si.run_group_simt(*group_args),
        "group_count": lambda: si.run_group_counted(*group_args, csub),
        "march": lambda: mk.run_march(mlist, m8, mfeat, msc, 256, 1, 128),
        "materialize": lambda: mk.materialize(mlist, m8, mfeat),
        "flat_march": lambda: fm.run_flat(*flat_args),
        "flat_march_simt": lambda: fm.run_flat_simt(*flat_args),
        "flat_march_count": lambda: fm.run_flat_counted(*flat_args),
        "lazy_march": lambda: lm.run_lazy_march(*lazy_args),
        "lazy_march_simt": lambda: lm.run_lazy_march_simt(*lazy_args),
        "lazy_march_count": lambda: lm.run_lazy_march_counted(*lazy_args),
        "minarg_fused": lambda: k2.minarg_fused(rays8, pack, dsub),
        "minarg_fused_simt": lambda: k2.minarg_fused_simt(rays8, pack),
        "minarg_fused_count": lambda: k2.minarg_fused_counted(rays8, pack,
                                                              dsub),
        "mxu": lambda: k1.mxu(rays8, pack, dsub),
        "mxu_simt": lambda: k1.mxu_simt(rays8, pack),
        "mxu_count": lambda: k1.mxu_counted(rays8, pack, dsub),
    }
    real = _build.library

    def broken(name):
        raise RuntimeError("kernel loader disabled by chip_smoke")

    _build.library = broken
    try:
        for name, fn in calls.items():
            try:
                fn()
            except RuntimeError:
                continue
            raise SmokeError(f"{name} ran on CUDA with its kernel loader "
                             "broken")
    finally:
        _build.library = real
    print(f"no fallback: with the loader broken, {', '.join(calls)} raise")
    # K10's full form on CUDA tensors launches and never runs its plain
    # versions.
    from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
    real_plain = pm.pair_visits_full_plain, pm.pair_visits_plain

    def plain_called(*a, **k):
        raise SmokeError("pair_visits_full ran a plain version on CUDA")

    pm.pair_visits_full_plain = pm.pair_visits_plain = plain_called
    try:
        before = _build.launches["pair_visit_full"]
        pm.pair_visits_full(*visit_args)
        torch.cuda.synchronize()
        need(_build.launches["pair_visit_full"] == before + 1,
             "pair_visits_full did not launch its kernel")
    finally:
        pm.pair_visits_full_plain, pm.pair_visits_plain = real_plain
    refused = []
    for accel in ("bvh", "median"):
        try:
            make_intersect_fn(scenes["cornell"], accel)
        except ValueError as e:
            refused.append(f"{accel}: {e}")
            continue
        raise SmokeError(f"accel {accel!r} ran on CUDA without force")
    print("no fallback: pair_visits_full on CUDA tensors launched its kernel "
          "once and no plain version; without force " + "; ".join(refused))
    no_fallback_front_end(torch, scenes)


def no_fallback_front_end(torch, scenes):
    """The front end's paths launch their kernels on CUDA and run no plain
    version there (`plain_guard`): a one-pose turntable ('auto', NEE) at
    320x180 and the viewer's double-buffered fetch, whose host buffer is
    pinned and whose frame equals display_u8()."""
    import numpy as np
    from opencl_path_tracer_tpu_torch.config import CameraConfig, RenderConfig
    from opencl_path_tracer_tpu_torch.ops.kernels import _build
    from opencl_path_tracer_tpu_torch.runtime import anim
    from opencl_path_tracer_tpu_torch.runtime.engine import RenderEngine
    from opencl_path_tracer_tpu_torch.runtime.viewer import ViewerServer
    small = RenderConfig(width=320, height=180, iterations=BOUNCES,
                         mode="fast", nee=True, camera=CameraConfig(
                             fov=60.0, yaw=0.0, pitch=0.0,
                             shift=(0.0, 0.0, 0.0)))
    before = dict(_build.launches)
    with plain_guard():
        eng = RenderEngine(scenes["cornell"], small, device="cuda")
        anim.render_animation(eng, anim.turntable_poses(frames=1, **ORBIT),
                              spp=1, progress=False)
        v = ViewerServer(eng, port=0)
        eng.frame(sync=False)
        fetch = v._fetch(eng.display_u8_device())
        u8 = v._finish(fetch)
        torch.cuda.synchronize()
    rose = {k: _build.launches[k] - before[k] for k in _build.launches
            if _build.launches[k] > before[k]}
    need(set(path_kernels("megakernel cornell nee anim",
                          eng.intersect_fn.accel)) <= set(rose),
         f"no fallback: the front end launched only {rose}")
    need(fetch[1].is_pinned() and fetch[2] is not None
         and np.array_equal(u8, eng.display_u8()),
         "no fallback: the viewer's fetch is not a pinned copy of the frame")
    print(f"no fallback: render_animation and the viewer's fetch at 320x180 "
          f"launched {rose} and no plain version on CUDA; the fetch went "
          "through pinned memory behind an event")


def path_kernels(name, accels=None):
    """PATH_KERNELS[name] for a path whose triangles went through `accels`
    (an accel or a tuple of them; None: as listed): where 'auto' resolved
    to 'tilecull' (the predictor's pick on the card), K6 and K2 take the
    place of K1, and K2 (after K6's ids) that of K8."""
    if not isinstance(accels, tuple):
        accels = (accels,)
    swap = {"minarg": ("tilecull", "refine1"), "smooth_refine": ("refine1",)}
    out = []
    for accel in accels:
        for k in PATH_KERNELS[name]:
            out += swap.get(k, (k,)) if accel == "tilecull" else (k,)
    return tuple(dict.fromkeys(out))


def run_path(torch, name, fn, accel=None):
    """Drive one main path with the launch counts reset just before and
    read just after; every kernel of the path must have launched.
    accel: the accel the path's 'auto' resolved to (`path_kernels`)."""
    from opencl_path_tracer_tpu_torch.ops.kernels import _build
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(_build.launches)
    missing = [k for k in path_kernels(name, accel) if counts[k] == 0]
    need(not missing, f"main path {name} did not launch {missing}")
    extra = [k for k in PATH_EXCLUDES.get(name, ()) + CHECK_ONLY
             if counts[k]]
    need(not extra, f"main path {name} launched {extra}")
    return result, dt, {k: v for k, v in counts.items() if v}


def march_stats_line(name, c):
    """One line of the march or flat intersector's schedule over a run's
    calls (the recorder's counters c): the lanes resolved after round 1
    (and, for 'march', round 2), the dense tail's iterations and lanes,
    and the pending lanes."""
    k = "march" if c["march.calls"] else "flat"
    lanes = c[f"{k}.lanes"]
    line = (f"{name}: {c[f'{k}.calls']} intersector calls, {lanes} lanes; "
            f"round 1 resolved {c[f'{k}.round1_resolved'] / lanes:.4f}")
    if k == "march":
        line += f", after round 2 {c['march.round2_resolved'] / lanes:.4f}"
    else:
        line += (f" ({c['flat.visits']} visits, {c['flat.overflow_blocks']} "
                 "blocks over the list's capacity)")
    print(f"{line}; tail {c[f'{k}.tail_iterations']} iterations over "
          f"{c[f'{k}.tail_lanes']} lanes; pending "
          f"{c[f'{k}.pending'] / lanes:.5f}")


def lazy_path(torch, scene, cam, report):
    """'lazy stress': the lazy pipeline as `bench.py --model lazy` builds
    it (cs 512, tr 256, K 4, tail 4096, fast mode, key 1) at 1920x1080, 2
    warm-up steps, then LAZY_STEPS timed ones. Reports segment
    completions per second (certified lanes, as bench.py counts them) and
    samples per second (per-pixel samples finished in the timed steps)."""
    from opencl_path_tracer_tpu_torch.models import lazy
    from opencl_path_tracer_tpu_torch.ops import rng
    key = rng.key(1)
    step, init, _ = lazy.make_lazy_pipeline(scene.tris, cs=512, tr=256, K=4,
                                            tail=4096)
    box = {}

    def run():
        st = init(cam, W * H, mode="fast", key=key)
        for _ in range(2):
            st = step(cam, scene.mats, st, iterations=BOUNCES, mode="fast",
                      key=key)
        c0, s0 = int(st.completions), int(st.samples.sum())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LAZY_STEPS):
            st = step(cam, scene.mats, st, iterations=BOUNCES, mode="fast",
                      key=key)
        torch.cuda.synchronize()
        box["dt"] = time.perf_counter() - t0
        box["segs"] = int(st.completions) - c0
        box["spp"] = (int(st.samples.sum()) - s0) / (W * H)
        box["st"] = st

    torch.cuda.reset_peak_memory_stats()
    _, _, counts = run_path(torch, "lazy stress", run)
    st, dt = box["st"], box["dt"]
    cols = torch.stack(st.colors)
    need(bool(torch.isfinite(cols).all()) and float(cols.mean()) > 0.0
         and box["spp"] > 0.0, "lazy stress: bad state")
    print(f"lazy stress: {LAZY_STEPS} timed steps in {dt:.3f} s: "
          f"{box['segs']} segment completions ({box['segs'] / LAZY_STEPS / (W * H):.4f} "
          f"of the lanes certified per step), "
          f"{box['segs'] / dt / 1e6:.1f} M completions/s; "
          f"{box['spp']:.4f} spp finished, mean samples "
          f"{float(st.samples.float().mean()):.3f}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    report("lazy stress", dt, box["segs"], box["spp"], counts)


def main_path(torch, np, scenes, cam):
    from opencl_path_tracer_tpu_torch.config import CameraConfig, RenderConfig
    from opencl_path_tracer_tpu_torch.models import pipeline
    from opencl_path_tracer_tpu_torch.ops import rng
    from opencl_path_tracer_tpu_torch.ops.kernels import march_kernel as mk
    from opencl_path_tracer_tpu_torch.ops.kernels import sorted_intersect as si
    from opencl_path_tracer_tpu_torch.ops.kernels.intersect_kernel import (
        make_mxu_intersect)
    from opencl_path_tracer_tpu_torch.ops.kernels.plucker_kernel import (
        make_minarg_intersect)
    from opencl_path_tracer_tpu_torch.runtime.engine import RenderEngine
    total = {name: 0 for name in KERNEL_META}

    def cfg(camera=None, spp=SPP, **kw):
        """The Cornell camera preset unless `camera` is given (the
        reference scenes take the config's default, the reference's own
        camera)."""
        return RenderConfig(width=W, height=H, iterations=BOUNCES, spp=spp,
                            camera=camera or CameraConfig(
                                fov=60.0, yaw=0.0, pitch=0.0,
                                shift=(0.0, 0.0, 0.0)), **kw)

    def report(name, dt, rays, spp, counts):
        for k, v in counts.items():
            total[k] += v
        print(f"main path {name}: {W}x{H}, {BOUNCES} bounces, {spp:.2f} spp "
              f"in {dt:.3f} s: {rays / dt / 1e6:.1f} Mrays/s, "
              f"{spp / dt:.2f} samples/s; launches {counts}")

    engines = [(f"megakernel {n}", RenderEngine(scenes[n], cfg(),
                                                device="cuda"))
               for n in ("cornell", "cornell-analytic")]
    engines.append(("wavefront cornell-analytic", RenderEngine(
        scenes["cornell-analytic"], cfg(model="wavefront"), device="cuda")))
    engines.append(("megakernel cornell nee", RenderEngine(
        scenes["cornell"], cfg(nee=True), device="cuda")))
    engines.append(("wavefront cornell-sphere-lamp nee", RenderEngine(
        scenes["cornell-sphere-lamp"], cfg(model="wavefront", nee=True),
        device="cuda")))
    engines.append(("wavefront many-lights nee-distance", RenderEngine(
        scenes["many-lights"], cfg(model="wavefront", nee=True,
                                   nee_select="distance"), device="cuda")))
    engines.append(("megakernel cornell tilecull", RenderEngine(
        scenes["cornell"], cfg(accel="tilecull"), device="cuda")))
    engines.append(("megakernel reference smooth", RenderEngine(
        scenes["reference"], cfg(camera=CameraConfig(), smooth=True),
        device="cuda")))
    engines.append(("wavefront reference-analytic smooth nee", RenderEngine(
        scenes["reference-analytic"],
        cfg(camera=CameraConfig(), model="wavefront", smooth=True, nee=True),
        device="cuda")))
    engines.append(("megakernel cornell smooth", RenderEngine(
        scenes["cornell-smooth"], cfg(smooth=True), device="cuda")))
    # K1 + K2 and K1 + K8 by name: 'auto' on the card may route the rows
    # above through K6.
    engines.append(("megakernel cornell minarg", RenderEngine(
        scenes["cornell"], cfg(accel="minarg"), device="cuda")))
    engines.append(("megakernel reference smooth minarg", RenderEngine(
        scenes["reference"], cfg(camera=CameraConfig(), smooth=True,
                                 accel="minarg"), device="cuda")))
    # The stress scene through 'auto' (99,380 triangles: 'pairwin'); the
    # Cornell preset, and the reference's camera for stress-analytic, as
    # `ptx-torch render` (and JAX's `ptx render`) choose them.
    stress = [("megakernel stress", "stress", cfg(spp=STRESS_SPP)),
              ("wavefront stress", "stress",
               cfg(spp=STRESS_SPP, model="wavefront")),
              ("megakernel stress smooth", "stress-smooth",
               cfg(spp=STRESS_SPP, smooth=True)),
              ("megakernel stress-analytic", "stress-analytic",
               cfg(spp=STRESS_SPP, camera=CameraConfig()))]
    for name, sname, c in stress:
        engines.append((name, RenderEngine(scenes[sname], c, device="cuda")))
    # The cluster-pack accels: 'pair' (K12) and 'cluster' (K17) on the
    # stress scene, 'group' (K16) on the reference scene from its own
    # camera and on the Cornell box.
    packs = [("megakernel stress pair", "stress",
              cfg(spp=STRESS_SPP, accel="pair")),
             ("megakernel stress cluster", "stress",
              cfg(spp=CLUSTER_SPP, accel="cluster")),
             ("megakernel reference group", "reference",
              cfg(camera=CameraConfig(), accel="group")),
             ("megakernel cornell group", "cornell", cfg(accel="group")),
             # The march family: 'march' (K18m + K18 rounds 1 and 2, K4
             # tail) and 'flat' (K18 round 0, K19, K4 tail).
             ("megakernel stress march", "stress",
              cfg(spp=STRESS_SPP, accel="march")),
             ("megakernel stress flat", "stress",
              cfg(spp=STRESS_SPP, accel="flat"))]
    for name, sname, c in packs:
        engines.append((name, RenderEngine(scenes[sname], c, device="cuda")))
    # The two intersectors that neither package names as an accel, injected
    # into the megakernel model (RenderEngine's intersect_fn, the loop of
    # `megakernel.render`): K14 (804 triangles, one tt block) and K15.
    corn = scenes["cornell"]
    for name, isect in (
            ("megakernel cornell minarg-fused",
             make_minarg_intersect(corn.tris, fuse_fetch=True)),
            ("megakernel cornell mxu", make_mxu_intersect(corn.tris))):
        engines.append((name, RenderEngine(corn, cfg(), intersect_fn=isect,
                                           device="cuda")))
    for name, eng in engines:
        spp = eng.cfg.spp
        accel = getattr(eng.intersect_fn, "accel", None)
        torch.cuda.reset_peak_memory_stats()
        _, dt, counts = run_path(torch, name,
                                 lambda: eng.render(spp, progress=False),
                                 accel)
        img = eng.image()
        need(img.shape == (H, W, 3) and np.isfinite(img).all()
             and img.mean() > 0.0, f"{name}: bad image")
        report(f"{name} (accel {accel or 'injected'})", dt, eng.rays_traced,
               spp, counts)
        if name == "megakernel cornell nee":
            need(counts["anyhit"] == spp * (BOUNCES - 1),
                 f"{name} launched anyhit {counts['anyhit']} times, not on "
                 f"each of the first {BOUNCES - 1} bounces of {spp} samples")
        print(f"{name}: peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if counts.get("march"):
            # The march schedule, from as many samples again with the
            # counters on, outside the timed run.
            march_stats_line(name, schedule_counts(
                lambda: eng.render(spp, progress=False)))
        if counts.get("pair_cand"):
            # The schedule, from as many samples again with the counters
            # on, outside the timed run: they read counts back per call.
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stats = schedule_counts(lambda: eng.render(spp, progress=False))
            torch.cuda.synchronize()
            dt_stats = time.perf_counter() - t0
            pair_stats_line(name, stats)
            print(f"{name}: {spp} spp with the schedule counters on in "
                  f"{dt_stats:.3f} s ({dt:.3f} s timed, counters off)")

    # render_fast times the steps after its two warm-up steps and counts
    # the samples finished in them.
    (st, secs, timed), _, counts = run_path(
        torch, "fused cornell", lambda: pipeline.render_fast(
            scenes["cornell"], cam, width=W, height=H, iterations=BOUNCES,
            steps=FUSED_STEPS, key=rng.key(1), device="cuda"))
    spp = float(st.samples.sum()) / (W * H)
    cols = torch.stack(st.colors)
    # A lane stalls while PENDING until the rotating exact slice reaches
    # it (up to n_slices steps), so a few lanes may not have finished a
    # sample yet; most must have.
    done = float((st.samples > 0).float().mean())
    need(bool(torch.isfinite(cols).all()) and float(cols.mean()) > 0.0
         and spp >= 1.0 and done > 0.999,
         f"fused cornell: bad state (finite colors "
         f"{bool(torch.isfinite(cols).all())}, mean {float(cols.mean())}, "
         f"{spp} spp, {done} of the lanes with a sample)")
    print(f"fused cornell: {spp:.4f} spp after all {FUSED_STEPS + 2} steps, "
          f"{timed / (W * H):.4f} of them in the {FUSED_STEPS} timed steps; "
          f"min samples {int(st.samples.min())}, "
          f"{int((st.samples == 0).sum())} lanes without a finished sample")
    report("fused cornell", secs, st.lanes * FUSED_STEPS, timed / (W * H),
           counts)
    lazy_path(torch, scenes["stress"], cam, report)
    return total


def by_pixel(torch, st):
    """(colors (N, 3), samples (N,)) of a wavefront state by pixel id."""
    from opencl_path_tracer_tpu_torch.models import wavefront
    samples = torch.zeros_like(st.samples)
    samples[st.pixel.long()] = st.samples
    return wavefront.colors_by_pixel(st, W * H), samples


def check_resume(torch, name, make, first, split, path, launches):
    """`first` samples, save, load into a new engine, `split` more: equal
    (torch.equal) to an unbroken engine that renders first + split in
    one call, or `first` then `split` in two (split=(a, b))."""
    unbroken = make()
    for spp in split:
        unbroken.render(spp, progress=False)
    eng = make()
    eng.render(first, progress=False)
    t0 = time.perf_counter()
    eng.save(path)
    t_save = time.perf_counter() - t0
    size = os.path.getsize(path)
    resumed = make()
    t0 = time.perf_counter()
    resumed.load(path)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    need(resumed.state.rng_state.device.type == "cuda",
         f"{name}: the checkpoint did not load onto the card")
    _, dt, counts = run_path(torch, name,
                             lambda: resumed.render(sum(split) - first,
                                                    progress=False),
                             resumed.intersect_fn.accel)
    for k, v in counts.items():
        launches[k] += v
    a, b = resumed.state, unbroken.state
    same = (all(torch.equal(x, y) for x, y in zip(a.colors, b.colors))
            and torch.equal(a.rng_state, b.rng_state))
    if resumed.cfg.model == "wavefront":
        same = (same and torch.equal(a.samples, b.samples)
                and torch.equal(a.lum_m2, b.lum_m2) and a.step == b.step)
    else:
        same = same and a.sample == b.sample
    need(same, f"{name}: the resumed render differs from the unbroken one")
    print(f"{name}: {W}x{H}, {BOUNCES} bounces, parity; {first} spp, save, "
          f"load, {sum(split) - first} spp equal to the unbroken render "
          f"{' + '.join(map(str, split))} spp (torch.equal: colors, Lehmer "
          f"states{', samples, M2, step' if resumed.cfg.model == 'wavefront' else ', sample'}); "
          f"checkpoint {size / 2**20:.1f} MiB, save {t_save:.2f} s, load "
          f"{t_load:.2f} s; resumed {sum(split) - first} spp in {dt:.3f} s; "
          f"launches {counts}")
    os.remove(path)


def check_slice18(torch, scenes, launches):
    """Resume and adaptive sampling at 1920x1080 (the module docstring).
    Adds each path's launches to `launches`."""
    from opencl_path_tracer_tpu_torch.config import CameraConfig, RenderConfig
    from opencl_path_tracer_tpu_torch.models import wavefront
    from opencl_path_tracer_tpu_torch.ops.kernels import (
        intersect_kernel as k1, plucker_kernel as k2, sphere_kernel as k3,
        tilecull_kernel as tk)
    from opencl_path_tracer_tpu_torch.runtime import engine as engine_mod
    from opencl_path_tracer_tpu_torch.runtime.engine import RenderEngine

    def cfg(**kw):
        return RenderConfig(width=W, height=H, iterations=BOUNCES,
                            mode="parity", camera=CameraConfig(
                                fov=60.0, yaw=0.0, pitch=0.0,
                                shift=(0.0, 0.0, 0.0)), **kw)

    lamp = scenes["cornell-sphere-lamp"]
    with tempfile.TemporaryDirectory() as tmp:
        check_resume(torch, "megakernel cornell resume",
                     lambda: RenderEngine(scenes["cornell"], cfg(),
                                          device="cuda"),
                     2, (4,), os.path.join(tmp, "mk.npz"), launches)
        check_resume(torch, "wavefront cornell-sphere-lamp nee resume",
                     lambda: RenderEngine(lamp, cfg(model="wavefront",
                                                    nee=True),
                                          device="cuda"),
                     2, (2, 2), os.path.join(tmp, "wf.npz"), launches)

    # The adaptive main path, with the rays of the first intersect and
    # shadow-ray call at each lane count kept for the kernel checks.
    eng = RenderEngine(lamp, cfg(model="wavefront", nee=True), device="cuda")
    seen, shadows = {}, {}
    isect, occluded = eng.intersect_fn, eng.occluded

    def keep_isect(rays):
        seen.setdefault(rays.count, (rays.p, rays.d))
        return isect(rays)

    def keep_occluded(rays, rmax):
        shadows.setdefault(rays.count, (rays.p, rays.d, rmax))
        return occluded(rays, rmax)

    eng.intersect_fn, eng.occluded = keep_isect, keep_occluded
    name = "wavefront cornell-sphere-lamp nee adaptive"
    _, dt, counts = run_path(torch, name, lambda: eng.render_adaptive(
        ADAPTIVE_TOL, ADAPTIVE_MAX_SPP, ADAPTIVE_MIN_SPP, progress=False))
    for k, v in counts.items():
        launches[k] += v
    cols, smp = by_pixel(torch, eng.state)
    done = wavefront.converged_mask(eng.state.samples, eng.state.colors,
                                    eng.state.lum_m2, ADAPTIVE_TOL,
                                    ADAPTIVE_MIN_SPP)
    below = eng.state.samples < ADAPTIVE_MAX_SPP
    buckets = eng.adaptive_buckets
    need(bool(torch.isfinite(cols).all()) and float(cols.mean()) > 0,
         f"{name}: bad colors")
    need(int(smp.min()) >= ADAPTIVE_MIN_SPP
         and int(smp.max()) <= ADAPTIVE_MAX_SPP,
         f"{name}: samples {int(smp.min())}..{int(smp.max())} outside "
         f"[{ADAPTIVE_MIN_SPP}, {ADAPTIVE_MAX_SPP}]")
    need(bool(done[below].all()),
         f"{name}: {int((below & ~done).sum())} pixels stopped below the "
         "cap without meeting the stop rule")
    need(min(buckets) < W * H, f"{name}: never compacted ({buckets})")
    ladder = [(b, buckets.count(b)) for b in dict.fromkeys(buckets)]
    mean_spp = float(smp.float().mean())
    print(f"main path {name}: {W}x{H}, {BOUNCES} bounces, parity, tol "
          f"{ADAPTIVE_TOL}, spp min {int(smp.min())} / mean {mean_spp:.2f} "
          f"/ max {int(smp.max())} in {dt:.3f} s: "
          f"{eng.rays_traced / dt / 1e6:.1f} Mrays/s, "
          f"{mean_spp / dt:.2f} samples/s; {eng.steps_run} steps; buckets "
          f"(lanes, checks) {ladder}; launches {counts}")
    fixed = RenderEngine(lamp, cfg(model="wavefront", nee=True),
                         device="cuda")
    _, fdt, _ = run_path(torch, "wavefront cornell-sphere-lamp nee",
                         lambda: fixed.render(ADAPTIVE_MAX_SPP,
                                              progress=False))
    print(f"{name}: against the fixed {ADAPTIVE_MAX_SPP}-spp render of the "
          f"same engine configuration, {fdt:.3f} s: "
          f"{fixed.rays_traced / fdt / 1e6:.1f} Mrays/s, "
          f"{ADAPTIVE_MAX_SPP / fdt:.2f} samples/s; wall {dt / fdt:.3f}x")

    # Compaction on (the engine) and off (the model's render_adaptive with
    # compact=False, on the engine's camera and intersector) give the same
    # bits in parity mode without NEE. The rays of the engine's first
    # intersect call at each lane count are kept too.
    name = "wavefront cornell-sphere-lamp adaptive"
    e = RenderEngine(lamp, cfg(model="wavefront"), device="cuda")
    isect = e.intersect_fn
    e.intersect_fn = keep_isect
    _, dta, counts = run_path(torch, name, lambda: e.render_adaptive(
        ADAPTIVE_TOL, ADAPTIVE_MAX_SPP, ADAPTIVE_MIN_SPP, progress=False))
    for k, v in counts.items():
        launches[k] += v
    ca, sa = by_pixel(torch, e.state)
    ba = e.adaptive_buckets
    off, dtb = timed(torch, lambda: wavefront.render_adaptive(
        e.camera, lamp.mats, intersect_fn=isect, num_pixels=W * H,
        iterations=BOUNCES, tol=ADAPTIVE_TOL, max_spp=ADAPTIVE_MAX_SPP,
        min_spp=ADAPTIVE_MIN_SPP, mode="parity", compact=False,
        device="cuda"))
    cb, sb = by_pixel(torch, off)
    dtb /= 1e3
    need(min(ba) < W * H, f"{name}: never compacted ({ba})")
    need(torch.equal(ca, cb) and torch.equal(sa, sb),
         f"{name}: compaction on differs from compaction off")
    print(f"main path {name}: parity, spp min {int(sa.min())} / mean "
          f"{float(sa.float().mean()):.2f} / max {int(sa.max())}; compaction "
          f"on ({dta:.3f} s, buckets {sorted(set(ba), reverse=True)}) equal "
          f"to compaction off ({dtb:.3f} s): colors and samples by pixel "
          "(torch.equal)")

    # K1, K2, K3 and K7 at every bucket size of the 1080p ladder: on the
    # rays the two adaptive renders gave them at the sizes they stepped,
    # on prefixes of their first full-frame rays at the others.
    ladder = [W * H]
    while (t := wavefront.compact_target(ladder[-1], ladder[-1] // 2,
                                         engine_mod.ADAPTIVE_MIN_BUCKET)
           ) < ladder[-1]:
        ladder.append(t)
    pack = k1.build_tri_pack(lamp.tris)
    table = k3.build_sphere_table(lamp.spheres)
    gpack, groups, _ = tk.grouped_pack(lamp.tris, 128)
    sub = tk.anyhit_sub_boxes(gpack, groups)
    for n in ladder:
        p_, d_ = seen.get(n, seen[W * H])
        r8 = k1.pack_rays(tuple(c[:n] for c in p_),
                          tuple(c[:n] for c in d_)).contiguous()
        t, g = k1.minarg(r8, pack)
        sp_, sd_, rmax = shadows.get(n, shadows[W * H])
        s8 = k1.pack_rays(tuple(c[:n] for c in sp_),
                          tuple(c[:n] for c in sd_)).contiguous()
        for got, plain, kname in (
                ((t, g), k1.minarg_plain(r8, pack), "minarg"),
                (k2.refine1(t, g, pack), k2.refine1_plain(t, g, pack),
                 "refine1"),
                (k3.spheres(r8, table), k3.spheres_plain(r8, table),
                 "spheres"),
                ((tk.anyhit(s8, rmax[:n], gpack, groups, sub),),
                 (tk.anyhit_plain(s8, rmax[:n], gpack, groups,
                                  ANYHIT_PLAIN_CHUNK),), "anyhit")):
            need(all(torch.equal(a, b) for a, b in zip(got, plain)),
                 f"{kname} differs from its plain version on {n} lanes")
    print(f"adaptive buckets: minarg, refine1, spheres and anyhit equal to "
          f"their plain versions (torch.equal) at every size of the ladder "
          f"{ladder} (stepped: rays {sorted(seen, reverse=True)}, shadow "
          f"rays {sorted(shadows, reverse=True)})")


def check_slice19(torch, np, scenes):
    """The engine's interactive frames, the environment and depth of field
    at 1920x1080, 5 bounces, fast mode (the module docstring), with the
    counts reset before and read after each path. Returns (the launches
    of these paths, the kernels line's input for K7 on the escape rays)."""
    import io
    from opencl_path_tracer_tpu_torch.config import CameraConfig, RenderConfig
    from opencl_path_tracer_tpu_torch.models import megakernel, wavefront
    from opencl_path_tracer_tpu_torch.ops import envmap
    from opencl_path_tracer_tpu_torch.ops.kernels import (
        intersect_kernel as k1, tilecull_kernel as tk)
    from opencl_path_tracer_tpu_torch.runtime.engine import RenderEngine
    from opencl_path_tracer_tpu_torch.runtime.meter import PerfMeter
    launches = {}
    preset = dict(fov=60.0, yaw=0.0, pitch=0.0, shift=(0.0, 0.0, 0.0))

    def cfg(camera=None, **kw):
        return RenderConfig(width=W, height=H, iterations=BOUNCES,
                            mode="fast",
                            camera=camera or CameraConfig(**preset), **kw)

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    def image_ok(name, eng):
        img = eng.image()
        need(img.shape == (H, W, 3) and np.isfinite(img).all()
             and img.mean() > 0.0, f"{name}: bad image")
        return img

    # The interactive loop: FRAMES frames, then 'w' held for FRAMES_MOVE
    # frames, released, and FRAMES_AFTER more; real time off ('r'), so
    # frame() syncs every third sample.
    name = "megakernel cornell frame"
    corn = scenes["cornell"]
    eng = RenderEngine(corn, cfg(), device="cuda")
    buf = io.StringIO()
    eng.meter = PerfMeter(stream=buf)
    eng.controller.key_down("r")
    cam0 = eng.camera
    seen = {}

    def frames():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(FRAMES):
            eng.frame(1 / 60)
        torch.cuda.synchronize()
        seen["dt"] = time.perf_counter() - t0
        seen["rays"] = eng.rays_traced
        seen["idle_camera"] = eng.camera is cam0
        seen["sample"] = eng.state.sample
        eng.controller.key_down("w")
        after = []
        for _ in range(FRAMES_MOVE):
            eng.frame(1 / 60)
            after.append(eng.state.sample)
        eng.controller.key_up("w")
        for _ in range(FRAMES_AFTER):
            eng.frame(1 / 60)
            after.append(eng.state.sample)
        seen["after"] = after

    _, dt, counts = run_path(torch, name, frames, eng.intersect_fn.accel)
    add(counts)
    need(seen["idle_camera"], f"{name}: an idle frame rebuilt the camera")
    need(seen["sample"] == FRAMES
         and seen["after"] == [1] * FRAMES_MOVE + list(
             range(1, FRAMES_AFTER + 1)),
         f"{name}: the sample counter did not restart on the move "
         f"({seen['sample']}, then {seen['after']})")
    image_ok(name, eng)
    shift = tuple(float(v) for v in eng.controller.state.shift)
    fresh = RenderEngine(corn, cfg(camera=CameraConfig(
        **dict(preset, shift=shift))), device="cuda")
    fresh.render(FRAMES_AFTER, progress=False)
    need(torch.equal(megakernel.colors_array(eng.state),
                     megakernel.colors_array(fresh.state)),
         f"{name}: the {FRAMES_AFTER} frames after the reset differ from a "
         "fresh engine's samples at the moved pose")
    meter_line = buf.getvalue().split("\r")[-1]
    print(f"main path {name}: {W}x{H}, {BOUNCES} bounces, fast, real time "
          f"off; {FRAMES} frames in {seen['dt']:.3f} s: "
          f"{FRAMES / seen['dt']:.2f} frames/s, "
          f"{seen['rays'] / seen['dt'] / 1e6:.1f} Mrays/s (the first frame "
          "includes estimated_rays' one instrumented sample); 'w' held "
          f"{FRAMES_MOVE} frames (shift {shift}), released, "
          f"{FRAMES_AFTER} more: samples {seen['after']}; the last "
          f"{FRAMES_AFTER} frames equal to a fresh engine's {FRAMES_AFTER} "
          f"samples at the moved pose (torch.equal); all {dt:.3f} s; "
          f"meter: {meter_line.strip() or 'no line (under 1 s)'}; "
          f"launches {counts}")

    # The environment map's gather: escape rays through K7 at rmax 3.0e38.
    name = "megakernel cornell envmap-sunsky"
    eng = RenderEngine(corn, cfg(env_map="sunsky"), device="cuda")
    occluded, calls = eng.occluded, []

    def keep(rays, rmax):
        out = occluded(rays, rmax)
        if len(calls) < 2:
            calls.append((rays, rmax, out))
        return out

    eng.occluded = keep
    _, dt, counts = run_path(torch, name,
                             lambda: eng.render(ENV_SPP, progress=False),
                             eng.intersect_fn.accel)
    add(counts)
    image_ok(name, eng)
    need(counts["anyhit"] == ENV_SPP * (BOUNCES - 1),
         f"{name} launched anyhit {counts['anyhit']} times, not on each of "
         f"the first {BOUNCES - 1} bounces of {ENV_SPP} samples")
    print(f"main path {name}: {W}x{H}, {BOUNCES} bounces, {ENV_SPP} spp in "
          f"{dt:.3f} s: {eng.rays_traced / dt / 1e6:.1f} Mrays/s, "
          f"{ENV_SPP / dt:.2f} samples/s; launches {counts}")
    pack, groups, _ = tk.grouped_pack(corn.tris, 128)
    sub = tk.anyhit_sub_boxes(pack, groups)
    dpack = k1.build_tri_pack(corn.tris)
    out = {}
    for b, (rays, rmax, flags) in enumerate(calls):
        where = f"the cornell bounce-{b} escape rays"
        need(bool((rmax == envmap.ESCAPE_RMAX).all()),
             f"{where}: rmax is not 3.0e38")
        s8 = k1.pack_rays(rays.p, rays.d).contiguous()
        plain, plain_ms = timed(torch, lambda: tk.anyhit_plain(
            s8, rmax, pack, groups, ANYHIT_PLAIN_CHUNK))
        need(torch.equal(flags, plain),
             f"anyhit differs from its plain version on {where}")
        need(torch.equal(tk.anyhit(s8, rmax, pack, groups, sub), flags),
             f"anyhit differs from the main path's launch on {where}")
        t4, g4 = k1.dense(s8, dpack)[:2]
        strips = strip_hits(torch, corn, dpack, s8, rmax, flags, t4, g4)
        counted, kcounts = tk.anyhit_counted(s8, rmax, pack, groups, sub)
        need(torch.equal(counted, flags),
             f"anyhit's counting entry differs from it on {where}")
        n_div, n_box, n_coop, n_edge, n_made = kcounts
        r = s8.shape[1]
        print(f"anyhit at rmax 3.0e38 on {where} ({r} rays, "
              f"{int(flags.sum())} occluded): equal to its plain version "
              f"({plain_ms:.1f} ms) and to (K4 t valid and t < 3.0e38) but "
              f"for {strips} zero-area strips (torch.equal); "
              f"{n_box / r:.3f} sub-blocks passed per ray, {n_div} tests "
              f"reached the divide, {n_edge} edge tests, {n_made} slab and "
              "box tests")
        if b == 1:
            out["anyhit escape"] = (s8, rmax, pack, groups, sub, kcounts,
                                    plain_ms)

    # The emitter gather and the environment gather in one wavefront step.
    name = "wavefront cornell-sphere-lamp nee envmap-gradient"
    eng = RenderEngine(scenes["cornell-sphere-lamp"],
                       cfg(model="wavefront", nee=True,
                           env_map="gradient"), device="cuda")
    _, dt, counts = run_path(torch, name,
                             lambda: eng.render(ENV_SPP, progress=False))
    add(counts)
    image_ok(name, eng)
    print(f"main path {name}: {W}x{H}, {BOUNCES} bounces, {ENV_SPP} spp "
          f"({eng.steps_run} steps) in {dt:.3f} s: "
          f"{eng.rays_traced / dt / 1e6:.1f} Mrays/s, "
          f"{ENV_SPP / dt:.2f} samples/s; launches {counts}")

    # The dormant sky light (EnvLight) and thin-lens depth of field.
    for name, sname, kw in (
            ("megakernel cornell-analytic env", "cornell-analytic",
             dict(env_light=True)),
            ("megakernel cornell dof", "cornell",
             dict(dof_aperture=DOF[0], dof_focus=DOF[1]))):
        eng = RenderEngine(scenes[sname], cfg(**kw), device="cuda")
        _, dt, counts = run_path(torch, name,
                                 lambda: eng.render(ENV_SPP, progress=False),
                                 eng.intersect_fn.accel)
        add(counts)
        image_ok(name, eng)
        print(f"main path {name}: {W}x{H}, {BOUNCES} bounces, {ENV_SPP} spp "
              f"in {dt:.3f} s: {eng.rays_traced / dt / 1e6:.1f} Mrays/s, "
              f"{ENV_SPP / dt:.2f} samples/s; launches {counts}")
    return launches, out


def check_slice20(torch, np):
    """Image textures, the à-trous denoiser and the 3x3 median at
    1920x1080, 5 bounces, fast mode (the module docstring), with the
    counts reset before and read after each main path. Returns the
    launches of its main paths."""
    import contextlib
    import io
    from opencl_path_tracer_tpu_torch import cli
    from opencl_path_tracer_tpu_torch.config import CameraConfig, RenderConfig
    from opencl_path_tracer_tpu_torch.io.image import read_png
    from opencl_path_tracer_tpu_torch.runtime import engine as engine_mod
    from opencl_path_tracer_tpu_torch.runtime.engine import RenderEngine
    from opencl_path_tracer_tpu_torch.scene import library
    t_phase = time.perf_counter()
    launches = {}
    preset = CameraConfig(fov=60.0, yaw=0.0, pitch=0.0,
                          shift=(0.0, 0.0, 0.0))

    def cfg(**kw):
        return RenderConfig(width=W, height=H, iterations=BOUNCES,
                            mode="fast", camera=preset, **kw)

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    with tempfile.TemporaryDirectory(prefix="ptx-slice20-") as tmp:
        dirs = {n: os.path.join(tmp, n) for n in ("room", "grid")}
        for d in dirs.values():
            os.mkdir(d)
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            room = library.textured_room(dirs["room"], sphere=True,
                                         device="cuda")
            grid = library.textured_room(dirs["grid"], grid=True,
                                         device="cuda")
        need(err.getvalue().count("'missing.png': not found") == 2,
             f"the missing map_Kd did not warn: {err.getvalue()!r}")
        need(room.textures.mat_texi.tolist() == [0, 1, -1, -1]
             and (room.textures.hm, room.textures.wm) == (256, 256)
             and grid.num_triangles == 14 + 2 * library.ROOM_GRID ** 2,
             "the textured rooms did not load as written")
        auto = engine_mod.resolve_accel("auto", grid.num_triangles, True,
                                        True)
        print(f"textured scenes: textured-room {room.num_triangles} "
              f"triangles + 1 analytic sphere, textured-grid "
              f"{grid.num_triangles} triangles ('auto' -> {auto}); atlas "
              f"{room.textures.count} maps padded to "
              f"{room.textures.hm}x{room.textures.wm}; the missing map "
              "warned")
        _slice20_intersectors(torch, room, grid)

        # The renders: a few samples each, against the untextured render.
        renders = {}
        for name, scene, kw in (
                ("megakernel textured-room nee", room, dict(nee=True)),
                ("wavefront textured-room", room, dict(model="wavefront")),
                ("megakernel textured-grid", grid, {})):
            eng = RenderEngine(scene, cfg(textured=True, **kw),
                               device="cuda")
            _, dt, counts = run_path(
                torch, name, lambda: eng.render(TEX_SPP, progress=False),
                eng.intersect_fn.accel)
            add(counts)
            img = eng.image(apply_tonemap=False)
            flat = RenderEngine(scene, cfg(**kw), device="cuda")
            flat.render(TEX_SPP, progress=False)
            need(img.shape == (H, W, 3) and np.isfinite(img).all()
                 and img.mean() > 0.0, f"{name}: bad image")
            diff = float(np.abs(img - flat.image(apply_tonemap=False)).max())
            need(diff > 1e-3, f"{name}: equal to the untextured render")
            renders[name] = eng
            print(f"main path {name}: {W}x{H}, {BOUNCES} bounces, {TEX_SPP} "
                  f"spp in {dt:.3f} s: {eng.rays_traced / dt / 1e6:.1f} "
                  f"Mrays/s, {TEX_SPP / dt:.2f} samples/s; NaN-free, "
                  f"{diff:.4f} at most from the untextured render; "
                  f"launches {counts}")
        _slice20_filters(torch, renders["megakernel textured-room nee"],
                         room, cfg())

        # The CLI on the room's OBJ (the reference's camera, inside it).
        obj = os.path.join(dirs["room"], "room.obj")
        for flag in ("--denoise", "--median"):
            out = os.path.join(tmp, f"cli{flag[1:]}.png")
            err = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(err):
                rc = cli.main(["render", "--scene", obj, "--textured",
                               "--size", f"{W}x{H}", "--spp", str(TEX_SPP),
                               flag, "--out", out])
            dt = time.perf_counter() - t0
            img = read_png(out)
            need(rc == 0 and img.shape == (H, W, 3) and img.max() > 0,
                 f"ptx-torch render --textured {flag} failed")
            need("'missing.png': not found" in err.getvalue(),
                 f"ptx-torch render --textured {flag}: no map warning")
            print(f"ptx-torch render --scene room.obj --textured {flag} "
                  f"--size {W}x{H} --spp {TEX_SPP}: wrote a {W}x{H} PNG in "
                  f"{dt:.2f} s; the missing map warned")
    print(f"check_slice20: {time.perf_counter() - t_phase:.1f} s")
    return launches


def _slice20_intersectors(torch, room, grid):
    """The textured intersector of each accel on 1080p camera rays and the
    first-bounce rays against the plain reference (the module docstring),
    on every lane of the room and every GRID_REF_STRIDE-th lane of the
    grid (the plain reference tests every ray against every triangle)."""
    from opencl_path_tracer_tpu_torch.core.textures import kd_scale
    from opencl_path_tracer_tpu_torch.core.types import Hits, Rays
    from opencl_path_tracer_tpu_torch.ops import intersect
    from opencl_path_tracer_tpu_torch.ops.kernels import (
        intersect_kernel as k1, plucker_kernel as k2)
    from opencl_path_tracer_tpu_torch.ops.shading import interpolate_uvs
    from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
    from opencl_path_tracer_tpu_torch.scene import library
    cam = library.cornell_camera(W, H, device="cuda")
    rays0 = camera_rays(cam)
    for sname, scene, accels, stride in (
            ("textured-room", room, ("minarg", "tilecull", "pairwin"), 1),
            ("textured-grid", grid, ("minarg", "pairwin"), GRID_REF_STRIDE)):
        tex_cpu = scene.textures.to("cpu")
        pack = k1.build_tri_pack(scene.tris)
        first = make_intersect_fn(scene, "minarg", textured=True)
        rays1 = bounce_rays(torch, scene, cam, rays0, first)
        for rname, rays in (("camera", rays0), ("first-bounce", rays1)):
            # The plain reference on the checked lanes.
            lanes = Rays(p=tuple(c[::stride] for c in rays.p),
                         d=tuple(c[::stride] for c in rays.d))
            r8 = k1.pack_rays(lanes.p, lanes.d).contiguous()
            (tp, gp), plain_ms = timed(torch,
                                       lambda: k1.minarg_plain(r8, pack))
            sph = (None if scene.spheres is None
                   else intersect.sphere_intersect(lanes, scene.spheres))
            for accel in accels:
                where = f"textured {accel} on {sname} {rname} rays"
                fn = make_intersect_fn(scene, accel, textured=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                hits, kd = fn(rays)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                hits = Hits(t=hits.t[::stride],
                            p=tuple(c[::stride] for c in hits.p),
                            n=tuple(c[::stride] for c in hits.n),
                            mati=hits.mati[::stride])
                kd = tuple(c[::stride] for c in kd)
                ids = _slice20_winners(torch, k1, scene, accel, rays, stride,
                                       r8, pack, tp, gp, where)
                t1, nx, ny, nz, m = k2.refine1_plain(
                    tp, torch.where(ids >= 0, ids.float(), gp), pack)
                tri = intersect._assemble(lanes, t1, (nx, ny, nz), m)
                ref = tri if sph is None else intersect.merge_hits(tri, sph)
                hit = ref.valid
                need(torch.equal(hits.t, ref.t)
                     and torch.equal(hits.mati, ref.mati)
                     and all(torch.equal(a[hit], b[hit]) for a, b in
                             zip(hits.p + hits.n, ref.p + ref.n)),
                     f"{where}: Hits differ from the plain reference's")
                won = tri.valid & hit & (ref.t == tri.t)
                ids2 = torch.where(won, ids, -1)
                s, t = interpolate_uvs(ref, ids2, scene.attribs)
                ok = hit & (ids2 >= 0)
                want = kd_scale(tex_cpu, ref.mati.cpu(), s.cpu(), t.cpu(),
                                ok.cpu())
                need(all(torch.equal(kd[k].cpu(), want[k])
                         for k in range(3)),
                     f"{where}: kd differs from kd_scale on the CPU")
                bound = ok & (scene.textures.mat_texi[ref.mati.long()] >= 0)
                share = float(bound.float().mean())
                need(rname != "camera" or share > 0.3,
                     f"{where}: {share:.3f} of the rays textured")
                on_sph = int((hit & ~won).sum())
                need(all(bool((kd[k][hit & ~won] == 1.0).all())
                         for k in range(3)),
                     f"{where}: a sphere winner's kd is not 1")
                n_tie = int((ids != torch.where(tp < k1.BIG, gp.int(),
                                                -1)).sum())
                print(f"{where}: Hits and kd equal to the plain reference's "
                      f"on {r8.shape[1]} lanes (torch.equal; {n_tie} "
                      f"exact-t ties won by another triangle); {share:.3f} "
                      f"of them textured, {on_sph} sphere winners at kd 1; "
                      f"{ms:.2f} ms (one call; minarg_plain {plain_ms:.0f} "
                      "ms)")


def _slice20_winners(torch, k1, scene, accel, rays, stride, r8, pack, tp,
                     gp, where):
    """The winners (-1 on a miss) of the accel's ids intersector on all
    of `rays`, taken at every stride-th lane and held there against
    minarg_plain's (t, g) over all triangles: a hit where it hits, and
    its winner g or, on an exact-t tie, a triangle whose own exact test
    passes at the same t."""
    from opencl_path_tracer_tpu_torch.runtime import engine as engine_mod
    _, ids = engine_mod._make_ids_tri_fn(scene, accel, "the smoke")(rays)
    ids = ids[::stride]
    hit = tp < k1.BIG
    need(torch.equal(ids >= 0, hit),
         f"{where}: the ids intersector's hits differ from minarg_plain's")
    other = hit & (ids != gp.int())
    if bool(other.any()):
        rows = pack[ids[other].long()][:, None, :]       # (k, 1, 24)
        rr = r8[:, other].T[:, :, None]                  # (k, 8, 1)
        t_own, valid = k1.exact_test(rows, rr)
        need(bool(valid.all()) and torch.equal(t_own.flatten(), tp[other]),
             f"{where}: {int(other.sum())} winners differ from "
             "minarg_plain's and are not exact-t ties")
    return ids


def _slice20_filters(torch, eng, room, config):
    """The denoise and the median of the megakernel textured render at
    1080p, the card against the CPU on the same colours: the guides
    torch.equal, the filter within DENOISE_RTOL (exp and log1p differ by
    ulps between CUDA's and the CPU's libraries), the median torch.equal."""
    from opencl_path_tracer_tpu_torch.models import megakernel
    from opencl_path_tracer_tpu_torch.ops import denoise
    from opencl_path_tracer_tpu_torch.ops.median_filter import median3x3
    from opencl_path_tracer_tpu_torch.runtime.controller import (
        CameraController)
    from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.denoised_image()
    torch.cuda.synchronize()
    den_s = time.perf_counter() - t0
    colors = megakernel.colors_array(eng.state).reshape(H, W, 3)
    cam = eng.camera
    normal, depth = denoise.primary_aovs(cam, room.mats, eng.intersect_fn,
                                         W, H)
    cpu_scene = room.to("cpu")
    cpu_cam = CameraController(config, device="cpu").camera(W, H)
    t0 = time.perf_counter()
    n_cpu, d_cpu = denoise.primary_aovs(
        cpu_cam, cpu_scene.mats,
        make_intersect_fn(cpu_scene, "minarg", textured=True), W, H)
    aov_cpu_s = time.perf_counter() - t0
    need(torch.equal(normal.cpu(), n_cpu) and torch.equal(depth.cpu(), d_cpu),
         "the denoiser's guides differ between the card and the CPU")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = denoise.atrous_denoise(colors, normal, depth)
    torch.cuda.synchronize()
    filt_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_cpu = denoise.atrous_denoise(colors.cpu(), n_cpu, d_cpu)
    filt_cpu_s = time.perf_counter() - t0
    rel = ((out.cpu() - out_cpu).abs()
           / out_cpu.abs().clamp_min(1e-30)).max().item()
    need(torch.isfinite(out).all().item() and rel <= DENOISE_RTOL,
         f"the denoise on the card differs from the CPU's by {rel:.3g}")
    print(f"denoise at {W}x{H} (megakernel textured-room nee): "
          f"denoised_image {den_s * 1e3:.1f} ms (guides, filter, tonemap, "
          f"host copy), the filter alone {filt_s * 1e3:.1f} ms (CPU "
          f"{filt_cpu_s:.2f} s); guides equal to the CPU's (torch.equal; "
          f"the CPU's plain path {aov_cpu_s:.2f} s), filter within "
          f"{rel:.3g} relative of the CPU's")
    img = torch.as_tensor(eng.image(apply_tonemap=False).copy(),
                          device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    med = median3x3(img)
    torch.cuda.synchronize()
    med_s = time.perf_counter() - t0
    need(torch.equal(med.cpu(), median3x3(img.cpu())),
         "the median on the card differs from the CPU's")
    print(f"median3x3 at {W}x{H}: {med_s * 1e3:.1f} ms, equal to the "
          "CPU's (torch.equal)")


def same_hits(torch, a, b):
    """torch.equal on every field of two Hits."""
    return (torch.equal(a.t, b.t) and torch.equal(a.mati, b.mati)
            and all(torch.equal(x, y) for x, y in zip(a.p, b.p))
            and all(torch.equal(x, y) for x, y in zip(a.n, b.n)))


def in_turns(torch, fns, turns=3, reps=10):
    """{name: [ms of each turn]}: each fn timed by CUDA events over reps
    calls, all of them once a turn, in turns."""
    per = {k: [] for k in fns}
    for _ in range(turns):
        for k, fn in fns.items():
            per[k].append(time_ms(torch, fn, reps))
    return per


def turns_line(per):
    import statistics
    return ", ".join(f"{k} {statistics.median(v):.4f} ms (spread "
                     f"{max(v) - min(v):.4f})" for k, v in per.items())


def check_slice21(torch, np, scenes):
    """The tilecull presort, the auto accel's anchors and re-pick, and
    spectral dispersion at 1920x1080, 5 bounces, fast mode (the module
    docstring), with the counts reset before and read after each main
    path. Returns (the launches of its main paths, the kernels line's
    inputs for K6 on presorted first-bounce rays)."""
    import contextlib
    import io
    from opencl_path_tracer_tpu_torch import cli
    from opencl_path_tracer_tpu_torch.config import CameraConfig, RenderConfig
    from opencl_path_tracer_tpu_torch.io.image import read_png
    from opencl_path_tracer_tpu_torch.runtime.engine import RenderEngine
    t_phase = time.perf_counter()
    launches = {}
    preset = CameraConfig(fov=60.0, yaw=0.0, pitch=0.0,
                          shift=(0.0, 0.0, 0.0))

    def cfg(**kw):
        return RenderConfig(width=W, height=H, iterations=BOUNCES,
                            mode="fast", camera=preset, **kw)

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    inputs = _slice21_presort(torch, np, scenes["cornell"])
    _slice21_auto(torch, scenes["cornell"], cfg, add, RenderEngine)
    _slice21_spectral(torch, scenes["cornell-analytic"], cfg, add)
    with tempfile.TemporaryDirectory(prefix="ptx-slice21-") as tmp:
        out = os.path.join(tmp, "dispersion.png")
        args = ["render", "--scene", "cornell-analytic", "--model",
                "wavefront", "--dispersion", "30", "--nee", "--size",
                f"{W}x{H}", "--spp", str(SPECTRAL_SPP), "--out", out]
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli.main(args)
        dt = time.perf_counter() - t0
        img = read_png(out)
        need(rc == 0 and img.shape == (H, W, 3) and img.max() > 0,
             "ptx-torch render --dispersion 30 failed")
        said = [ln for ln in err.getvalue().splitlines() if "band" in ln]
        print(f"ptx-torch {' '.join(args[:-2])}: wrote a {W}x{H} PNG in "
              f"{dt:.2f} s ({said[-1] if said else 'no band line'})")
        try:
            cli.main(args[:3] + ["--model", "megakernel"] + args[5:])
            refused = None
        except SystemExit as e:
            refused = str(e)
        need(refused == "--dispersion needs --model wavefront",
             f"--dispersion with --model megakernel: {refused!r}")
        print(f"ptx-torch render --dispersion 30 --model megakernel: refused "
              f"({refused})")
    print(f"check_slice21: {time.perf_counter() - t_phase:.1f} s")
    return launches, inputs


def _slice21_presort(torch, np, corn):
    """K6 on presorted cornell camera and first-bounce rays: the
    intersector's Hits (and ids) torch.equal to presort='none''s, the
    kernel's (t, g) on the permuted rays to its plain version's and to
    'none''s permuted; K6, the permutation, the gather and the unpermute
    timed in turns against 'none'."""
    from opencl_path_tracer_tpu_torch.ops.kernels import (
        intersect_kernel as k1, tilecull_kernel as tk)
    from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
    from opencl_path_tracer_tpu_torch.scene import library
    cam = library.cornell_camera(W, H, device="cuda")
    eye = tuple(float(v) for v in cam.eye.cpu())
    rays = camera_rays(cam)
    brays = bounce_rays(torch, corn, cam, rays,
                        make_intersect_fn(corn, "minarg"))
    tris2, _, boxes, spans = tk.build_groups(corn.tris, 128, origin=eye)
    pack, groups = tk._pack_groups(corn.tris, tris2, boxes, spans, 128)
    sub = tk.anyhit_sub_boxes(pack, groups)
    bx = np.asarray(boxes, np.float64)
    blo, bhi = bx[:, 0, :].min(axis=0), bx[:, 1, :].max(axis=0)
    box = (tuple(float(v) for v in blo),
           tuple(float(v) for v in 1.0 / np.maximum(bhi - blo, 1e-12)))
    isect = {p: tk.make_tilecull_intersect(corn.tris, origin=eye, presort=p)
             for p in tk.PRESORTS}
    out = {}

    def unpermute(rows, lane):
        inv = torch.empty_like(lane)
        inv[lane] = torch.arange(lane.shape[0], device=lane.device)
        return rows[:, inv]

    for where, rr in (("camera", rays), ("first-bounce", brays)):
        r8 = k1.pack_rays(rr.p, rr.d)
        t0_, g0_ = tk.tilecull(r8, pack, groups, sub)
        for ids in (False, True):
            ref = tk.make_tilecull_intersect(corn.tris, origin=eye,
                                             with_ids=ids)(rr)
            for presort in ("octant", "morton"):
                got = tk.make_tilecull_intersect(
                    corn.tris, origin=eye, with_ids=ids, presort=presort)(rr)
                ok = (same_hits(torch, got[0], ref[0])
                      and torch.equal(got[1], ref[1]) if ids
                      else same_hits(torch, got, ref))
                need(ok, f"tilecull presort={presort} on the cornell {where} "
                     f"rays{' with ids' if ids else ''} differs from 'none'")
        for presort in ("octant", "morton"):
            lane = tk._presort_perm(rr, presort, *box)
            r8p = r8[:, lane].contiguous()
            t, g = tk.tilecull(r8p, pack, groups, sub)
            (tp, gp), plain_ms = timed(torch, lambda: tk.tilecull_plain(
                r8p, pack, groups, ray_chunk=1 << 18))
            need(torch.equal(t, tp) and torch.equal(g, gp),
                 f"tilecull differs from its plain version on the {presort}-"
                 f"presorted cornell {where} rays")
            need(torch.equal(t, t0_[lane]) and torch.equal(g, g0_[lane]),
                 f"tilecull on the {presort}-presorted cornell {where} rays "
                 "differs from its launch on the rays in order")
            rows6 = torch.stack([t, t, t, t, t, g])
            per = in_turns(torch, {
                "K6 none": lambda: tk.tilecull(r8, pack, groups, sub),
                "K6 presorted": lambda: tk.tilecull(r8p, pack, groups, sub),
                "permutation": lambda: tk._presort_perm(rr, presort, *box),
                "gather": lambda: r8[:, lane].contiguous(),
                "unpermute": lambda: unpermute(rows6, lane),
                "intersector none": lambda: isect["none"](rr),
                "intersector presorted": lambda: isect[presort](rr)})
            print(f"tilecull presort={presort} on the cornell {where} rays "
                  f"({r8.shape[1]}): Hits and ids torch.equal to 'none', "
                  f"K6 to its plain version ({plain_ms:.1f} ms); in turns: "
                  + turns_line(per))
            if where == "first-bounce" and presort == "morton":
                counts = tk.tilecull_counted(r8p, pack, groups, sub)[1]
                out["tilecull presorted bounce"] = (r8p, pack, groups, sub,
                                                    plain_ms, counts)
    return out


def _slice21_auto(torch, corn, cfg, add, RenderEngine):
    """The anchors of the auto accel's threshold (`runtime/accel_anchors`,
    in turns), the engine's pick against `auto_small_accel`'s, and
    'megakernel cornell repick': depth 5 -> 1 -> 5 -> 1 by the
    controller's '-' and '+', one frame at each."""
    from opencl_path_tracer_tpu_torch.models import megakernel
    from opencl_path_tracer_tpu_torch.ops.kernels import tilecull_kernel as tk
    from opencl_path_tracer_tpu_torch.runtime import accel_anchors
    from opencl_path_tracer_tpu_torch.runtime import engine as engine_mod
    thr = engine_mod.AUTO_TILECULL_THRESHOLD
    rows = accel_anchors.measure(MODELS_DIR, "cuda", turns=3, spp=4)
    for r in rows:
        need(r["engine_pick"] == r["pick"],
             f"anchor {r['anchor']}: the engine picked {r['engine_pick']}, "
             f"auto_small_accel at {thr} {r['pick']}")
    rule, why = accel_anchors.threshold_rule(rows)
    print(f"the anchors' rule on this run: threshold {rule!r} ({why}); "
          f"AUTO_TILECULL_THRESHOLD {thr!r}; the engine's picks equal "
          "auto_small_accel's")
    name = "megakernel cornell repick"
    eng = RenderEngine(corn, cfg(), device="cuda")
    first = eng.intersect_fn
    need(first.accel == rows[0]["pick"],
         f"{name}: 'auto' picked {first.accel} at 5 bounces, the anchor "
         f"{rows[0]['pick']}")
    seen = []

    def walk():
        for depth in (BOUNCES, 1, BOUNCES, 1):
            while eng.iterations > depth:
                eng.controller.key_down("-")
            while eng.iterations < depth:
                eng.controller.key_down("+")
            eng.frame(sync=False)
            cols = megakernel.colors_array(eng.state)
            seen.append((depth, eng.intersect_fn,
                         bool(torch.isfinite(cols).all())
                         and float(cols.mean()) > 0.0))

    one = tk.auto_small_accel(corn.tris, eng.camera, iterations=1,
                              threshold=thr)
    _, dt, counts = run_path(torch, name, walk, (first.accel, one))
    add(counts)
    fns = [fn for _, fn, _ in seen]
    need(all(ok for *_, ok in seen), f"{name}: a frame with NaN or black")
    need(fns[0] is first and fns[2] is first and fns[1] is not first
         and fns[3] is fns[1] and fns[1].accel == one
         and set(eng._accel_by_iters) == {BOUNCES, 1},
         f"{name}: the re-pick did not build one intersector per depth and "
         "reuse it")
    print(f"main path {name}: {W}x{H}, fast, depth {BOUNCES} -> 1 -> "
          f"{BOUNCES} -> 1, a frame each in {dt:.3f} s: picks "
          f"{first.accel} at {BOUNCES} bounces, {one} at 1; the second "
          "visit of each depth reused its intersector; NaN-free frames; "
          f"launches {counts}")


def _slice21_spectral(torch, scene, cfg, add):
    """'wavefront cornell-analytic nee dispersion': render_dispersive
    through the engine's 'auto' intersector, NEE's any-hit test; three
    bands without dispersion torch.equal to the plain wavefront render,
    five within 1e-6; flint glass (v_d 30) NaN-free, unlike the flat
    render, more than half of the values equal to it."""
    from opencl_path_tracer_tpu_torch.models import spectral, wavefront
    from opencl_path_tracer_tpu_torch.ops.kernels import tilecull_kernel as tk
    from opencl_path_tracer_tpu_torch.ops.nee import build_emitter_table
    from opencl_path_tracer_tpu_torch.runtime.controller import (
        CameraController)
    from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
    name = "wavefront cornell-analytic nee dispersion"
    c = cfg(model="wavefront", nee=True)
    cam = CameraController(c, device="cuda").camera(W, H)
    isect = make_intersect_fn(scene, "auto", cam=cam, iterations=BOUNCES)
    kw = dict(intersect_fn=isect, num_pixels=W * H, iterations=BOUNCES,
              min_spp=SPECTRAL_SPP, mode="fast", seed=1,
              nee=build_emitter_table(scene.tris, scene.mats, scene.spheres),
              occluded_fn=tk.make_scene_occluded(scene))

    def render(bands, v_d):
        return spectral.render_dispersive(cam, scene.mats, bands=bands,
                                          v_d=v_d, **kw)

    st = wavefront.render_wavefront(cam, scene.mats, exact_spp=True,
                                    device="cuda", **kw)
    plain = wavefront.colors_by_pixel(st, W * H)
    flat, dt_flat = timed(torch, lambda: render(3, None))
    need(torch.equal(flat, plain), f"{name}: three bands without dispersion "
         "differ from the plain wavefront render")
    five = render(5, None)
    err5 = float(((five - plain).abs() / plain.abs().clamp_min(1e-30)).max())
    need(err5 <= 1e-6, f"{name}: five flat bands {err5:.3g} from the plain "
         "render")
    disp, dt, counts = run_path(torch, name, lambda: render(3, 30.0),
                                isect.accel)
    add(counts)
    share = float((disp == flat).float().mean())
    need(bool(torch.isfinite(disp).all()) and disp.shape == (W * H, 3)
         and disp.dtype == torch.float32 and 0.5 < share < 1.0,
         f"{name}: bad dispersive image (finite "
         f"{bool(torch.isfinite(disp).all())}, {share:.4f} equal to flat)")
    print(f"main path {name}: {W}x{H}, {BOUNCES} bounces, fast, "
          f"{SPECTRAL_SPP} spp a band, accel {isect.accel}; 3 bands at v_d "
          f"30 in {dt:.3f} s ({SPECTRAL_SPP * 3 / dt:.2f} samples/s a "
          f"band), at v_d None {dt_flat / 1e3:.3f} s; flat torch.equal to "
          f"the plain render, 5 flat bands within {err5:.3g}; "
          f"{share:.4f} of the values equal to the flat render's; "
          f"launches {counts}")


BVH_RAYS = 262_144   # stress first-bounce rays the walkers take in check_slice22
K10_PLAIN_PAIRS = 65_536   # K10's plain check on the first pairs, as check_pairs


def tie_counts(torch, k1, pack, r8, lanes, t):
    """For each lane of `lanes` (indices into the (8, R) rays r8), the
    triangles of `pack` whose exact test (K1's, `exact_test`) accepts the
    ray at exactly t[lane]: 2 or more is an exact-t tie."""
    out = []
    for s in range(0, lanes.numel(), 256):
        sel = lanes[s:s + 256]
        tt, ok = k1.exact_test(pack, r8[:, sel].contiguous())
        out.append((ok & (tt == t[sel][None, :])).sum(0))
    return torch.cat(out) if out else lanes.new_zeros(0)


def grazing(torch, np, pack, r8, lane, t_hits):
    """Whether ray `lane` passes within float32 rounding of an edge of a
    triangle whose plane it meets at one of t_hits (float64 plane and
    edge values; relative margin under 2^-18 of the terms' sizes): the
    lanes where two roundings of the same test may disagree."""
    c = pack[:, :16].double().cpu().numpy()
    p = r8[0:3, lane].double().cpu().numpy()
    d = r8[3:6, lane].double().cpu().numpy()
    vn = c[:, 0:3] @ d
    with np.errstate(divide="ignore", invalid="ignore"):
        tp = (c[:, 3] - c[:, 0:3] @ p) / vn
        best = np.inf
        for th in t_hits:
            if not th > 0:
                continue
            near = np.isfinite(tp) & (np.abs(tp - th) <= 1e-5 * abs(th))
            for b in (4, 8, 12):
                m = c[near, b:b + 3]
                e = m @ p + tp[near] * (m @ d) - c[near, b + 3]
                size = (np.abs(m) @ np.abs(p) + np.abs(tp[near])
                        * (np.abs(m) @ np.abs(d)) + np.abs(c[near, b + 3]))
                if e.size:
                    best = min(best, float(np.min(np.abs(e) / size)))
    return best < 2.0 ** -18


def attrs_vs_k4(torch, k1, name, h, r8, pack, dense_out, where):
    """An exact accel's Hits against K4's over the scene: t torch.equal;
    n and mati equal but at exact-t ties between distinct triangles,
    which are counted (each lane where they differ must be one). Returns
    the tie lanes' count."""
    t4, g4, nx, ny, nz, m4 = dense_out
    torch.cuda.synchronize()
    need(torch.equal(h.t, torch.where(t4 < k1.BIG, t4,
                                      torch.full_like(t4, -1.0))),
         f"{name}: t differs from K4's on {where}")
    hit = t4 < k1.BIG
    diff = hit & ((h.n[0] != nx) | (h.n[1] != ny) | (h.n[2] != nz)
                  | (h.mati != m4.to(torch.int32)))
    lanes = torch.nonzero(diff).flatten()
    ties = tie_counts(torch, k1, pack, r8, lanes, t4)
    need(bool((ties >= 2).all()),
         f"{name}: n or mati differs from K4's on {where} at lanes that "
         "are no exact-t tie")
    return int(lanes.numel())


def check_slice22(torch, np, scenes, cam, inputs, errs):
    """The bvh and median walkers, K10's full form and the pair options
    at 1920x1080 (the module docstring). Returns (the launches of its main
    paths, the kernels line's inputs for K10's full form)."""
    from opencl_path_tracer_tpu_torch.config import CameraConfig, RenderConfig
    from opencl_path_tracer_tpu_torch.ops.kernels import _build
    from opencl_path_tracer_tpu_torch.ops.kernels import (
        intersect_kernel as k1, pair_mxu as pm, sorted_intersect as si)
    from opencl_path_tracer_tpu_torch.runtime.engine import RenderEngine
    t_phase = time.perf_counter()
    launches = {}
    preset = CameraConfig(fov=60.0, yaw=0.0, pitch=0.0,
                          shift=(0.0, 0.0, 0.0))

    def cfg(**kw):
        return RenderConfig(width=W, height=H, iterations=BOUNCES,
                            mode="fast", camera=preset, **kw)

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    stress = scenes["stress"]
    cam_rays = camera_rays(cam)
    bounce = inputs["stress bounce rays"]
    rays = {"camera": cam_rays, "bounce": bounce}
    r8s = {k: k1.pack_rays(v.p, v.d).contiguous() for k, v in rays.items()}
    pack = k1.build_tri_pack(stress.tris)
    dense = {k: k1.dense(v, pack) for k, v in r8s.items()}
    out = _slice22_k10(torch, stress, r8s, errs)
    pairmx = _slice22_pairmx(torch, np, stress, cfg, add, rays, r8s, pack,
                             dense, RenderEngine)
    _slice22_chain_approx(torch, stress, rays, r8s, pack, dense, pairmx)
    _slice22_walkers(torch, np, scenes, cfg, add, bounce, RenderEngine)
    _slice22_native(torch, stress)
    print(f"check_slice22: {time.perf_counter() - t_phase:.1f} s")
    return launches, out


def _slice22_k10(torch, stress, r8s, errs):
    """K10's full form (and, as infeat needs a flag, both forms on the
    fused features) on round 1's pairs of the 'pairmx' shape (clusters
    of 512, K9's 8 nearest, tiles of 512) of the stress camera and
    first-bounce rays: torch.equal to its plain version on the first
    K10_PLAIN_PAIRS pairs, its t and pend equal to the thin form's and
    its attributes to K11's fetch of the thin form's winners on the whole
    launch. Returns the kernels line's inputs."""
    from opencl_path_tracer_tpu_torch.ops.kernels import (
        intersect_kernel as k1, pair_mxu as pm, sorted_intersect as si)
    from opencl_path_tracer_tpu_torch.ops.kernels.march_kernel import (
        build_march_scene)
    cs, trp, l1 = 512, 512, 8
    _, rest = si.split_by_size(stress.tris)
    ms, _, c = build_march_scene(rest, cs)
    boxes_r = torch.zeros((-(-c // 128) * 128, 8), device="cuda")
    boxes_r[:c] = torch.cat([ms.boxes_lo, ms.boxes_hi,
                             torch.zeros((c, 2), device="cuda")], 1)
    out = {}
    for rname, r8 in r8s.items():
        ids = si.run_candidates(r8, boxes_r, l1, c)[0]
        keys_s, r8p, _ = pm.sort_pairs([r8[k] for k in range(6)], ids, c,
                                       trp)
        nv = int((pm.build_visits(keys_s, trp, c)[1] >= 0).sum())
        args = (keys_s, r8p, ms.trig, ms.tric, cs, trp, c)
        n = K10_PLAIN_PAIRS
        pre = (keys_s[:n], r8p[:, :n].contiguous(), ms.trig, ms.tric, cs,
               trp, c)
        for infeat in (False, True):
            form = "infeat " if infeat else ""
            full = pm.pair_visits_full(*args, infeat=infeat)
            t, gp = pm.pair_visits(*args, infeat=infeat)
            plain, plain_ms = timed(torch, lambda: pm.pair_visits_full_plain(
                *pre, infeat=infeat))
            for a, b in zip(full, plain):
                errs["pair_visit_full"] = max(
                    errs["pair_visit_full"], float((a[:n].double()
                                                    - b.double()).abs().max()))
            need(all(torch.equal(a[:n], b) for a, b in zip(full, plain)),
                 f"pair_visit_full ({form}) differs from its plain version on "
                 f"the first {n} {rname} pairs")
            g = torch.floor(gp / 2.0)
            pend = gp - 2.0 * g
            fetched = pm.fetch_attrs(torch.where(t < k1.BIG, g, -1.0),
                                     ms.tric)
            mp = full[4]
            need(torch.equal(full[0], t) and torch.equal(
                mp - 2.0 * torch.floor(mp / 2.0), pend),
                 f"pair_visit_full's {form}t or pend differs from the thin "
                 f"form's on the {rname} pairs")
            need(all(torch.equal(a, b) for a, b in zip(full[1:4], fetched))
                 and torch.equal(torch.floor(mp / 2.0), fetched[3]),
                 f"pair_visit_full's {form}attributes differ from K11's "
                 f"fetch of the thin form's winners on the {rname} pairs")
            print(f"pair_visit_full {form}on {keys_s.shape[0]} stress "
                  f"{rname} pairs (cs {cs}, trp {trp}, l {l1}; {nv} visits, "
                  f"{int((t < k1.BIG).sum())} hits, {int(pend.sum())} "
                  f"pending): torch.equal to its plain version on the first "
                  f"{n} pairs ({plain_ms:.1f} ms plain); t and pend equal "
                  "the thin form's, the attributes K11's fetch of its "
                  "winners on every pair")
            if not infeat:
                out["pair_visit_full" + ("" if rname == "camera"
                                         else " bounce")] = (
                    args, nv, pre, plain_ms)
        same = [torch.equal(a, b) for a, b in zip(
            pm.pair_visits_full(*args), pm.pair_visits_full(*args,
                                                            infeat=True))]
        print(f"pair_visit_full on the {rname} pairs, infeat against the "
              f"separate features: streams equal {same}")
        per = in_turns(torch, {
            "thin": lambda: pm.pair_visits(*args),
            "full": lambda: pm.pair_visits_full(*args),
            "full infeat": lambda: pm.pair_visits_full(*args, infeat=True)})
        print(f"pair_visit on the {rname} pairs in turns: " + turns_line(per))
    return out


def _slice22_pairmx(torch, np, stress, cfg, add, rays, r8s, pack, dense,
                    RenderEngine):
    """'megakernel stress pairmx' through the engine, and its
    intersector's hits against K4's on the camera and first-bounce
    rays, with the schedule's counts. Returns the intersector."""
    from opencl_path_tracer_tpu_torch.ops.kernels import (
        intersect_kernel as k1, sorted_intersect as si)
    name = "megakernel stress pairmx"
    eng = RenderEngine(stress, cfg(spp=STRESS_SPP, accel="pairmx"),
                       device="cuda")
    _, dt, counts = run_path(torch, name,
                             lambda: eng.render(STRESS_SPP, progress=False),
                             "pairmx")
    add(counts)
    img = eng.image()
    need(img.shape == (H, W, 3) and bool(np.isfinite(img).all())
         and img.mean() > 0.0, f"{name}: bad image")
    print(f"main path {name}: {W}x{H}, {BOUNCES} bounces, {STRESS_SPP} spp "
          f"in {dt:.3f} s: {eng.rays_traced / dt / 1e6:.1f} Mrays/s, "
          f"{STRESS_SPP / dt:.2f} samples/s; launches {counts}")
    ties = {}

    def check_both():
        for rname, r in rays.items():
            h = eng.intersect_fn(r)
            ties[rname] = attrs_vs_k4(torch, k1, name, h, r8s[rname], pack,
                                      dense[rname], f"{rname} rays")

    pair_stats_line(f"{name} camera, bounce rays", schedule_counts(check_both))
    print(f"{name}: hits equal K4's (t torch.equal; n and mati but at "
          f"exact-t ties: {ties})")
    return eng.intersect_fn


def _slice22_chain_approx(torch, stress, rays, r8s, pack, dense, pairmx):
    """move='chain' with PAIR_TPU_WINNER's other settings: t equal to
    K4's, n and mati but at exact-t ties (counted), the tiers' counts,
    the time in turns against move='sort'; approx=True (thin: the
    'pairwin' settings; full: 'pairmx''s): the resolved share, the
    resolved lanes' Hits equal to the exact path's."""
    from opencl_path_tracer_tpu_torch.ops.kernels import (
        intersect_kernel as k1, sorted_intersect as si)
    kw = dict(si.PAIR_TPU_WINNER)
    chain = si.make_pair_intersect(stress.tris, **dict(kw, move="chain"))
    sort = si.make_pair_intersect(stress.tris, **kw)
    ties = {}

    def check_both():
        for rname, r in rays.items():
            ties[rname] = attrs_vs_k4(torch, k1, "chain", chain(r),
                                      r8s[rname], pack, dense[rname],
                                      f"{rname} rays")

    stats = schedule_counts(check_both)
    pair_stats_line("chain camera, bounce rays", stats)
    print("chain: the chain's tail over "
          f"{stats['isect.chain_tail_rays']} rays in "
          f"{stats['isect.chain_tail_iterations']} iterations; hits "
          f"equal K4's (t torch.equal; n and mati but at exact-t ties "
          f"{ties}, where the chain keeps the lowest march-ordered row)")
    for rname, r in rays.items():
        per = in_turns(torch, {"sort": lambda r=r: sort(r),
                               "chain": lambda r=r: chain(r)}, turns=3,
                       reps=3)
        print(f"chain against sort on stress {rname} rays in turns: "
              + turns_line(per))
    for form, kwa, exact in (("thin", kw, sort),
                             ("full", dict(mxu=True, trp=512), pairmx)):
        approx = si.make_pair_intersect(stress.tris, **dict(kwa, approx=True))
        for rname, r in rays.items():
            h, res = approx(r)
            e = exact(r)

            def at(x):
                return x[res]

            ok = (torch.equal(at(h.t), at(e.t))
                  and torch.equal(at(h.mati), at(e.mati))
                  and all(torch.equal(at(a), at(b)) for a, b in zip(h.n, e.n))
                  and all(torch.equal(at(a), at(b)) for a, b in zip(h.p, e.p)))
            need(ok, f"approx ({form}): a resolved lane's hit differs from "
                 f"the exact path's on {rname} rays")
            print(f"approx ({form}) on stress {rname} rays: resolved share "
                  f"{float(res.float().mean()):.4f}, the resolved lanes' "
                  "Hits equal the exact path's")


def _slice22_walkers(torch, np, scenes, cfg, add, bounce, RenderEngine):
    """'bvh' and 'median' with force on the cornell camera rays and on the
    first BVH_RAYS stress first-bounce rays: hit masks against K4's, t
    within rtol 1e-4, the lanes outside counted and each one a grazing
    ray; iterations and ms a call; 'megakernel cornell bvh', 1 spp."""
    from opencl_path_tracer_tpu_torch.core.types import Rays
    from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
    from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
    from opencl_path_tracer_tpu_torch.scene import library
    corn = scenes["cornell"]
    cut = Rays(p=tuple(x[:BVH_RAYS].contiguous() for x in bounce.p),
               d=tuple(x[:BVH_RAYS].contiguous() for x in bounce.d))
    cases = (("cornell camera", corn,
              camera_rays(library.cornell_camera(W, H, device="cuda"))),
             ("stress first-bounce", scenes["stress"], cut))
    for where, scene, r in cases:
        r8 = k1.pack_rays(r.p, r.d).contiguous()
        pack = k1.build_tri_pack(scene.tris)
        t4, g4 = k1.dense(r8, pack)[:2]
        hit4 = t4 < k1.BIG
        for accel in ("bvh", "median"):
            t0 = time.perf_counter()
            fn = make_intersect_fn(scene, accel, force=True)
            torch.cuda.synchronize()
            t_build = time.perf_counter() - t0
            h, ms_call = timed(torch, lambda: fn(r))
            hit = h.t > 0
            close = (h.t - t4).abs() <= 1e-4 * t4.abs()
            bad = torch.nonzero((hit != hit4) | (hit4 & ~close)).flatten()
            explained = sum(grazing(torch, np, pack, r8, int(i),
                                    (float(h.t[i]), float(t4[i])))
                            for i in bad[:64].tolist())
            need(bad.numel() <= 64 and explained == bad.numel(),
                 f"{accel} on {where} rays: {bad.numel()} lanes off K4's "
                 f"(hit mask or t beyond rtol 1e-4), {explained} of them "
                 "grazing an edge")
            n_diff = int((hit4 & (h.t != t4)).sum())
            print(f"{accel} (force) on {r.count} {where} rays: "
                  f"{fn.iterations} iterations ({fn.steps} steps run), "
                  f"{ms_call:.1f} ms a call, build {t_build:.3f} s; hit mask "
                  f"and t within rtol 1e-4 of K4's but at {bad.numel()} "
                  f"lanes, each grazing an edge; t bit-equal to K4's on "
                  f"{int(hit4.sum()) - n_diff} of {int(hit4.sum())} hits")
    name = "megakernel cornell bvh"
    eng = RenderEngine(corn, cfg(spp=1, accel="bvh", accel_force=True),
                       device="cuda")
    _, dt, counts = run_path(torch, name,
                             lambda: eng.render(1, progress=False), "bvh")
    add(counts)
    img = eng.image()
    need(img.shape == (H, W, 3) and bool(np.isfinite(img).all())
         and img.mean() > 0.0, f"{name}: bad image")
    print(f"main path {name}: {W}x{H}, {BOUNCES} bounces, 1 spp in "
          f"{dt:.3f} s: {eng.rays_traced / dt / 1e6:.1f} Mrays/s, "
          f"{1 / dt:.2f} samples/s; launches {counts} (the walker is plain "
          "PyTorch: no kernel of the port)")


def _slice22_native(torch, stress):
    """The native OBJ loader equal to io/obj.py on every model of
    tests/assets/models (its first call builds the library), and the
    native builder's tree on the stress scene bit-equal to the Python
    builder's."""
    import glob
    import numpy as np
    from opencl_path_tracer_tpu_torch import native
    from opencl_path_tracer_tpu_torch.accel import build_median_tree
    from opencl_path_tracer_tpu_torch.io.obj import load_obj
    need(native.available(), "no g++: the native library cannot be built")
    files = sorted(glob.glob(os.path.join(MODELS_DIR, "*.obj")))
    for path in files:
        (va, sa, ma), (vb, sb, mb) = native.load_obj_native(path), \
            load_obj(path)
        same = (np.array_equal(va.vertices, vb.vertices)
                and [s.name for s in sa] == [s.name for s in sb]
                and all(np.array_equal(x.vertex_indices, y.vertex_indices)
                        and np.array_equal(x.material_ids, y.material_ids)
                        for x, y in zip(sa, sb))
                and [m.name for m in ma] == [m.name for m in mb]
                and all(np.array_equal(np.float32(x.diffuse),
                                       np.float32(y.diffuse))
                        for x, y in zip(ma, mb)))
        need(same, f"load_obj_native differs from io/obj.py on {path}")
    t0 = time.perf_counter()
    a = native.build_median_tree_native(stress.tris)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = build_median_tree(stress.tris)
    t_python = time.perf_counter() - t0
    need(all(torch.equal(getattr(a, f), getattr(b, f))
             for f in ("nodes", "tri_pack", "tri_n", "tri_mati"))
         and (a.depth, a.leaf_size) == (b.depth, b.leaf_size),
         "the native median tree differs from the Python one on stress")
    print(f"native: the library built in {native.build_info['seconds']:.2f} "
          f"s (g++; 0 where `_build/` held it); load_obj_native equal to "
          f"io/obj.py on {len(files)} models; the median tree of stress "
          f"({a.num_nodes} nodes, depth {a.depth}) in {t_native:.3f} s, "
          f"bit-equal to the Python builder's ({t_python:.3f} s)")


# check_slice23's turntables: poses about the box's middle at the preset
# eye's distance, looking in through the open front.
ORBIT = dict(center=(500.0, 500.0, 500.0), radius=1799.037842, pitch=0.0)
ANIM_SPP = 2   # spp a frame of check_slice23's turntables
FPS_WINDOW = 3.0   # seconds the viewer's published frames are counted


class plain_guard:
    """While active, every plain version in `ops/kernels/` raises a
    SmokeError when it is handed a CUDA tensor: the paths run inside it
    must launch their kernels on the card and never fall back. Every
    module-level name in the package that is bound to a plain version is
    rebound to the guard, the copies `from ... import`ed into other
    modules too (a plain version held in a closure is not reached; the
    per-path launch counts of `run_path` cover those)."""

    PACKAGE = "opencl_path_tracer_tpu_torch"

    def __init__(self):
        import importlib
        import pkgutil
        from opencl_path_tracer_tpu_torch.ops import kernels
        self.plain = {}   # id(plain version) -> (its module, name, it)
        for info in pkgutil.iter_modules(kernels.__path__):
            mod = importlib.import_module(f"{kernels.__name__}.{info.name}")
            for attr, fn in vars(mod).items():
                if (attr.endswith("_plain") and callable(fn)
                        and getattr(fn, "__module__", "") == mod.__name__):
                    self.plain[id(fn)] = (mod, attr, fn)

    def _modules(self):
        return [m for n, m in list(sys.modules.items())
                if m is not None and (n == self.PACKAGE
                                      or n.startswith(self.PACKAGE + "."))]

    def _rebind(self, table):
        """Rebinds every package module's name whose value's id is a key
        of `table` to the table's value for it."""
        for mod in self._modules():
            for attr, val in list(vars(mod).items()):
                if id(val) in table:
                    setattr(mod, attr, table[id(val)])

    def __enter__(self):
        import torch

        def guard(mod, attr, fn):
            def call(*a, **k):
                if any(isinstance(x, torch.Tensor) and x.is_cuda
                       for x in (*a, *k.values())):
                    raise SmokeError(f"{mod.__name__}.{attr} ran on CUDA "
                                     "tensors: a path fell back")
                return fn(*a, **k)
            return call

        self.guards = {key: guard(*entry) for key, entry in self.plain.items()}
        self._rebind(self.guards)
        return self

    def __exit__(self, *exc):
        # Modules first imported inside the guard hold a guard too.
        self._rebind({id(g): self.plain[key][2]
                      for key, g in self.guards.items()})
        return False


def gif_layout(data):
    """(version, loop count, image descriptors, delays in 1/100 s, whether
    every image has its own 256-entry colour table and the screen none:
    the port's raw writer's layout) of a GIF file's bytes, walking its
    blocks."""
    import struct
    version = data[:6]
    flags = data[10]
    pos = 13 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)
    loop, images, delays, local = None, 0, [], not flags & 0x80

    def skip_sub_blocks(p):
        while data[p]:
            p += data[p] + 1
        return p + 1

    while data[pos] != 0x3B:
        if data[pos] == 0x21:
            label = data[pos + 1]
            if label == 0xFF and data[pos + 3:pos + 14] == b"NETSCAPE2.0":
                loop = struct.unpack("<H", data[pos + 16:pos + 18])[0]
            elif label == 0xF9:
                delays.append(struct.unpack("<H", data[pos + 4:pos + 6])[0])
            pos = skip_sub_blocks(pos + 2)
        elif data[pos] == 0x2C:
            images += 1
            packed = data[pos + 9]
            local = local and packed == 0x87
            pos += 10 + (3 << ((packed & 7) + 1) if packed & 0x80 else 0)
            pos = skip_sub_blocks(pos + 1)
        else:
            raise SmokeError(f"GIF: unknown block 0x{data[pos]:02x} at {pos}")
    return version, loop, images, delays, local


def check_slice23(torch, np, scenes):
    """The interactive front end at 1920x1080, 5 bounces, fast mode (the
    module docstring), inside `plain_guard`, with the counts reset before
    and read after each main path. Returns the launches of its paths."""
    from opencl_path_tracer_tpu_torch.config import CameraConfig, RenderConfig
    from opencl_path_tracer_tpu_torch.runtime import anim
    from opencl_path_tracer_tpu_torch.runtime.engine import RenderEngine
    t_phase = time.perf_counter()
    launches = {}
    preset = dict(fov=60.0, yaw=0.0, pitch=0.0, shift=(0.0, 0.0, 0.0))

    def cfg(camera=None, **kw):
        return RenderConfig(width=W, height=H, iterations=BOUNCES,
                            mode="fast",
                            camera=camera or CameraConfig(**preset), **kw)

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    with plain_guard(), tempfile.TemporaryDirectory(
            prefix="ptx-slice23-") as tmp:
        frames = _slice23_anim(torch, np, scenes["cornell"], cfg, add,
                               RenderEngine, anim, CameraConfig, preset)
        _slice23_gif(torch, np, frames, anim, tmp)
        _slice23_dispersive(torch, np, scenes["cornell-analytic"], cfg, add,
                            tmp)
        _slice23_viewer(torch, np, scenes["cornell"], cfg, add, RenderEngine,
                        tmp)
    print(f"check_slice23: {time.perf_counter() - t_phase:.1f} s")
    return launches


def _slice23_anim(torch, np, corn, cfg, add, RenderEngine, anim,
                  CameraConfig, preset):
    """'megakernel cornell nee anim': `render_animation` over three poses
    of a 30-degree pan about the box's middle, through its open front, at
    ANIM_SPP; each frame np.array_equal to a fresh engine's display_u8()
    at its pose. The fresh engines take the turntable engine's
    intersector: 'tilecull' orders its groups from the eye it was built
    at, which breaks exact-t ties, and a turntable keeps the one it
    built."""
    name = "megakernel cornell nee anim"
    eng = RenderEngine(corn, cfg(nee=True), device="cuda")
    poses = anim.turntable_poses(frames=3, start_yaw=-15.0, sweep=30.0,
                                 **ORBIT)
    frames, dt, counts = run_path(
        torch, name, lambda: anim.render_animation(
            eng, poses, spp=ANIM_SPP, progress=False),
        eng.intersect_fn.accel)
    add(counts)
    for i, (yaw, pitch, shift) in enumerate(poses):
        fresh = RenderEngine(corn, cfg(nee=True, camera=CameraConfig(
            **dict(preset, yaw=yaw, pitch=pitch,
                   shift=tuple(float(v) for v in shift)))),
            intersect_fn=eng.intersect_fn, device="cuda")
        fresh.render(ANIM_SPP, progress=False)
        need(np.array_equal(frames[i], fresh.display_u8()),
             f"{name}: frame {i} (yaw {yaw}) differs from a fresh engine's "
             f"{ANIM_SPP} samples at its pose")
    need(all(f.shape == (H, W, 3) and f.dtype == np.uint8 and f.mean() > 1
             for f in frames)
         and not np.array_equal(frames[0], frames[1])
         and not np.array_equal(frames[1], frames[2]),
         f"{name}: the frames are dark or equal from pose to pose")
    print(f"main path {name}: {W}x{H}, {BOUNCES} bounces, fast, accel "
          f"{eng.intersect_fn.accel}, yaws {[p[0] for p in poses]} about "
          f"{ORBIT['center']}, {ANIM_SPP} spp a frame: {len(frames)} frames "
          f"in {dt:.3f} s, {len(frames) / dt:.2f} frames/s offline "
          "(render, image fetch, to_uint8); each equal to a fresh engine's "
          f"display_u8() at its pose; launches {counts}")
    return frames


def _slice23_gif(torch, np, frames, anim, tmp):
    """The raw GIF writer on the turntable's 1080p frames (timed), and
    `ptx-torch anim` as a subprocess with PIL hidden (the raw PNG and GIF
    writers), then in process with --denoise and PIL's writers set
    aside: two PNGs and a GIF of two frames each."""
    import contextlib
    import io
    from opencl_path_tracer_tpu_torch import cli
    from opencl_path_tracer_tpu_torch.io import image
    from opencl_path_tracer_tpu_torch.io.image import read_png
    path = os.path.join(tmp, "frames.gif")
    anim._write_gif_raw(path, frames[:1])
    t0 = time.perf_counter()
    anim._write_gif_raw(path, frames)
    gif_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    with open(path, "rb") as fh:
        data = fh.read()
    layout = gif_layout(data)
    need(layout == (b"GIF89a", 0, len(frames),
                    [anim.gif_delay_ms(12.0) // 10] * len(frames), True),
         f"the raw GIF of the turntable: {layout[:4]}")
    print(f"_write_gif_raw: {len(frames)} frames of {W}x{H} (the "
          "252-colour cube where a frame has over 256 colours) in "
          f"{gif_ms * len(frames):.1f} ms, "
          f"{gif_ms:.1f} ms a frame, {len(data)} bytes; GIF89a, loop 0, "
          f"{layout[2]} images")
    orbit = ["--scene", "cornell", "--size", f"{W}x{H}", "--iters",
             str(BOUNCES), "--frames", "2", "--spp", str(ANIM_SPP),
             "--center", *(str(c) for c in ORBIT["center"]), "--radius",
             str(ORBIT["radius"]), "--pitch", "0", "--sweep", "15"]
    for denoise in (False, True):
        tag = "denoise" if denoise else "plain"
        out_dir, gif = os.path.join(tmp, tag), os.path.join(tmp, f"{tag}.gif")
        args = ["anim", *orbit, "--out-dir", out_dir, "--gif", gif]
        t0 = time.perf_counter()
        if not denoise:
            code = ("import sys; sys.modules['PIL'] = None; "
                    "from opencl_path_tracer_tpu_torch import cli; "
                    "sys.exit(cli.main(sys.argv[1:]))")
            r = subprocess.run([sys.executable, "-c", code, *args], cwd=HERE,
                               capture_output=True, text=True, timeout=300)
            need(r.returncode == 0, f"ptx-torch anim (subprocess) exited "
                 f"{r.returncode}: {r.stderr[-2000:]}")
            said = [ln for ln in r.stderr.splitlines() if "fps offline" in ln]
        else:
            saved = anim._PIL, image._PIL
            anim._PIL = image._PIL = None
            err = io.StringIO()
            try:
                with contextlib.redirect_stderr(err):
                    rc = cli.main(args + ["--denoise"])
            finally:
                anim._PIL, image._PIL = saved
            need(rc == 0, f"ptx-torch anim --denoise returned {rc}")
            said = [ln for ln in err.getvalue().splitlines()
                    if "fps offline" in ln]
        dt = time.perf_counter() - t0
        imgs = [read_png(os.path.join(out_dir, f"frame_{i:04d}.png"))
                for i in range(2)]
        with open(gif, "rb") as fh:
            layout = gif_layout(fh.read())
        need(all(im.shape == (H, W, 3) and im.mean() > 1 for im in imgs)
             and not np.array_equal(*imgs)
             and layout[:3] == (b"GIF89a", 0, 2) and layout[4],
             f"ptx-torch anim ({tag}): PNGs {[im.shape for im in imgs]}, "
             f"GIF {layout}")
        print(f"ptx-torch anim{' --denoise' if denoise else ''} "
              f"({'a subprocess, PIL hidden' if not denoise else 'in process, PIL set aside'})"
              f": 2 frames of {W}x{H} at {ANIM_SPP} spp in {dt:.2f} s "
              f"({said[-1].strip() if said else 'no rate line'}); two PNGs, a "
              f"GIF89a with loop 0 and 2 images in the raw writer's layout")


def _slice23_dispersive(torch, np, scene, cfg, add, tmp):
    """'wavefront cornell-analytic nee dispersion anim': `ptx-torch anim
    --dispersion 30 --bands 3 --nee`, 2 frames at SPECTRAL_SPP in
    process; the renderer's images NaN-free, frame 0 torch.equal to
    `spectral.render_dispersive` at its pose through an intersector built
    at the CLI's camera, and its PNG to that image tonemapped."""
    from opencl_path_tracer_tpu_torch import cli
    from opencl_path_tracer_tpu_torch.io.image import read_png, to_uint8
    from opencl_path_tracer_tpu_torch.models import spectral
    from opencl_path_tracer_tpu_torch.ops import tonemap as tonemap_ops
    from opencl_path_tracer_tpu_torch.ops.kernels import tilecull_kernel as tk
    from opencl_path_tracer_tpu_torch.ops.nee import build_emitter_table
    from opencl_path_tracer_tpu_torch.runtime import anim
    from opencl_path_tracer_tpu_torch.runtime.controller import (
        CameraController)
    from opencl_path_tracer_tpu_torch.runtime.engine import make_intersect_fn
    name = "wavefront cornell-analytic nee dispersion anim"
    out_dir = os.path.join(tmp, "dispersion")
    args = ["anim", "--scene", "cornell-analytic", "--size", f"{W}x{H}",
            "--iters", str(BOUNCES), "--frames", "2", "--spp",
            str(SPECTRAL_SPP), "--dispersion", "30", "--bands", "3", "--nee",
            "--center", *(str(c) for c in ORBIT["center"]), "--radius",
            str(ORBIT["radius"]), "--pitch", "0", "--sweep", "15",
            "--out-dir", out_dir, "--gif", ""]
    real = spectral.make_dispersive_renderer
    seen = {"images": []}

    def keep(*a, **k):
        seen["isect"] = k["intersect_fn"]
        render = real(*a, **k)

        def call(cam):
            img = render(cam)
            seen["images"].append(img)
            return img
        return call

    # The CLI builds its intersector at the preset camera, as here.
    ctrl = CameraController(cfg(nee=True), device="cuda")
    isect = make_intersect_fn(scene, "auto", cam=ctrl.camera(W, H),
                              iterations=BOUNCES)
    spectral.make_dispersive_renderer = keep
    try:
        rc, dt, counts = run_path(torch, name, lambda: cli.main(args),
                                  isect.accel)
    finally:
        spectral.make_dispersive_renderer = real
    add(counts)
    imgs = seen["images"]
    need(rc == 0 and seen["isect"].accel == isect.accel and len(imgs) == 2
         and all(bool(torch.isfinite(im).all()) and im.shape == (W * H, 3)
                 for im in imgs) and not torch.equal(*imgs),
         f"{name}: bad images or accel {seen['isect'].accel}")
    yaw, pitch, shift = anim.turntable_poses(frames=2, sweep=15.0,
                                             **ORBIT)[0]
    st = ctrl.state
    st.yaw, st.pitch, st.shift = yaw, pitch, np.asarray(shift, np.float64)
    ref = spectral.render_dispersive(
        ctrl.camera(W, H), scene.mats, intersect_fn=isect,
        num_pixels=W * H, iterations=BOUNCES, min_spp=SPECTRAL_SPP,
        bands=3, v_d=30.0, mode="fast", seed=1,
        nee=build_emitter_table(scene.tris, scene.mats, scene.spheres),
        occluded_fn=tk.make_scene_occluded(scene))
    need(torch.equal(imgs[0], ref), f"{name}: frame 0 differs from "
         "render_dispersive at its pose")
    png = read_png(os.path.join(out_dir, "frame_0000.png"))
    want = to_uint8(tonemap_ops.apply(ref.reshape(H, W, 3), "reinhard")
                    .cpu().numpy()[::-1])
    need(np.array_equal(png, want), f"{name}: frame 0's PNG is not "
         "render_dispersive's image tonemapped")
    print(f"main path {name}: ptx-torch {' '.join(args[:-4])}: 2 frames of "
          f"{W}x{H} in {dt:.2f} s ({2 / dt:.3f} frames/s, accel "
          f"{seen['isect'].accel}); NaN-free; frame 0 torch.equal to "
          "render_dispersive at its pose, its PNG to that image tonemapped; "
          f"launches {counts}")


def _slice23_viewer(torch, np, corn, cfg, add, RenderEngine, tmp):
    """'megakernel cornell viewer': `ViewerServer` on 127.0.0.1, port 0,
    block=False, over HTTP: /frame.png a 1080p PNG; viewer_fps over a
    window of FPS_WINDOW s; '+' to depth 6 (the engine re-picks); 'n'
    denoised frames, error None; /stream.mjpg JPEG parts with PIL, 404
    without; /frame.png's encode ms (`io.image.png_bytes`, perf_counter,
    no device sync, the render thread running without JPEG); ESC stops
    the server."""
    import json
    import urllib.error
    import urllib.request
    from opencl_path_tracer_tpu_torch.io import image
    from opencl_path_tracer_tpu_torch.io.image import read_png
    from opencl_path_tracer_tpu_torch.runtime.viewer import ViewerServer
    name = "megakernel cornell viewer"
    eng = RenderEngine(corn, cfg(), device="cuda")
    need(eng._accel_auto, f"{name}: 'auto' does not re-pick on the card")
    v = ViewerServer(eng, port=0)
    out = {}

    def get(path):
        return urllib.request.urlopen(base + path, timeout=60).read()

    def stats():
        return json.loads(get("/stats"))

    def key(k):
        req = urllib.request.Request(
            base + "/input", method="POST",
            data=json.dumps({"ev": "keydown", "key": k}).encode())
        need(urllib.request.urlopen(req, timeout=60).read() == b"ok",
             f"{name}: /input {k!r}")

    def until(cond, what, limit=60.0):
        deadline = time.perf_counter() + limit
        while time.perf_counter() < deadline:
            if cond():
                return
            time.sleep(0.02)
        need(False, f"{name}: timed out waiting for {what} "
             f"(stats {stats()})")

    def drive():
        nonlocal base
        httpd = v.serve(block=False)
        base = f"http://127.0.0.1:{v.port}"
        until(lambda: v._seq > 1, "the first frames")
        png = get("/frame.png")
        path = os.path.join(tmp, "frame.png")
        with open(path, "wb") as fh:
            fh.write(png)
        need(png.startswith(b"\x89PNG") and read_png(path).shape
             == (H, W, 3), f"{name}: /frame.png is no {W}x{H} PNG")
        seq0, t0 = v._seq, time.perf_counter()
        time.sleep(FPS_WINDOW)
        out["fps"] = (v._seq - seq0) / (time.perf_counter() - t0)
        out["stats"] = stats()
        key("+")
        until(lambda: stats()["iterations"] == BOUNCES + 1
              and eng._accel_iters == BOUNCES + 1, "depth 6")
        out["accels"] = {d: f.accel for d, f in eng._accel_by_iters.items()}
        need(eng.intersect_fn is eng._accel_by_iters[BOUNCES + 1],
             f"{name}: no re-pick at depth {BOUNCES + 1}")
        key("n")
        seq1, t1 = v._seq, time.perf_counter()
        until(lambda: v._seq >= seq1 + 3, "three denoised frames")
        out["denoise_fps"] = (v._seq - seq1) / (time.perf_counter() - t1)
        s = stats()
        need(s["denoise"] is True and s["error"] is None,
             f"{name}: denoised display: {s}")
        key("n")
        if v._have_pil:
            with urllib.request.urlopen(base + "/stream.mjpg",
                                        timeout=60) as resp:
                blob, deadline = b"", time.perf_counter() + 60
                while (blob.count(b"--ptxframe\r\nContent-Type: image/jpeg")
                       < 2 and time.perf_counter() < deadline):
                    blob += resp.read(1 << 16)
            out["jpeg_parts"] = blob.count(
                b"--ptxframe\r\nContent-Type: image/jpeg")
            need(out["jpeg_parts"] >= 2, f"{name}: /stream.mjpg sent "
                 f"{out['jpeg_parts']} JPEG parts")
        v._have_pil = False
        try:
            get("/stream.mjpg")
            need(False, f"{name}: /stream.mjpg without PIL did not 404")
        except urllib.error.HTTPError as e:
            need(e.code == 404, f"{name}: /stream.mjpg without PIL: {e.code}")
        until(lambda: v._frame_jpg == b"", "a frame without JPEG")
        png_ms = []
        for _ in range(3):
            t = time.perf_counter()
            body = v._encode_png()
            png_ms.append((time.perf_counter() - t) * 1e3)
        with open(path, "wb") as fh:
            fh.write(get("/frame.png"))
        need(body.startswith(b"\x89PNG")
             and image._read_png_raw(path).shape == (H, W, 3),
             f"{name}: /frame.png without PIL is no {W}x{H} PNG")
        out["png_ms"] = min(png_ms)
        out["png_bytes"] = len(body)
        key("Escape")
        until(lambda: v._stop.is_set() and not v._render_thread.is_alive()
              and httpd.socket.fileno() == -1, "ESC to stop the server")
        out["final"] = v.stats()

    base = None
    _, dt, counts = run_path(torch, name, drive, eng.intersect_fn.accel)
    add(counts)
    need(out["final"]["error"] is None and v.last_error is None,
         f"{name}: {v.last_error}")
    print(f"main path {name}: {W}x{H}, {BOUNCES} bounces, fast, accels "
          f"{out['accels']}; viewer_fps {out['stats']['viewer_fps']:.2f} "
          f"(the loop's average), {out['fps']:.2f} frames published a second "
          f"over {FPS_WINDOW} s, samples/s {out['stats']['samples_per_sec']:.2f}"
          f"; '+' to depth {BOUNCES + 1} re-picked; denoised "
          f"{out['denoise_fps']:.2f} frames/s, error None; "
          + (f"/stream.mjpg {out['jpeg_parts']} JPEG parts with PIL; "
             if "jpeg_parts" in out else "no PIL; ")
          + f"/frame.png encode {out['png_ms']:.1f} ms (io.image.png_bytes "
          f"on the host, the render thread running without JPEG, "
          f"{out['png_bytes']} bytes); 404 without PIL; ESC stopped the "
          f"server; all {dt:.2f} s; launches {counts}")


# check_slice24: multi-device rendering (`parallel/`), 1080p, 5 bounces.
SLICE24_SPP = 2   # spp of check_slice24's sharded renders
# The adaptive render of its 2-rank world: tests/test_adaptive.py's
# tolerance and sample range, and a bucket floor below the engine's 4096
# (each rank's bucket halves from 1,036,800 lanes).
SLICE24_ADAPTIVE = dict(tol=0.25, max_spp=12, min_spp=2)
SLICE24_MIN_BUCKET = 1024
SLICE24_PRESET = dict(fov=60.0, yaw=0.0, pitch=0.0, shift=(0.0, 0.0, 0.0))
# world -> its paths: (name, scene, RenderConfig fields); "resume" also
# checkpoints after its first sample, "adaptive" renders adaptively.
SLICE24_PATHS = {
    "one": (("megakernel cornell nee tiled", "cornell",
             dict(mode="parity", nee=True)),
            ("wavefront cornell-analytic tiled", "cornell-analytic",
             dict(model="wavefront", mode="fast"))),
    "two": (("megakernel cornell tiled resume", "cornell",
             dict(mode="parity")),
            ("wavefront cornell-analytic tiled", "cornell-analytic",
             dict(model="wavefront", mode="fast")),
            ("wavefront cornell tiled adaptive", "cornell",
             dict(model="wavefront", mode="parity"))),
}


def slice24_engine(world, scene_name, fields, devices):
    """A 1080p engine of check_slice24 on this process's current GPU."""
    from opencl_path_tracer_tpu_torch.config import CameraConfig, RenderConfig
    from opencl_path_tracer_tpu_torch.runtime.engine import RenderEngine
    from opencl_path_tracer_tpu_torch.scene import library
    if scene_name == "cornell":
        scene = library.cornell_box(with_spheres=True, device="cuda")
    else:
        scene = library.cornell_box(with_spheres=True, analytic_spheres=True,
                                    device="cuda")
    cfg = RenderConfig(width=W, height=H, iterations=BOUNCES,
                       camera=CameraConfig(**SLICE24_PRESET),
                       devices=devices, **fields)
    return RenderEngine(scene, cfg, device="cuda")


def slice24_run(torch, eng, name, ckpt=None):
    """Drive one of check_slice24's paths on `eng` through run_path (the
    counts reset before, every kernel of the path launched): SLICE24_SPP
    samples, the adaptive render for an 'adaptive' path, a checkpoint
    after the first sample of a 'resume' path. Then 2 more samples timed
    on their own (wall ms a sample). Returns the image (float32, top row
    first; a collective over a mesh), the samples by pixel of an adaptive
    render, the launches, the buckets and the timings."""
    import torch.distributed as dist
    from opencl_path_tracer_tpu_torch.parallel import shard
    from opencl_path_tracer_tpu_torch.runtime import engine as engine_mod

    def drive():
        if name.endswith("adaptive"):
            engine_mod.ADAPTIVE_MIN_BUCKET = SLICE24_MIN_BUCKET
            eng.render_adaptive(progress=False, **SLICE24_ADAPTIVE)
        elif name.endswith("resume"):
            eng.render(1, progress=False)
            eng.save(ckpt)
            eng.render(SLICE24_SPP - 1, progress=False)
        else:
            eng.render(SLICE24_SPP, progress=False)

    _, dt, counts = run_path(torch, name, drive, eng.intersect_fn.accel)
    out = dict(image=eng.image(apply_tonemap=False), launches=counts,
               ms=dt * 1e3, accel=eng.intersect_fn.accel,
               buckets=list(getattr(eng, "adaptive_buckets", [])))
    if name.endswith("adaptive"):
        pix, smp = eng.state.pixel, eng.state.samples
        if eng.mesh is not None:
            pix = shard.all_gather_lanes(pix, eng.mesh)
            smp = shard.all_gather_lanes(smp, eng.mesh)
        by_px = torch.zeros(W * H, dtype=torch.int32, device="cuda")
        by_px[pix.long()] = smp
        out["samples"] = by_px.cpu().numpy()
        return out
    if eng.mesh is not None:
        # the ranks start the timed samples together
        done = torch.zeros(1, device="cuda")
        dist.all_reduce(done)
        done.item()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.render(2, progress=False)
    out["ms_sample"] = (time.perf_counter() - t0) * 1e3 / 2
    return out


def slice24_rank(world, devices, ckpt):
    """One rank of a check_slice24 world (module level: the launcher's
    ranks unpickle it by name): every path of SLICE24_PATHS[world] over
    the world's mesh, inside plain_guard entered here, with the launch
    counts of this rank. Rank 0 returns the images; every rank its
    counts and timings."""
    import torch
    import torch.distributed as dist
    import_port()
    rank = dist.get_rank()
    out = {}
    with plain_guard():
        for name, scene_name, fields in SLICE24_PATHS[world]:
            eng = slice24_engine(world, scene_name, fields, devices)
            res = slice24_run(torch, eng, name, ckpt)
            if rank:
                res.pop("image")
                res.pop("samples", None)
            out[name] = res
    return dict(rank=rank, world=dist.get_world_size(),
                backend=dist.get_backend(), paths=out)


def check_slice24(torch, np, smi):
    """Multi-device rendering at 1920x1080, 5 bounces, SLICE24_SPP spp
    (the module docstring): a world of one NCCL rank (devices=0, every
    visible GPU) and a world of two gloo ranks on cuda:0 (NCCL refuses
    two ranks on one GPU), each path torch.equal to the single-device
    engine's; the 2-rank checkpoint resumed on one device. Wall ms a
    sample for each world against one device, information only: the two
    ranks share one card. Returns the ranks' launches."""
    from opencl_path_tracer_tpu_torch.parallel.launch import launch
    from opencl_path_tracer_tpu_torch.runtime import engine as engine_mod
    t_phase = time.perf_counter()
    launches = {}
    single = {}
    min_bucket = engine_mod.ADAPTIVE_MIN_BUCKET
    with plain_guard(), tempfile.TemporaryDirectory(
            prefix="ptx-slice24-") as tmp:
        ckpt = os.path.join(tmp, "tiled.npz")
        for world, ranks, devices, backend in (("one", 1, 0, None),
                                               ("two", 2, 2, "gloo")):
            res = launch(slice24_rank, ranks, (world, devices, ckpt),
                         device="cuda", backend=backend)
            need([r["rank"] for r in res] == list(range(ranks))
                 and all(r["world"] == ranks for r in res),
                 f"check_slice24 world {world}: ranks {res}")
            for name, scene_name, fields in SLICE24_PATHS[world]:
                ref = single.get(name)
                if ref is None:
                    eng = slice24_engine(world, scene_name, fields, 1)
                    ref = single[name] = slice24_run(
                        torch, eng, name, os.path.join(tmp, "single.npz"))
                got = res[0]["paths"][name]
                need(np.array_equal(got["image"], ref["image"]),
                     f"check_slice24 {name} over {ranks} rank(s): the image "
                     "is not torch.equal to the single-device engine's")
                if name.endswith("adaptive"):
                    need(np.array_equal(got["samples"], ref["samples"]),
                         f"check_slice24 {name}: samples by pixel differ "
                         "from the single-device adaptive render's")
                    for r in res:
                        b = r["paths"][name]["buckets"]
                        need(len(set(b)) > 1, f"check_slice24 {name}: rank "
                             f"{r['rank']}'s bucket never halved ({b})")
                for r in res:
                    for k, v in r["paths"][name]["launches"].items():
                        launches[k] = launches.get(k, 0) + v
                ms = [r["paths"][name].get("ms_sample") for r in res]
                print(f"check_slice24 {name}: {ranks} rank(s), "
                      f"{res[0]['backend']}, devices={devices}, {W}x{H}, "
                      f"{BOUNCES} bounces, accel {got['accel']}: torch.equal "
                      f"to one device; launches by rank "
                      f"{[r['paths'][name]['launches'] for r in res]}; "
                      + (f"buckets by rank "
                         f"{[r['paths'][name]['buckets'] for r in res]}, "
                         f"mean spp {got['samples'].mean():.3f} (one device "
                         f"buckets {ref['buckets']})"
                         if name.endswith("adaptive") else
                         f"wall ms a sample (2 more samples, ranks' "
                         f"slowest) {max(ms):.3f} against one device's "
                         f"{ref['ms_sample']:.3f}")
                      + f"; {smi}")
            if world == "two":
                name = "megakernel cornell tiled resume"
                eng = slice24_engine(world, "cornell", dict(mode="parity"), 1)
                eng.load(ckpt)
                need(eng.state.sample == 1, "check_slice24: the 2-rank "
                     f"checkpoint holds sample {eng.state.sample}, not 1")
                _, _, counts = run_path(
                    torch, "megakernel cornell tiled resume",
                    lambda: eng.render(SLICE24_SPP - 1, progress=False),
                    eng.intersect_fn.accel)
                for k, v in counts.items():
                    launches[k] = launches.get(k, 0) + v
                need(np.array_equal(eng.image(apply_tonemap=False),
                                    single[name]["image"]),
                     "check_slice24: the 2-rank checkpoint resumed on one "
                     "device does not finish as the single-device render")
                print("check_slice24 megakernel cornell tiled resume: the "
                      "checkpoint of 2 ranks after 1 sample, resumed on one "
                      f"device for {SLICE24_SPP - 1} more: torch.equal to "
                      "one device's render")
    engine_mod.ADAPTIVE_MIN_BUCKET = min_bucket
    print(f"check_slice24: {time.perf_counter() - t_phase:.1f} s")
    return launches


# check_slice25: the last leftovers (`utils/`, the examples' twins), 1080p.
# (a) Each step below runs SLICE25_RUNS times from one fixed state and is
# compared leaf by leaf, bit for bit (`utils.check_deterministic`): name,
# scene, model, RenderConfig fields, the kernels the step launches. The
# Cornell preset camera, and the reference's own for the reference scene,
# as the main paths take them.
SLICE25_RUNS = 3
SLICE25_PATHS = (
    ("megakernel cornell-analytic minarg", "cornell-analytic", "megakernel",
     dict(accel="minarg"), ("minarg", "refine1", "spheres")),
    ("megakernel cornell tilecull", "cornell", "megakernel",
     dict(accel="tilecull"), ("tilecull", "refine1")),
    ("megakernel cornell pallas", "cornell", "megakernel",
     dict(accel="pallas"), ("dense",)),
    ("megakernel reference group", "reference", "megakernel",
     dict(accel="group"), ("group",)),
    ("megakernel stress cluster", "stress", "megakernel",
     dict(accel="cluster"), ("cluster",)),
    ("megakernel stress pairwin", "stress", "megakernel",
     dict(accel="pairwin"), ("dense", "pair_cand", "pair_visit",
                             "attr_fetch")),
    ("megakernel stress pair", "stress", "megakernel",
     dict(accel="pair"), ("dense", "pair_cand", "pair_vpu")),
    ("megakernel stress pairmx", "stress", "megakernel",
     dict(accel="pairmx"), ("dense", "pair_cand", "pair_visit_full")),
    ("megakernel stress march", "stress", "megakernel",
     dict(accel="march"), ("materialize", "march", "dense")),
    ("megakernel stress flat", "stress", "megakernel",
     dict(accel="flat"), ("materialize", "march", "flat_march", "dense")),
    ("megakernel cornell nee", "cornell", "megakernel",
     dict(accel="minarg", nee=True), ("minarg", "refine1", "anyhit")),
    ("megakernel many-lights nee", "many-lights", "megakernel",
     dict(accel="minarg", nee=True),
     ("minarg", "refine1", "sphere_table", "anyhit")),
    ("megakernel reference smooth", "reference", "megakernel",
     dict(accel="minarg", smooth=True), ("minarg", "smooth_refine")),
    # The walker is plain PyTorch (no kernel); 2.7 s a step at 1080p.
    ("megakernel cornell median", "cornell", "megakernel",
     dict(accel="median", accel_force=True), ()),
    ("wavefront cornell-analytic nee", "cornell-analytic", "wavefront",
     dict(accel="minarg", nee=True),
     ("minarg", "refine1", "spheres", "anyhit")),
    ("wavefront stress pairwin", "stress", "wavefront",
     dict(accel="pairwin"), ("dense", "pair_cand", "pair_visit",
                             "attr_fetch")),
)
# The fused fast pipeline's step, the lazy step and the pixel sums.
SLICE25_OTHER = {
    "fused cornell": ("plucker_cand", "plucker_refine", "dense",
                      "fused_step"),
    "lazy stress": ("lazy_march", "dense"),
    "wavefront cornell-analytic lanes": ("minarg", "refine1", "spheres"),
}
SLICE25_LANES = 4   # lanes a pixel of the pixel sums (3+ can reorder)
SLICE25_LANE_STEPS = 12   # wavefront steps before the pixel sums
SLICE25_LANE_SEED = 7   # the 'permuted' layout's permutation
SLICE25_PIXEL_RUNS = 6   # reruns of each pixel sum
# (b) The oracle: a parity render of 1080p cornell against the scalar
# prog.cl walk on ORACLE_PIXELS pixels chosen from ORACLE_SEED, at
# tests/test_oracle.py's tolerance; the Lehmer states exact.
ORACLE_PIXELS, ORACLE_SEED, ORACLE_SPP = 256, 25, 2
ORACLE_RTOL, ORACLE_ATOL = 2e-5, 2e-6
# (c) device_timer against time_ms on one 1080p cornell sample.
TIMER_ITERS, TIMER_TURNS = 5, 5
K6_GLOBAL = "tilecull_cull_kernel"   # csrc/tilecull.cu's __global__ body
# (d) The twins of examples/: file stem, argv (besides --out or --ckpt
# into a temporary directory), the marker the JAX script's test checks,
# and the kernels each must launch (a tuple: any one of them; 'auto'
# picks 'tilecull' or 'minarg' on the card by the camera).
SLICE25_TWINS = (
    ("01_render_cornell", ["--size", f"{W}x{H}"], "out", "wrote",
     (("minarg", "tilecull"), "refine1")),
    ("02_custom_scene", ["--obj", "tests/assets/models/sphere.obj"], "out",
     "triangles", (("minarg", "tilecull"), "refine1")),
    ("03_checkpoint_resume", [], "ckpt", "bit-exact",
     (("minarg", "tilecull"), "refine1")),
    ("04_multi_device", ["--devices", "1"], "out", "mesh: 1",
     ("minarg", "refine1")),
    ("05_low_level_ops", ["--size", f"{W}x{H}"], None, "hits",
     ("minarg", "refine1")),
    ("06_smooth_and_spheres", [], "out", "smooth-shaded",
     ("minarg", "refine1", "spheres", "smooth_refine")),
    ("07_uv_checker", [], "out", "checker balance", ("minarg", "refine1")),
    ("08_textured_obj", [], "out", "1 texture", ("minarg", "refine1")),
    ("09_environment_light", ["--envmap", "sunsky"], "out", "env-lit",
     (("minarg", "tilecull"), "refine1", "anyhit")),
    ("10_nee_and_adaptive", [], "out", "NEE+adaptive",
     ("minarg", "refine1")),
    ("11_many_lights", ["--lights", "64"], "out", "right: distance",
     (("minarg", "tilecull"), "refine1", "sphere_table", "anyhit")),
    ("12_spectral_dispersion", [], "out", "channel split",
     (("minarg", "tilecull"), "refine1", "spheres")),
)
for _name, _s, _m, _f, _k in SLICE25_PATHS:
    PATH_KERNELS[f"determinism {_name}"] = _k
for _name, _k in SLICE25_OTHER.items():
    PATH_KERNELS[f"determinism {_name}"] = _k
PATH_KERNELS["megakernel cornell oracle"] = ("minarg", "refine1")


def check_slice25(torch, np, scenes):
    """The last leftovers at 1920x1080, 5 bounces, inside `plain_guard`:
    (a) every accel's step, the fused and lazy steps and the pixel sums
    rerun from one state and compared bit for bit; (b) a parity render
    against the port's scalar oracle; (c) `device_timer` and
    `trace_profile` on one sample; (d) the twelve examples' twins in
    process. Returns the launches of (a), (b) and (d)."""
    t_phase = time.perf_counter()
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    with plain_guard(), tempfile.TemporaryDirectory(
            prefix="ptx-slice25-") as tmp:
        t0 = time.perf_counter()
        _slice25_determinism(torch, scenes, add)
        print(f"check_slice25 (a): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        _slice25_oracle(torch, np, scenes["cornell"], add)
        print(f"check_slice25 (b): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        _slice25_profiling(torch, scenes["cornell"], tmp)
        print(f"check_slice25 (c): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        _slice25_twins(torch, add, tmp)
        print(f"check_slice25 (d): {time.perf_counter() - t0:.1f} s")
    print(f"check_slice25: {time.perf_counter() - t_phase:.1f} s")
    return launches


def slice25_cfg(scene_name, mode="fast", **kw):
    """A 1080p RenderConfig of check_slice25: the Cornell preset camera,
    the reference's own for the reference scene."""
    from opencl_path_tracer_tpu_torch.config import CameraConfig, RenderConfig
    camera = (CameraConfig() if scene_name.startswith("reference")
              else CameraConfig(**SLICE24_PRESET))
    return RenderConfig(width=W, height=H, iterations=BOUNCES, mode=mode,
                        camera=camera, **kw)


def _slice25_check(torch, name, fn, state, accel, add, bad):
    """check_deterministic(fn, state, runs=SLICE25_RUNS) as the main path
    `determinism <name>` (every kernel of the step launched); prints one
    line, and records the differing leaves in `bad`."""
    from opencl_path_tracer_tpu_torch.utils import check_deterministic
    t0 = time.perf_counter()
    diff, _, counts = run_path(
        torch, f"determinism {name}",
        lambda: check_deterministic(fn, state, runs=SLICE25_RUNS), accel)
    add(counts)
    if diff:
        bad[name] = diff
    print(f"check_slice25 determinism {name} ({W}x{H}, {BOUNCES} bounces, "
          f"accel {accel}, {SLICE25_RUNS} runs, "
          f"{time.perf_counter() - t0:.1f} s): "
          + ("deterministic" if not diff else f"differs in {diff}")
          + f"; launches {counts}")


def _slice25_determinism(torch, scenes, add):
    """Part (a). A step is a pure function of its state: the megakernel's
    `trace_sample` from a fresh state, the wavefront's step from the state
    one step in. Fails if any path differs between runs."""
    from opencl_path_tracer_tpu_torch.models import (
        lazy, megakernel, pipeline, wavefront)
    from opencl_path_tracer_tpu_torch.ops import rng
    from opencl_path_tracer_tpu_torch.runtime.engine import RenderEngine
    from opencl_path_tracer_tpu_torch.scene import library
    dev = scenes["cornell"].tris.device
    key = rng.key(1)
    bad = {}
    for name, sname, model, fields, _ in SLICE25_PATHS:
        eng = RenderEngine(scenes[sname], slice25_cfg(sname, model=model,
                                                      **fields), device=dev)
        cam, mats = eng.camera, eng.scene.mats
        kw = dict(intersect_fn=eng.intersect_fn, iterations=BOUNCES,
                  mode="fast", key=key, nee=eng.nee,
                  occluded_fn=eng.occluded)
        if model == "megakernel":
            def fn(st, kw=kw, cam=cam, mats=mats):
                return megakernel.trace_sample(cam, mats, st, **kw)
            state = megakernel.init_state(W * H, 1, device=dev)
        else:
            def fn(st, kw=kw, cam=cam, mats=mats):
                return wavefront.wavefront_step(cam, mats, st, **kw)
            state = fn(wavefront.init_wavefront(cam, W * H, mode="fast",
                                                key=key))
        _slice25_check(torch, name, fn, state, eng.intersect_fn.accel, add,
                       bad)
        del eng, state
    corn, stress = scenes["cornell"], scenes["stress"]
    cam = library.cornell_camera(W, H, device=dev)
    # The fused fast pipeline (K13a, K13b, K4, K5) one step in; its
    # buffers are cloned for each run.
    (F, I, ctr), step, _ = pipeline.make_fast_pipeline(
        corn, cam, width=W, height=H, iterations=BOUNCES, key=key)
    F, I, ctr = step(F, I, ctr)
    _slice25_check(torch, "fused cornell",
                   lambda s: step(s[0].clone(), s[1].clone(), s[2]),
                   (F, I, ctr), None, add, bad)
    del F, I
    # The lazy step (K20, K4 net) one step in, as lazy_path builds it.
    lstep, init, _ = lazy.make_lazy_pipeline(stress.tris, cs=512, tr=256,
                                             K=4, tail=4096, device=dev)
    st = lstep(cam, stress.mats, init(cam, W * H, mode="fast", key=key),
               iterations=BOUNCES, mode="fast", key=key)
    _slice25_check(torch, "lazy stress",
                   lambda s: lstep(cam, stress.mats, s, iterations=BOUNCES,
                                   mode="fast", key=key),
                   st, None, add, bad)
    del st
    _slice25_pixel_sums(torch, scenes["cornell-analytic"], cam, add, bad)
    need(not bad, f"check_slice25: steps that differ between runs: {bad}")


def _slice25_pixel_sums(torch, ana, cam, add, bad):
    """The pixel sums with SLICE25_LANES lanes a pixel (`colors_by_pixel`,
    the engine's `image()` and `display_u8_device()`, all through
    `wavefront.pixel_sum`) in three lane layouts: a pixel's lanes W x H
    apart ('repeat'), adjacent ('interleave': where CUDA's atomic
    `index_add_` reordered its float32 adds between runs on the H100) and
    in a seeded permutation ('permuted', as a lane sort leaves them).
    Each is rerun SLICE25_PIXEL_RUNS times, and the card's sums must
    equal the CPU's on the same lanes bit for bit."""
    import types
    from opencl_path_tracer_tpu_torch.models import wavefront
    from opencl_path_tracer_tpu_torch.ops import raygen, rng
    from opencl_path_tracer_tpu_torch.runtime.engine import (
        RenderEngine, make_intersect_fn)
    dev = ana.tris.device
    key = rng.key(1)
    n = W * H
    isect = make_intersect_fn(ana, "minarg")
    eng = RenderEngine(ana, slice25_cfg("cornell-analytic",
                                        model="wavefront", accel="minarg"),
                       device=dev)
    for layout in ("repeat", "interleave", "permuted"):
        ids = raygen.pixel_ids_like(n, device=dev)
        ids = (ids.repeat_interleave(SLICE25_LANES) if layout == "interleave"
               else ids.repeat(SLICE25_LANES))

        def steps(ids=ids):
            s = wavefront.init_wavefront(cam, n * SLICE25_LANES, mode="fast",
                                         key=key, ids=ids)
            for _ in range(SLICE25_LANE_STEPS):
                s = wavefront.wavefront_step(
                    cam, ana.mats, s, intersect_fn=isect, iterations=BOUNCES,
                    mode="fast", key=key)
            return s

        st, _, counts = run_path(torch, "determinism wavefront "
                                 "cornell-analytic lanes", steps, "minarg")
        add(counts)
        if layout == "permuted":
            gen = torch.Generator(device=dev).manual_seed(SLICE25_LANE_SEED)
            perm = torch.randperm(n * SLICE25_LANES, device=dev,
                                  generator=gen)
            st = wavefront._lanes(st, lambda x: x[perm])
        eng.state, eng._display = st, None
        per_px = torch.bincount(st.pixel.long()[st.samples > 0], minlength=n)
        for name, fn in (("colors_by_pixel",
                          lambda s: wavefront.colors_by_pixel(s, n)),
                         ("engine image", lambda s: eng.image(
                             apply_tonemap=False)),
                         ("engine display_u8_device",
                          lambda s: eng.display_u8_device())):
            diff = check_deterministic_counted(torch, fn, st)
            if diff:
                bad[f"{name} {layout}"] = diff
            print(f"check_slice25 determinism {name} {layout} ({W}x{H}, "
                  f"{SLICE25_LANES} lanes a pixel after {SLICE25_LANE_STEPS} "
                  f"steps, {int((per_px >= 3).sum())} pixels with 3+ lanes "
                  f"done, {SLICE25_PIXEL_RUNS} runs): "
                  + ("deterministic" if not diff else f"differs in {diff}"))
        host = types.SimpleNamespace(
            pixel=st.pixel.cpu(), samples=st.samples.cpu(),
            colors=tuple(c.cpu() for c in st.colors))
        wgt = st.samples.to(torch.float32)[:, None] * torch.stack(
            st.colors, -1)
        same = (torch.equal(wavefront.colors_by_pixel(st, n).cpu(),
                            wavefront.colors_by_pixel(host, n)),
                torch.equal(wavefront.pixel_sum(st.pixel, wgt, n).cpu(),
                            wavefront.pixel_sum(host.pixel, wgt.cpu(), n)))
        print(f"check_slice25 pixel sums {layout}: the card's colors_by_pixel "
              f"and float32 pixel_sum torch.equal to the CPU's: {same}")
        need(all(same), f"check_slice25 pixel sums {layout}: the card's "
             "sums differ from the CPU's")
        del st, host, wgt
    del eng

def check_deterministic_counted(torch, fn, state):
    """check_deterministic for a function that launches no kernel of the
    port (the pixel sums): none may launch."""
    from opencl_path_tracer_tpu_torch.ops.kernels import _build
    from opencl_path_tracer_tpu_torch.utils import check_deterministic
    _build.reset_launches()
    diff = check_deterministic(fn, state, runs=SLICE25_PIXEL_RUNS)
    need(not any(_build.launches.values()),
         f"check_slice25: a pixel sum launched {dict(_build.launches)}")
    return diff


def _slice25_oracle(torch, np, corn, add):
    """Part (b): a parity megakernel render of 1080p cornell ('auto')
    against the port's scalar prog.cl oracle on ORACLE_PIXELS pixels."""
    from opencl_path_tracer_tpu_torch.models import megakernel
    from opencl_path_tracer_tpu_torch.runtime.engine import RenderEngine
    from opencl_path_tracer_tpu_torch.utils import oracle
    dev = corn.tris.device
    eng = RenderEngine(corn, slice25_cfg("cornell", mode="parity"),
                       device=dev)
    name = "megakernel cornell oracle"
    _, dt, counts = run_path(
        torch, name, lambda: eng.render(ORACLE_SPP, progress=False),
        eng.intersect_fn.accel)
    add(counts)
    pix = np.sort(np.random.default_rng(ORACLE_SEED).choice(
        W * H, ORACLE_PIXELS, replace=False))
    t0 = time.perf_counter()
    colors, seeds = oracle.render_oracle(
        corn, eng.camera, width=W, height=H, iterations=BOUNCES,
        spp=ORACLE_SPP, seed=eng.cfg.seed, pixels=pix.tolist())
    t_oracle = time.perf_counter() - t0
    got = megakernel.colors_array(eng.state).cpu().numpy()[pix]
    lehmer = eng.state.rng_state.cpu().numpy().astype(np.uint32)[pix]
    same_rng = int((lehmer == seeds[pix]).sum())
    err = np.abs(got - colors[pix])
    ok = err <= ORACLE_ATOL + ORACLE_RTOL * np.abs(colors[pix])
    print(f"check_slice25 oracle: {name} ({W}x{H}, {BOUNCES} bounces, "
          f"{ORACLE_SPP} spp, parity, accel {eng.intersect_fn.accel}, "
          f"{dt:.2f} s; launches {counts}) against the scalar prog.cl "
          f"oracle on {ORACLE_PIXELS} pixels (seed {ORACLE_SEED}, "
          f"{t_oracle:.1f} s): Lehmer states equal on {same_rng}, colors "
          f"within rtol {ORACLE_RTOL}, atol {ORACLE_ATOL} on "
          f"{int(ok.all(axis=1).sum())}; max abs err {float(err.max()):.3g}; "
          f"{int((colors[pix].sum(axis=1) > 0).sum())} pixels lit")
    need(same_rng == ORACLE_PIXELS, "check_slice25 oracle: Lehmer states "
         f"differ on {ORACLE_PIXELS - same_rng} pixels")
    need(bool(ok.all()), "check_slice25 oracle: colors outside the "
         "oracle's tolerance")


def _slice25_profiling(torch, corn, tmp):
    """Part (c): `device_timer` on one 1080p cornell megakernel sample
    beside the smoke's CUDA-event `time_ms` (in turns), then one sample
    under `trace_profile`, whose trace must name K6's __global__
    function ('auto' = 'tilecull' on the card)."""
    import glob
    import statistics
    from opencl_path_tracer_tpu_torch.models import megakernel
    from opencl_path_tracer_tpu_torch.ops import rng
    from opencl_path_tracer_tpu_torch.runtime.engine import RenderEngine
    from opencl_path_tracer_tpu_torch.utils import device_timer, trace_profile
    dev = corn.tris.device
    eng = RenderEngine(corn, slice25_cfg("cornell"), device=dev)
    state = megakernel.init_state(W * H, 1, device=dev)

    def sample(st):
        return megakernel.trace_sample(
            eng.camera, eng.scene.mats, st, intersect_fn=eng.intersect_fn,
            iterations=BOUNCES, mode="fast", key=rng.key(1))

    turns = {"time_ms": [], "device_timer": []}
    for _ in range(TIMER_TURNS):
        turns["time_ms"].append(time_ms(torch, lambda: sample(state),
                                        TIMER_ITERS))
        turns["device_timer"].append(
            device_timer(sample, state, iters=TIMER_ITERS, warmup=1) * 1e3)
    med = {k: statistics.median(v) for k, v in turns.items()}
    spread = {k: max(v) - min(v) for k, v in turns.items()}
    print(f"check_slice25 profiling: one {W}x{H} cornell megakernel sample "
          f"(accel {eng.intersect_fn.accel}), {TIMER_TURNS} turns of "
          f"{TIMER_ITERS} calls: device_timer {med['device_timer']:.3f} ms "
          f"(spread {spread['device_timer']:.3f}, turns "
          f"{[round(v, 3) for v in turns['device_timer']]}), time_ms "
          f"{med['time_ms']:.3f} ms (spread {spread['time_ms']:.3f}, turns "
          f"{[round(v, 3) for v in turns['time_ms']]})")
    need(all(math.isfinite(v) for v in med.values()),
         f"check_slice25 profiling: a time is not finite: {med}")
    need(med["device_timer"] >= med["time_ms"] - spread["time_ms"],
         "check_slice25 profiling: device_timer is below time_ms less its "
         "spread")
    logdir = os.path.join(tmp, "profile")
    with trace_profile(logdir):
        sample(state)
    files = glob.glob(os.path.join(logdir, "trace_*.json"))
    need(len(files) == 1, f"check_slice25 profiling: trace files {files}")
    with open(files[0]) as fh:
        names = [e.get("name", "") for e in json.load(fh)["traceEvents"]]
    k6 = [n for n in names if K6_GLOBAL in n]
    print(f"check_slice25 trace_profile: {os.path.basename(files[0])}, "
          f"{os.path.getsize(files[0])} bytes, {len(names)} events, "
          f"{len(k6)} of K6 ({k6[0] if k6 else None})")
    need(k6, f"check_slice25 trace_profile: no event names {K6_GLOBAL}")


def _slice25_twins(torch, add, tmp):
    """Part (d): each twin's `main([...])` in this process (04's ranks in
    their own), its marker checked in what it printed, and its launches
    counted (04's from its ranks)."""
    import contextlib
    import importlib
    import io
    from opencl_path_tracer_tpu_torch.ops.kernels import _build
    twins = os.path.join(HERE, "examples_torch")
    if twins not in sys.path:
        sys.path.insert(0, twins)
    cwd = os.getcwd()
    os.chdir(HERE)   # 02's OBJ default is relative to the checkout
    try:
        for stem, argv, flag, marker, kernels in SLICE25_TWINS:
            mod = importlib.import_module(stem)
            shown = " ".join(argv)
            if flag is not None:
                ext = "npz" if flag == "ckpt" else "png"
                argv = [*argv, f"--{flag}",
                        os.path.join(tmp, f"{stem}.{ext}")]
            buf = io.StringIO()
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                ret = mod.main(argv)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = {k: v for k, v in _build.launches.items() if v}
            if stem == "04_multi_device":
                need(not counts, f"twin {stem}: this process launched "
                     f"{counts}; its ranks should")
                for rank in ret:
                    for k, v in rank.items():
                        counts[k] = counts.get(k, 0) + v
            out = buf.getvalue().strip()
            missing = [k for k in kernels
                       if not any(counts.get(a) for a in
                                  (k if isinstance(k, tuple) else (k,)))]
            extra = [k for k in CHECK_ONLY if counts.get(k)]
            last = out.splitlines()[-1] if out else ""
            print(f"check_slice25 twin {stem} {shown} ({dt:.1f} s): "
                  f"{last!r}; launches {counts}")
            need(marker in out, f"twin {stem}: no {marker!r} in {out!r}")
            if flag == "out":
                need(os.path.getsize(argv[-1]) > 0,
                     f"twin {stem}: empty image")
            need(not missing, f"twin {stem} did not launch {missing}")
            need(not extra, f"twin {stem} launched {extra}")
            add(counts)
    finally:
        os.chdir(cwd)

def slice22_rows(torch, inputs):
    """The timing rows of K10's full form on round 1's pairs of the
    'pairmx' shape: K10's operations (26 float32 per (pair, triangle)
    test of every visit and 2 x 48 per (pair, visit), 3 x 18 bf16
    multiply-adds) and bytes (keys and rays in, 28 per pair; the packs
    once) with five streams out (20 bytes per pair) in place of two. No
    single PyTorch call computes it: library_ms is null. The plain
    version runs on the first K10_PLAIN_PAIRS pairs only (a minute or
    more on the whole launch), so plain_ms is its time on those pairs,
    and the row adds `plain_pairs` (their count), `pairs` (the launch's)
    and `ms_on_plain_pairs`, the kernel's time on the same pairs."""
    from opencl_path_tracer_tpu_torch.ops.kernels import pair_mxu as pm
    rows = []
    for name in ("pair_visit_full", "pair_visit_full bounce"):
        args, nv, pre, plain_ms = inputs[name]
        keys_s, _, trig, tric, cs, trp, _ = args
        ppad = keys_s.shape[0]
        tests = nv * trp * cs
        extra = {"plain_pairs": pre[0].shape[0], "pairs": ppad,
                 "ms_on_plain_pairs": time_ms(
                     torch, lambda a=pre: pm.pair_visits_full(*a), 20)}
        rows.append((name, lambda a=args: pm.pair_visits_full(*a),
                     (plain_ms, extra),
                     26 * tests + 96 * nv * trp, 2 * 54 * tests,
                     28 * ppad + trig.numel() * 2 + tric.numel() * 4
                     + 20 * ppad))
    return rows


def timed(torch, fn):
    """(fn(), its wall time in ms), the device synchronised before and
    after: the plain versions' times, from the checks' own calls."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def device_ms(torch, fn, reps, what):
    """The mean device time of fn's kernels over `reps` calls, read from
    torch.profiler's kernel events as runtime/profile.py reads them: the
    spans of the port's own CUDA kernels (csrc/, in anonymous
    namespaces), by kernel, each kernel's mean span times its launches a
    call (its spans over reps, rounded), summed. Unlike time_ms it leaves
    out the host's cost per call (the arguments' checks, the output
    allocations, the ctypes launch), which sets time_ms below about
    0.1 ms.

    On an H100 torch.profiler has kept one kernel span fewer than were
    launched in every profile from some point of a smoke's run on (19 of
    20 calls, 39 of 40 where a call launches two kernels; idle time at
    the window's ends did not change it), so a kernel's mean is read
    from the spans the profiler kept. A profile that lost more than a
    tenth of a kernel's spans is taken again, up to three times; then
    the run fails. `what` names the row in the messages."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    seen = []
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = {}
        for e in prof.events():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and e.name.startswith(("(anonymous namespace)::",
                                           "void (anonymous namespace)::"))):
                spans.setdefault(e.name, []).append(e.time_range.elapsed_us())
        per_call = {k: round(len(v) / reps) for k, v in spans.items()}
        if spans and all(n >= 1 and abs(len(spans[k]) - n * reps)
                         <= reps // 10 for k, n in per_call.items()):
            lost = sum(n * reps - len(spans[k]) for k, n in per_call.items())
            if lost:
                print(f"{what}: torch.profiler kept "
                      f"{sum(map(len, spans.values()))} kernel spans of "
                      f"{sum(per_call.values()) * reps} in {reps} calls; "
                      "device time from each kernel's mean span")
            return sum(n * sum(spans[k]) / len(spans[k])
                       for k, n in per_call.items()) / 1e3
        seen.append({k: len(v) for k, v in spans.items()})
    need(False, f"{what}: torch.profiler's kernel spans of the port in "
         f"three profiles of {reps} calls each: {seen}")


def edges_reached(pack, p, d):
    """Edge tests K1's exact test reaches for the rays (p, d: (3, R) rows
    of an (8, R) pack) against the rows of `pack` (T, 24): t > 0, then
    each edge that passed."""
    c = pack[..., :16, None]

    def col(j):
        return c[..., j, :]

    def dot(b, v):
        return (col(b) * v[..., 0:1, :] + col(b + 1) * v[..., 1:2, :]
                + col(b + 2) * v[..., 2:3, :])

    t = (col(3) - dot(0, p)) / dot(0, d)
    ok = t > 0.0
    reached = 0
    for b in (4, 8, 12):
        reached += int(ok.sum())
        ok = ok & (dot(b, p) + t * dot(b, d) >= col(b + 3))
    return reached


def minarg_ops(torch, rays8, pack):
    """Float32 operations K1 needs on these inputs: 12 per pair for the
    plane test (two 3-term dots, a subtraction and a divide), 12 more for
    each edge test that is reached."""
    r = rays8.shape[1]
    reached = sum(edges_reached(pack, rays8[0:3, s:s + 16384],
                                rays8[3:6, s:s + 16384])
                  for s in range(0, r, 16384))
    return 12 * r * pack.shape[0] + 12 * reached


def pair_rows(torch, inputs):
    """The timing rows of K9, K10 and K11 at the stress scene's shapes:
    K9 at round 1 (l = 2) on the 1080p camera rays, K10 on round 1's
    pairs, K11 on the final winners of the camera rays.

    Operations and bytes: K9, per (ray, cluster) slab test on 7 axes
    (3 and the 4 DOP axes) 8 float32 operations each (2 subtractions, 2
    multiplies, min, max and the running max and min) and per ray 7
    reciprocals and 16 for the DOP projections; rays in (24 bytes), the
    table once, ids and entries out (4 (2 l + 1) bytes). K10, per
    (pair, triangle) test of every visit (trp pairs x cs triangles): the
    3 x 18 bf16 multiply-adds of E at the bf16 rate, and 26 float32
    operations (the two dots of t, the divide, 3 eps terms, 6 sign tests,
    the t test and the top-2 compare); per (pair, visit) 2 x 48 for the
    candidates' exact tests; keys and rays in (28 bytes per pair), the
    packs once, (t, g) out (8). K11: g in, four rows out (20 bytes per
    ray), and columns 0, 1, 2 and 16 of each distinct winning row (16
    bytes; its other columns are never read); library_ms is one PyTorch
    `index_select` of the four columns (`tric[g][:, (0, 1, 2, 16)]`,
    without the g < 0 zeros and the +0.0). No single PyTorch call
    computes K9 (slab tests and a rank selection) or K10: their
    library_ms is null."""
    from opencl_path_tracer_tpu_torch.ops.kernels import (
        pair_mxu as pm, sorted_intersect as si)
    r8, boxes_r, c = inputs["pair_cand"]
    r, cp = r8.shape[1], boxes_r.shape[0]
    rows = [("pair_cand", lambda: si.run_candidates(r8, boxes_r, 2, c),
             lambda: si.candidates_plain(r8, boxes_r, 2, c),
             8 * 7 * r * c + 23 * r, 0,
             24 * r + boxes_r.numel() * 4 + 4 * 5 * r)]
    keys_s, r8p, ms, cs, trp, c, nv = inputs["pair_visit"]
    ppad = keys_s.shape[0]
    tests = nv * trp * cs
    rows.append(("pair_visit",
                 lambda: pm.pair_visits(keys_s, r8p, ms.trig, ms.tric, cs,
                                        trp, c),
                 lambda: pm.pair_visits_plain(keys_s, r8p, ms.trig, ms.tric,
                                              cs, trp, c),
                 26 * tests + 96 * nv * trp, 2 * 54 * tests,
                 28 * ppad + ms.trig.numel() * 2 + ms.tric.numel() * 4
                 + 8 * ppad))
    keys_b, r8p_b, _, _, _, _, nv_b, plain_b = inputs["pair_visit bounce"]
    tests_b = nv_b * trp * cs
    rows.append(("pair_visit bounce",
                 lambda: pm.pair_visits(keys_b, r8p_b, ms.trig, ms.tric, cs,
                                        trp, c),
                 plain_b, 26 * tests_b + 96 * nv_b * trp, 2 * 54 * tests_b,
                 28 * keys_b.shape[0] + ms.trig.numel() * 2
                 + ms.tric.numel() * 4 + 8 * keys_b.shape[0]))
    g, tric = inputs["attr_fetch"]
    gi = g.long().clamp(min=0)
    cols = tric[:, [0, 1, 2, 16]].contiguous()
    rows_read = int(torch.unique(g[g >= 0]).numel())
    rows.append(("attr_fetch", lambda: pm.fetch_attrs(g, tric),
                 lambda: pm.fetch_attrs_plain(g, tric), 0, 0,
                 20 * g.shape[0] + 16 * rows_read,
                 lambda: cols.index_select(0, gi)))
    return rows


def slice6_rows(torch, inputs):
    """The timing rows of K12, K17 and K16: K12 on round 1's pairs of the
    stress camera rays at the 'pair' defaults and on the first-bounce
    pairs, K17 (early exit off) on the stress camera and first-bounce
    rays with clusters of 128, K16 on the reference camera and
    first-bounce rays. Operations, as K7's: 25 per (pair or ray,
    sub-block) box test made, then K1's 12 per (pair or ray, triangle)
    test plus 12 per edge test reached, in the sub-blocks whose box test
    passed (the counting entries' counts on the same inputs). Bytes: the
    rays once (24 per ray; K12 the key of every pair and the 24 of each
    real one, as it reads no ray for a dummy pair), the cluster rows once
    (the 17 columns read, 68 bytes a row), the sub-block tables, K17's
    lists as far as they are read, K16's unions, the outputs once (20
    bytes per pair or ray, K17 24). The plain times are the checks'
    single calls (K17's on the first-bounce rays on CLUSTER_PLAIN_TILES
    tiles). No single PyTorch
    call computes any of the three (a nearest ray-triangle hit per pair,
    tile or block), so library_ms is null."""
    from opencl_path_tracer_tpu_torch.ops.kernels import (
        cluster_kernel as ck, sorted_intersect as si)
    rows_out = []
    sub = inputs["pair_vpu scene"][0]
    for name, (keys, r8p, rows, k, plain_ms) in (
            ("pair_vpu", inputs["pair_vpu"]),
            ("pair_vpu bounce", inputs["pair_vpu bounce"])):
        c = rows.shape[0] // k - 1
        real = int((keys < c).sum())
        nsb = -(-k // si.SUB)
        _, (n_div, n_box, _, n_edge) = si.run_pairs_counted(keys, r8p, rows,
                                                            k, sub)
        p = keys.shape[0]
        rows_out.append((name, lambda keys=keys, r8p=r8p, rows=rows, k=k:
                         si.run_pairs(keys, r8p, rows, k, sub),
                         plain_ms, 25 * real * nsb + 12 * n_div
                         + 12 * n_edge, 0,
                         4 * p + 24 * real + 68 * rows.shape[0]
                         + 4 * sub.numel() + 20 * p))
        print(f"{name}: {real * nsb} (pair, sub-block) box tests over {p} "
              f"pairs, {n_box} passed; {n_div} (pair, triangle) tests and "
              f"{n_edge} edge tests in those (the bound's count; every "
              f"(pair, triangle) test of the real pairs would be "
              f"{real * k})")
    rr8, cnt, ids, ent, crows, kk, csub, plain_ms = inputs["cluster"]
    args = (rr8, cnt, ids, ent, crows, kk, 256)
    _, counts = ck.run_cluster_counted(*args, False, csub)
    (bargs, _, bcounts, bplain_ms) = inputs["cluster bounce"]
    for name, a, (n_div, _, _, n_edge, n_made), p_ms in (
            ("cluster", args, counts, plain_ms),
            ("cluster bounce", bargs, bcounts, bplain_ms)):
        g = a[1].shape[0]
        rows_out.append((name, lambda a=a: ck.run_cluster(*a, False, csub),
                         p_ms, 25 * n_made + 12 * n_div + 12 * n_edge, 0,
                         24 * a[0].shape[0] + 4 * g + 8 * int(a[1].sum())
                         + 68 * crows.shape[0] + 4 * csub.numel()
                         + 24 * a[0].shape[0]))
        print(f"{name}: {n_made} (ray, sub-block) box tests, {n_div} "
              f"(ray, triangle) tests and {n_edge} edge tests in the "
              f"sub-blocks they pass (the bound's count), "
              f"{int(a[1].sum())} listed clusters over {g} tiles")
    for name, rname in (("group", "camera"), ("group bounce", "bounce")):
        union, g8, grows, k16, gsub, plain_ms = inputs[f"group {rname}"]
        n_div, _, _, n_edge, n_made = inputs[f"counts group {rname}"]
        block = g8.shape[0] // union.shape[0]
        rg = g8.shape[0]
        rows_out.append((name, lambda a=(union, g8, grows, k16, block, gsub):
                         si.run_group(*a), plain_ms,
            25 * n_made + 12 * n_div + 12 * n_edge, 0,
            24 * rg + 4 * union.shape[0] + 68 * grows.shape[0]
            + 4 * gsub.numel() + 20 * rg))
        print(f"{name}: {n_made} (ray, sub-block) box tests, {n_div} (ray, "
              f"triangle) tests and {n_edge} edge tests in the sub-blocks "
              f"they pass (the bound's count) over {rg} rays")
    return rows_out


def slice7_rows(torch, inputs):
    """The timing rows of K18, K18m, K19 and K20 at the stress scene's
    1080p shapes: K18 and K18m on 'march' round 1 of the camera rays, K19
    on 'flat' round 1 of the camera and of the first-bounce rays, K20 on
    the lazy pipeline's second step.

    Operations (K10's count): per (lane, triangle) test of a real visit
    (tr lanes x cs triangles; dummies none) 3 x 18 bf16 multiply-adds for
    E at the bf16 rate and 26 float32 operations, and per (lane, visit) 2
    x 48 for the candidates' exact tests. Bytes: the rays' six rows and
    the features' 18 rows read (60 bytes a lane), the packs once, the list
    (4 bytes a visit, K19 8), the seven rows out (28 bytes a lane), K19's
    and K20's start rows (28 and 24) and K20's mask in and out. K18m: its
    three buffers read and written once; library_ms is `.clone()` of the
    three. The plain times are the checks' calls on the first
    PLAIN_BLOCKS blocks. No single PyTorch call computes K18, K19 or K20:
    their library_ms is null."""
    from opencl_path_tracer_tpu_torch.ops.kernels import (
        flat_march as fm, lazy_march as lm, march_kernel as mk)
    rows = []
    clist, r8s, feat, ms, cs, K, tr, nv, plain_ms = inputs["march"]
    n = r8s.shape[1]
    packs = ms.trig.numel() * 2 + ms.tric.numel() * 4

    def visit_ops(visits, tr_, cs_):
        tests = visits * tr_ * cs_
        return 26 * tests + 96 * visits * tr_, 2 * 54 * tests

    ops, bf16 = visit_ops(nv, tr, cs)
    rows.append(("march", lambda: mk.run_march(clist, r8s, feat, ms, cs, K,
                                               tr),
                 plain_ms, ops, bf16, 60 * n + packs + 4 * clist.numel()
                 + 28 * n))
    nbytes = clist.numel() * 4 + r8s.numel() * 4 + feat.numel() * 2
    rows.append(("materialize", lambda: mk.materialize(clist, r8s, feat),
                 lambda: mk.materialize_plain(clist, r8s, feat), 0, 0,
                 2 * nbytes,
                 lambda: (clist.clone(), r8s.clone(), feat.clone())))
    vb, vc, f8, ffeat, rows0, fs, fcs, ftr, fv, fplain_ms = inputs[
        "flat_march"]
    fn = f8.shape[1]
    ops, bf16 = visit_ops(fv, ftr, fcs)
    rows.append(("flat_march", lambda: fm.run_flat(vb, vc, f8, ffeat, rows0,
                                                   fs, fcs, ftr),
                 fplain_ms, ops, bf16,
                 60 * fn + fs.trig.numel() * 2 + fs.tric.numel() * 4
                 + 8 * vb.numel() + 28 * fn + 28 * fn))
    # K19 again on the first-bounce rays, where the main path spends its
    # time (check_slice12's input).
    bargs, bv, bplain_ms = inputs["flat_march bounce"]
    bn = bargs[2].shape[1]
    ops, bf16 = visit_ops(bv, ftr, fcs)
    rows.append(("flat_march (first-bounce rays)",
                 lambda: fm.run_flat(*bargs), bplain_ms, ops, bf16,
                 60 * bn + fs.trig.numel() * 2 + fs.tric.numel() * 4
                 + 8 * bargs[0].numel() + 28 * bn + 28 * bn))
    args, lv, lplain_ms = inputs["lazy_march"]
    clist_l, l8, lfeat, rows_in, vis, lsc, lcs, lk, ltr = args
    ln = l8.shape[1]
    ops, bf16 = visit_ops(lv, ltr, lcs)
    rows.append(("lazy_march", lambda: lm.run_lazy_march(*args), lplain_ms,
                 ops, bf16,
                 60 * ln + lsc.trig.numel() * 2 + lsc.tric.numel() * 4
                 + 4 * clist_l.numel() + 24 * ln + 28 * ln
                 + 2 * vis.numel() * 4))
    print(f"march: {nv * tr * cs} (lane, triangle) tests over {nv} visits; "
          f"flat_march: {fv * ftr * fcs} over {fv} (first-bounce rays: "
          f"{bv * ftr * fcs} over {bv}); lazy_march: {lv * ltr * lcs} over "
          f"{lv}")
    return rows


def slice8_rows(torch, inputs):
    """The timing rows of K14 and K15 on the cornell camera and
    first-bounce rays, and, beside them in the same call, K1 + K2 on the
    same rays, K4 on the camera rays, K4 at the stress tails' shape
    (16,384 lanes of the stress camera rays, every 126th, against 99,380
    triangles), and the yardstick of K15's dot stage alone: the TPU
    kernel's matmul, torch.matmul(trig, rays8) with trig the (8 T, 8) rows
    of the eight dots, with TF32 off, in 16 column chunks.

    K14's and K15's bounds, as K6's: from their counting entries'
    counts (check_slice16), 12 float32 operations per test that reached
    the divide and per edge test reached, 25 per box test made; bytes:
    the rays (six rows), the pack and its table read once, five rows out
    (K15 six). The first kernels' bound, K1's operations on every (ray,
    triangle) pair (12 per pair and per edge test reached), is printed
    beside it. The plain times are check_slice8's calls. No single PyTorch
    call computes either: library_ms is null."""
    from opencl_path_tracer_tpu_torch.ops.kernels import (
        intersect_kernel as k1, plucker_kernel as k2)
    rows = []
    for rname, tag in (("camera", ""), ("bounce", " bounce")):
        rays8, pack, sub, f_ms, m_ms = inputs[f"dense16 cornell {rname}"]
        r, t = rays8.shape[1], pack.shape[0]
        every_pair = minarg_ops(torch, rays8, pack) / PEAK_FP32_FLOPS * 1e3
        for name, fn, plain_ms, n_out in (
                ("minarg_fused", k2.minarg_fused, f_ms, 5),
                ("mxu", k1.mxu, m_ms, 6)):
            n_div, _, _, n_edge, n_made = inputs[
                f"counts {name} cornell {rname}"]
            rows.append((name + tag,
                         lambda fn=fn, a=(rays8, pack, sub): fn(*a),
                         plain_ms, 25 * n_made + 12 * n_div + 12 * n_edge, 0,
                         24 * r + 96 * t + sub.numel() * 4 + 4 * n_out * r))
            print(f"{name} on the cornell {rname} rays: {n_made} (ray, "
                  f"sub-block) box tests, {n_div} (ray, triangle) tests and "
                  f"{n_edge} edge tests in the sub-blocks they pass (the "
                  "bound's count); the first kernel's bound, every pair "
                  f"tested: {every_pair:.4f} ms by operations")
    rays8, pack = inputs["dense16 cornell camera"][:2]
    r, t = rays8.shape[1], pack.shape[0]
    t1, g1 = k1.minarg(rays8, pack)
    ms1 = time_ms(torch, lambda: k1.minarg(rays8, pack), 20)
    ms2 = time_ms(torch, lambda: k2.refine1(t1, g1, pack), 20)
    ms4 = time_ms(torch, lambda: k1.dense(rays8, pack), 20)
    print(f"cornell camera rays ({r}): minarg {ms1:.4f} + refine1 {ms2:.4f} "
          f"= {ms1 + ms2:.4f} ms, dense {ms4:.4f} ms (beside minarg_fused "
          "and mxu below)")
    b8 = inputs["dense16 cornell bounce"][0]
    tb, gb = k1.minarg(b8, pack)
    ms1 = time_ms(torch, lambda: k1.minarg(b8, pack), 20)
    ms2 = time_ms(torch, lambda: k2.refine1(tb, gb, pack), 20)
    print(f"cornell first-bounce rays ({b8.shape[1]}): minarg {ms1:.4f} + "
          f"refine1 {ms2:.4f} = {ms1 + ms2:.4f} ms (beside minarg_fused "
          "bounce below)")
    r8t, spack = inputs["dense stress tail"]
    ms_tail = time_ms(torch, lambda: k1.dense(r8t, spack), 20)
    ops_tail = sum(minarg_ops(torch, r8t, spack[b:b + 8192])
                   for b in range(0, spack.shape[0], 8192))
    n = r8t.shape[1]
    bound_tail = max(ops_tail / PEAK_FP32_FLOPS,
                     (24 * n + 64 * spack.shape[0] + 24 * n)
                     / PEAK_HBM_BYTES) * 1e3
    print(f"dense at the stress tails' shape ({n} lanes x {spack.shape[0]} "
          f"triangles): {ms_tail:.4f} ms, bound {bound_tail:.4f} ms by "
          f"operations ({ops_tail:.4g} float32 operations)")
    dense_split_sweep(torch, "the stress tails' shape", r8t, spack,
                      (8, 16, 33, 130))
    sl, dpack, _ = inputs["dense"]
    dense_split_sweep(torch, "the fused pipeline's exact slice", sl, dpack,
                      (2,))
    # Row 8 g + k of trig: dot k of triangle g, its vector in columns 0-2
    # (a dot with P) or 3-5 (with D).
    trig = torch.zeros((t, 8, 8), device=rays8.device)
    for k in range(8):
        v = pack[:, 4 * (k // 2):4 * (k // 2) + 3]
        trig[:, k, 3 * (k % 2):3 * (k % 2) + 3] = v
    trig = trig.reshape(8 * t, 8)
    chunk = r // 16
    need(chunk * 16 == r, "the yardstick's chunks must cover the rays")
    buf = torch.empty((trig.shape[0], chunk), device=rays8.device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ms_mm = time_ms(torch, lambda: [
            torch.matmul(trig, rays8[:, s:s + chunk], out=buf)
            for s in range(0, r, chunk)], 5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    del buf
    print(f"mxu's dot stage alone: torch.matmul(trig {tuple(trig.shape)}, "
          f"rays8 (8, {r})) with TF32 off, in 16 chunks: {ms_mm:.4f} ms")
    return rows


def dense_split_sweep(torch, where, rays8, pack, others):
    """K4 launched with the splits its wrapper picks (`dense_splits`) and
    with one chunk (the single loop), timed in turns (single, picked,
    picked, single), and with each count of splits in `others` (chunks of
    whole 256-triangle tiles); every launch shape's outputs equal the
    wrapper's (torch.equal)."""
    from opencl_path_tracer_tpu_torch.ops.kernels import _build
    from opencl_path_tracer_tpu_torch.ops.kernels import intersect_kernel as k1
    r, t = rays8.shape[1], pack.shape[0]
    sms = torch.cuda.get_device_properties(rays8.device).multi_processor_count
    picked = k1.dense_splits(r, t, sms)[0]
    want = torch.stack(k1.dense(rays8, pack))

    def launcher(splits):
        tiles = -(-t // 256)
        chunk = -(-tiles // splits) * 256 if splits > 1 else t
        splits = -(-t // chunk)
        out = torch.empty((6, r), device=rays8.device)
        work = (torch.empty(2 * splits * r, device=rays8.device)
                if splits > 1 else 0)

        def run():
            _build.launch("dense", rays8, rays8.stride(0), pack, out,
                          out.stride(0), 0, r, t, splits, chunk, work)
        run()
        torch.cuda.synchronize()
        need(torch.equal(out, want), f"dense with {splits} splits differs "
             f"from the wrapper's launch on {where}")
        return splits, run

    one, pick = launcher(1)[1], launcher(picked)[1]
    turns = [time_ms(torch, f, 20) for f in (one, pick, pick, one)]
    sweep = []
    for s_ in others:
        splits, run = launcher(s_)
        sweep.append(f"{splits}: {time_ms(torch, run, 20):.4f}")
    print(f"dense on {where}: in turns one loop, {picked} splits (the "
          f"wrapper's), {picked}, one loop: "
          + ", ".join(f"{x:.4f}" for x in turns) + " ms; by splits: "
          + ", ".join(sweep) + " ms (outputs equal)")


def measure(torch, inputs, errs, launches):
    from opencl_path_tracer_tpu_torch.models import fused_step as fs
    from opencl_path_tracer_tpu_torch.ops.kernels import (
        intersect_kernel as k1, plucker_kernel as k2, shading_kernel as k8,
        sphere_kernel as k3, tilecull_kernel as tk)
    rows = []   # name, kernel, plain, fp32 ops, bf16 ops, bytes
    rays8, pack = inputs["minarg"]
    r, t = rays8.shape[1], pack.shape[0]
    rows.append(("minarg", lambda: k1.minarg(rays8, pack),
                 lambda: k1.minarg_plain(rays8, pack),
                 minarg_ops(torch, rays8, pack), 0,
                 24 * r + 64 * t + 8 * r))
    t1, g1, pack2 = inputs["refine1"]
    rows.append(("refine1", lambda: k2.refine1(t1, g1, pack2),
                 lambda: k2.refine1_plain(t1, g1, pack2),
                 0, 0, 8 * r + 96 * t + 20 * r))
    rays8s, table = inputs["spheres"]
    rs, s = rays8s.shape[1], table.shape[0]
    hits = int((k3.spheres_plain(rays8s, table)[0] > 0).sum())
    rows.append(("spheres", lambda: k3.spheres(rays8s, table),
                 lambda: k3.spheres_plain(rays8s, table),
                 10 * rs + 19 * rs * s + 12 * hits, 0,
                 24 * rs + 32 * s + 20 * rs))
    # K4 on the pipeline's exact slice: K1's operations plus the
    # attribute fetch; 24 bytes of rays in and 24 out per ray.
    sl, dpack, hout = inputs["dense"]
    rl = sl.shape[1]
    rows.append(("dense", lambda: k1.dense(sl, dpack, out=hout),
                 lambda: k1.dense_plain(sl, dpack, out=hout),
                 minarg_ops(torch, sl, dpack), 0,
                 24 * rl + 64 * dpack.shape[0] + 24 * rl))
    # K13a: the E products (3 x 18 multiply-adds per pair) at the bf16
    # tensor-core rate; the float32 tail (the plane t: 12, the six
    # loosened sign tests and the t > 0 test: 7) at the float32 rate.
    # Pairs and pack bytes count the scene's triangles, not the zero rows
    # that pad the packs to whole chunks (they never accept).
    rays8c, trig, tric, tp = inputs["plucker_cand"]
    rc = rays8c.shape[1]
    rows.append(("plucker_cand",
                 lambda: k2.candidates(rays8c, trig, tric, live=tp),
                 lambda: k2.candidates_plain(rays8c, trig, tric),
                 19 * rc * tp, 2 * 54 * rc * tp,
                 24 * rc + tp * (3 * trig.shape[1] * 2 + tric.shape[1] * 4)
                 + 16 * rc))
    # K13b: the ray, the candidates and six rows out per ray; the table
    # its two gathered rows come from is an input read once (it stays in
    # L2: counting 2 x 68 bytes per ray put the bound above the measured
    # time).
    rays8r, cand, rpack = inputs["plucker_refine"]
    rr = rays8r.shape[1]
    rows.append(("plucker_refine", lambda: k2.refine(rays8r, cand, rpack),
                 lambda: k2.refine_plain(rays8r, cand, rpack),
                 2 * 48 * rr, 0, (24 + 16 + 24) * rr + rpack.numel() * 4))
    # K5: F and I read and written, H's rows read; about 300 float32
    # operations per lane (far below the byte time).
    F, I, ctr, hrows, ftab, key = inputs["fused_step"]
    nl = F.shape[1]
    rows.append(("fused_step",
                 lambda: fs.fused_step(F, I, ctr, hrows, ftab, key, BOUNCES),
                 lambda: fs.step_plain(F, I, ctr, hrows, ftab, key, BOUNCES),
                 300 * nl, 0,
                 (F.shape[0] * 4 + I.shape[0] * 4) * 2 * nl
                 + hrows.shape[0] * 4 * nl))
    # K7 on the NEE shadow rays of bounces 0, 1 and 2: 25 operations per
    # group slab test and sub-block box test it makes, K1's 12 per
    # (ray, triangle) test and per edge test reached in the sub-blocks
    # its rule leaves (its counting entry's counts); rays and rmax in
    # once, the pack and its tables once, a flag byte out. K6 on the
    # camera and first-bounce rays likewise, (t, g) out.
    for b in range(3):
        s8, rmax, gpack, groups, gsub, counts, plain_ms = inputs[
            f"anyhit bounce {b}"]
        n_div, _, _, n_edge, n_made = counts
        rows.append(("anyhit" + (f" bounce {b}" if b else ""),
                     lambda s8=s8, rmax=rmax: tk.anyhit(s8, rmax, gpack,
                                                        groups, gsub),
                     plain_ms, 25 * n_made + 12 * n_div + 12 * n_edge, 0,
                     (24 + 4 + 1) * s8.shape[1] + 64 * gpack.shape[0]
                     + groups.numel() * 4 + gsub.numel() * 4))
    # K7 at rmax 3.0e38 on the sunsky map's bounce-1 escape rays
    # (check_slice19), counted likewise.
    s8, rmax, gpack, groups, gsub, counts, plain_ms = inputs["anyhit escape"]
    n_div, _, _, n_edge, n_made = counts
    rows.append(("anyhit escape",
                 lambda a=(s8, rmax, gpack, groups, gsub): tk.anyhit(*a),
                 plain_ms, 25 * n_made + 12 * n_div + 12 * n_edge, 0,
                 (24 + 4 + 1) * s8.shape[1] + 64 * gpack.shape[0]
                 + groups.numel() * 4 + gsub.numel() * 4))
    s8 = inputs["anyhit"][0]
    ra = s8.shape[1]
    pairs7 = inputs["anyhit bounce 0"][5][0]
    for name, at, rname in (("tilecull", "tilecull", "camera"),
                            ("tilecull bounce", "bounce rays",
                             "first-bounce")):
        c8, cpack, cgroups, csub, plain_ms = inputs[at][:5]
        n_div, _, _, n_edge, n_made = inputs[f"counts tilecull {rname}"]
        rows.append((name, lambda a=(c8, cpack, cgroups, csub):
                     tk.tilecull(*a),
                     plain_ms, 25 * n_made + 12 * n_div + 12 * n_edge, 0,
                     (24 + 8) * c8.shape[1] + 64 * cpack.shape[0]
                     + cgroups.numel() * 4 + csub.numel() * 4))
    # K6 on the morton-presorted first-bounce rays (check_slice21).
    c8, cpack, cgroups, csub, plain_ms, counts6 = inputs[
        "tilecull presorted bounce"]
    n_div, _, _, n_edge, n_made = counts6
    rows.append(("tilecull presorted bounce",
                 lambda a=(c8, cpack, cgroups, csub): tk.tilecull(*a),
                 plain_ms, 25 * n_made + 12 * n_div + 12 * n_edge, 0,
                 (24 + 8) * c8.shape[1] + 64 * cpack.shape[0]
                 + cgroups.numel() * 4 + csub.numel() * 4))
    rc6 = inputs["tilecull"][0].shape[1]
    pairs6 = inputs["counts tilecull camera"][0]
    print(f"tests that reach the divide: anyhit {pairs7 / ra:.1f} per "
          f"shadow ray, tilecull {pairs6 / rc6:.1f} per camera ray (of "
          f"{inputs['tilecull'][1].shape[0]} triangles), the tests their "
          "rules leave")
    # K3b, from its counting entry (check_slice17): 25 operations per
    # (ray, group) box test made, 13 per pair whose disc is computed, 6
    # more per pair reaching the sqrt, 10 per ray and 12 per hit for the
    # normal; the rays, the table and the groups read once, five rows out.
    for name in ("sphere_table", "sphere_table bounce",
                 "sphere_table stress"):
        rb, tab, grp, p_ms, (made, _, n_disc, n_sqrt, _), hits_b = inputs[
            name]
        rsb = rb.shape[1]
        rows.append((name, lambda a=(rb, tab, grp): k3.sphere_table(*a),
                     p_ms, 25 * made + 13 * n_disc + 6 * n_sqrt + 10 * rsb
                     + 12 * hits_b, 0,
                     24 * rsb + 32 * tab.shape[0] + grp.data.numel() * 4
                     + 20 * rsb))
    # K8: the rays (six rows), t1 and g1 in, five rows out per ray; its
    # two tables, read once (they stay in L2); about 45 float32
    # operations per ray.
    r8k, t8, g8, pk8, spk8 = inputs["smooth_refine"]
    rk8, tk8 = r8k.shape[1], pk8.shape[0]
    rows.append(("smooth_refine",
                 lambda: k8.smooth_refine(r8k, t8, g8, pk8, spk8),
                 lambda: k8.smooth_refine_plain(r8k, t8, g8, pk8, spk8),
                 45 * rk8, 0, (24 + 8 + 20) * rk8 + (96 + 68) * tk8))
    # K1, K6 and K7 on the reference scene's rays, beside the cornell
    # times of the rows below. (Names of their own: the rows' lambdas
    # above read theirs when the loop below calls them.)
    ref = inputs["reference kernels"]
    rc8 = inputs["reference camera"]
    ref_ms = {
        "minarg": time_ms(torch, lambda: k1.minarg(rc8, ref[8]), 20),
        "tilecull": time_ms(torch, lambda: tk.tilecull(rc8, *ref[0:3]), 20),
        "anyhit": time_ms(torch, lambda: tk.anyhit(*ref[3:8]), 20),
    }
    print(f"reference ({ref[8].shape[0]} triangles) camera rays: minarg "
          f"{ref_ms['minarg']:.4f} ms, tilecull {ref_ms['tilecull']:.4f} ms; "
          f"NEE shadow rays: anyhit {ref_ms['anyhit']:.4f} ms")
    # K6 against K1 on incoherent rays: the first-bounce rays of cornell.
    b8, bpack, bgroups, bsub, _, mpack = inputs["bounce rays"]
    ms6 = time_ms(torch, lambda: tk.tilecull(b8, bpack, bgroups, bsub), 20)
    ms1 = time_ms(torch, lambda: k1.minarg(b8, mpack), 20)
    pairs_b = inputs["counts tilecull first-bounce"][0]
    print(f"cornell first-bounce rays: tilecull {ms6:.4f} ms, minarg "
          f"{ms1:.4f} ms; tilecull's tests that reach the divide "
          f"{pairs_b / b8.shape[1]:.1f} per ray")
    rows += pair_rows(torch, inputs)
    rows += slice22_rows(torch, inputs)
    rows += slice6_rows(torch, inputs)
    rows += slice7_rows(torch, inputs)
    rows += slice8_rows(torch, inputs)
    out = []
    for name, kern, plain, ops, bf16_ops, nbytes, *lib in rows:
        ms = time_ms(torch, kern, 20)
        dev_ms = device_ms(torch, kern, 20, name)
        # One call of each plain version (seconds each, at these shapes);
        # a row whose plain version ran on part of its input says which.
        extra = {}
        if isinstance(plain, tuple):
            plain, extra = plain
        plain_ms = plain if isinstance(plain, float) else timed(torch,
                                                                 plain)[1]
        library_ms = time_ms(torch, lib[0], 20) if lib else None
        t_ops = max(ops / PEAK_FP32_FLOPS, bf16_ops / PEAK_BF16_FLOPS) * 1e3
        t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
        kern_name = name.split(" ")[0]   # a row on another input
        src, repl = KERNEL_META[kern_name]
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": launches[kern_name], "max_abs_err": errs[kern_name],
            "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms, **extra,
        })
        print(f"{name}: {ms:.4f} ms, device {dev_ms:.4f} ms (plain "
              f"{plain_ms:.2f} ms"
              + (f" on {extra['plain_pairs']} of {extra['pairs']} pairs, "
                 f"the kernel {extra['ms_on_plain_pairs']:.4f} ms on them"
                 if extra else "")
              + (f", library {library_ms:.4f} ms" if lib else "")
              + f"), bound {max(t_ops, t_bytes):.4f} ms by "
              f"{out[-1]['bound_by']} ({ops:.4g} float32 and {bf16_ops:.4g} "
              f"bf16 operations, {nbytes:.4g} bytes), {launches[kern_name]} "
              "main-path launches")
    return out


def main() -> int:
    t_start = time.perf_counter()
    import numpy as np
    import torch
    need(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    import_port()
    from opencl_path_tracer_tpu_torch.scene import library
    smi = device_line(torch)
    build_line()
    scenes = {
        "cornell": library.cornell_box(with_spheres=True, device="cuda"),
        "cornell-analytic": library.cornell_box(
            with_spheres=True, analytic_spheres=True, device="cuda"),
        "cornell-sphere-lamp": library.cornell_box(
            with_spheres=True, analytic_spheres=True, sphere_lamp=True,
            device="cuda"),
        "many-lights": library.many_light_scene(64, device="cuda"),
        "reference": library.reference_scene(MODELS_DIR, smooth=True,
                                             device="cuda"),
        "reference-analytic": library.reference_scene(
            MODELS_DIR, smooth=True, analytic=True, device="cuda"),
        "cornell-smooth": library.cornell_box(
            with_spheres=True, smooth_spheres=True, device="cuda"),
        "stress": library.stress_scene(device="cuda"),
        "stress-smooth": library.stress_scene(smooth=True, device="cuda"),
        "stress-analytic": library.stress_scene(analytic=True,
                                                device="cuda"),
    }
    cam = library.cornell_camera(W, H, device="cuda")
    inputs, errs, cam_rays = check_kernels(
        torch, {k: scenes[k] for k in ("cornell", "cornell-analytic")}, cam)
    inputs.update(check_fused(torch, scenes["cornell"], cam, errs))
    inputs.update(check_slice3(torch, scenes, cam, cam_rays, errs))
    inputs.update(check_smooth(torch, scenes, errs))
    inputs.update(check_pairs(torch, scenes, cam, errs))
    inputs.update(check_slice6(torch, scenes, cam, cam_rays, errs))
    inputs.update(check_slice7(torch, scenes, cam, cam_rays, errs))
    inputs.update(check_slice8(torch, scenes, cam, cam_rays, errs))
    check_slice9(torch, scenes, cam_rays, inputs, errs)
    check_slice10(torch, scenes, cam_rays, inputs)
    check_slice11(torch, scenes, cam, cam_rays, inputs)
    inputs.update(check_slice12(torch, inputs))
    inputs.update(check_slice13(torch, inputs))
    inputs.update(check_slice14(torch, scenes, cam, cam_rays, inputs))
    inputs.update(check_slice15(torch, scenes, inputs))
    inputs.update(check_slice16(torch, scenes, inputs))
    inputs.update(check_slice17(torch, scenes, cam, cam_rays, inputs))
    check_goldens(torch, np)
    check_no_fallback(torch, scenes)
    launches = main_path(torch, np, scenes, cam)
    check_slice18(torch, scenes, launches)
    env_launches, env_inputs = check_slice19(torch, np, scenes)
    for k, v in env_launches.items():
        launches[k] += v
    for k, v in check_slice20(torch, np).items():
        launches[k] += v
    s21_launches, s21_inputs = check_slice21(torch, np, scenes)
    for k, v in s21_launches.items():
        launches[k] += v
    inputs.update(s21_inputs)
    s22_launches, s22_inputs = check_slice22(torch, np, scenes, cam, inputs,
                                             errs)
    for k, v in s22_launches.items():
        launches[k] += v
    inputs.update(s22_inputs)
    for k, v in check_slice23(torch, np, scenes).items():
        launches[k] += v
    for k, v in check_slice24(torch, np, smi).items():
        launches[k] += v
    inputs.update(env_inputs)
    kernels = measure(torch, inputs, errs, launches)
    # check_slice25 runs after the kernels' profiles: run before them, on an
    # H100 torch.profiler kept as few as 14 of 20 kernel spans a profile in
    # `measure` (PERF.md section 6). Its launches join the kernels line.
    s25 = check_slice25(torch, np, scenes)
    for row in kernels:
        row["launches"] += s25.get(row["name"].split(" ")[0], 0)
    print(f"check_slice25's launches, added to the kernels line: {s25}")
    print(f"smoke: {time.perf_counter() - t_start:.1f} s in all, the kernel "
          "build included")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
