"""K5: the fused fast-mode wavefront step (CUDA kernel and plain version).

Port of `opencl_path_tracer_tpu/models/fused_step.py`: `pack_state`,
`unpack_state`, `hits_to_pack`, `make_fused_step` and `_step_kernel`.

Everything of a fast-mode `wavefront_step` but the intersect, in one
pass over packed lane state: a (32, N) float32 pack F, an (8, N) int32
pack I and the hit rows H [t, nx, ny, nz, mati, pending] (6 or 8 rows).
Per lane it fetches the material (an index outside [0, M) selects
material 0, as the TPU's where-chain does), draws the fast murmur3
counter hash keyed by (step, lane), samples the BSDF, updates the
throughput factors and the emitter pickup, terminates, folds the sample
into the running average and regenerates the camera ray. A lane whose
hit row is PENDING is frozen: no draws consumed, no factor update, no
bounce, the ray unchanged. The TPU bakes the camera and the materials
into the kernel as literals; here they sit in a small device table
(`fused_table`), so that a new scene needs no new build.

Fast mode only: parity's sequential Lehmer draws stay on the unfused
`wavefront_step`. EnvLight, NEE and adaptive sampling are not packed
(their state fields unpack as zeros).
"""

from __future__ import annotations

import numpy as np
import torch

from opencl_path_tracer_tpu_torch.core import fp
from opencl_path_tracer_tpu_torch.core.camera import Camera
from opencl_path_tracer_tpu_torch.core.materials import MaterialsSoA
from opencl_path_tracer_tpu_torch.models.wavefront import WavefrontState
from opencl_path_tracer_tpu_torch.ops import rng
from opencl_path_tracer_tpu_torch.ops.kernels import _build

# F pack rows.
_COL = 0      # 0-2 colors
_RAYP = 3     # 3-5 ray_p
_RAYD = 6     # 6-8 ray_d
_FL = 9       # 9-11
_FB = 12      # 12-14
_FS = 15      # 15-17
_FR = 18      # 18-20
_CUR = 21     # 21-23 cur_color
_CX = 24      # pixel x as float (per lane, constant)
_CY = 25      # pixel y as float
F_ROWS = 32
# I pack rows.
_SAMP = 0
_PIX = 1
_RNG = 2      # Lehmer state (parity only; carried through)
_INSIDE = 3
_BOUNCE = 4
I_ROWS = 8

# fused_table layout: 16 camera floats, then 16 per material.
CAM_COLS = 16   # eye(3) lookat(3) right(3) up(3) width height 0 0
MAT_COLS = 16   # type n shininess kd(3) ks(3) emission(3) f0(3) 0
EPS = float(np.float32(0.001))
TWO_PI = float(np.float32(2.0 * np.pi))


def pack_state(st: WavefrontState, width: int, height: int):
    """WavefrontState -> (F (32, N) float32, I (8, N) int32, step int)."""
    n = st.lanes
    dev = st.samples.device
    F = torch.zeros((F_ROWS, n), dtype=torch.float32, device=dev)
    for base, v3 in ((_COL, st.colors), (_RAYP, st.ray_p), (_RAYD, st.ray_d),
                     (_FL, st.f_l), (_FB, st.f_b), (_FS, st.f_s),
                     (_FR, st.f_r), (_CUR, st.cur_color)):
        for k in range(3):
            F[base + k] = v3[k]
    # Raw pixel coordinates: the kernel rebuilds camera_rays' exact
    # 2 (x + jitter) / W - 1 from them.
    F[_CX] = (st.pixel % width).to(torch.float32)
    F[_CY] = torch.div(st.pixel, width, rounding_mode="floor").to(
        torch.float32)
    I = torch.zeros((I_ROWS, n), dtype=torch.int32, device=dev)
    I[_SAMP] = st.samples
    I[_PIX] = st.pixel
    I[_RNG] = st.rng_state.to(torch.int32)
    I[_INSIDE] = st.inside.to(torch.int32)
    I[_BOUNCE] = st.bounce
    return F, I, st.step


def unpack_state(F: torch.Tensor, I: torch.Tensor, step: int
                 ) -> WavefrontState:
    """(F, I, step) -> WavefrontState; the fields the pack does not hold
    (had_diffuse, prev_pdf, lum_m2) come back as zeros."""
    def v3(base):
        return (F[base], F[base + 1], F[base + 2])

    z = torch.zeros(F.shape[1], dtype=torch.float32, device=F.device)
    return WavefrontState(
        colors=v3(_COL), samples=I[_SAMP], pixel=I[_PIX],
        rng_state=I[_RNG].to(torch.int64) & 0xFFFFFFFF,
        ray_p=v3(_RAYP), ray_d=v3(_RAYD), f_l=v3(_FL), f_b=v3(_FB),
        f_s=v3(_FS), f_r=v3(_FR), cur_color=v3(_CUR),
        inside=I[_INSIDE] != 0, bounce=I[_BOUNCE],
        had_diffuse=torch.zeros_like(z, dtype=torch.bool), prev_pdf=z,
        lum_m2=z, step=int(step))


def hits_to_pack(hits, pending=None) -> torch.Tensor:
    """Hits (and an optional pending mask) -> (8, N) float32 rows
    [t, nx, ny, nz, mati, pending, 0, 0]."""
    z = torch.zeros_like(hits.t)
    pend = z if pending is None else pending.to(torch.float32)
    return torch.stack([hits.t, hits.n[0], hits.n[1], hits.n[2],
                        hits.mati.to(torch.float32), pend, z, z])


def fused_table(cam: Camera, mats: MaterialsSoA, width: int,
                height: int) -> torch.Tensor:
    """The kernel's constants: (16 + 16 M,) float32 on the camera's
    device, the camera row then one row per material."""
    cam_row = np.zeros(CAM_COLS, np.float32)
    for k, v in enumerate((cam.eye, cam.lookat, cam.right, cam.up)):
        cam_row[3 * k:3 * k + 3] = v.cpu().numpy()
    cam_row[12], cam_row[13] = width, height
    m = mats.count
    tab = np.zeros((m, MAT_COLS), np.float32)
    tab[:, 0] = mats.type.cpu().numpy()
    tab[:, 1] = mats.n.cpu().numpy()
    tab[:, 2] = mats.shininess.cpu().numpy()
    for base, v3 in ((3, mats.kd), (6, mats.ks), (9, mats.emission),
                     (12, mats.f0)):
        for k in range(3):
            tab[:, base + k] = v3[k].cpu().numpy()
    return torch.as_tensor(np.concatenate([cam_row, tab.reshape(-1)]),
                           device=cam.eye.device)


def _norm3(x, y, z):
    """vnormalize's form: 1 / sqrt, then scale."""
    r = 1.0 / fp.sqrt(x * x + y * y + z * z)
    return x * r, y * r, z * r


def step_plain(F, I, step_idx: int, H, table, key, iterations: int):
    """Plain PyTorch version of K5: (F', I') for one step."""
    n = F.shape[1]
    cam = table[:CAM_COLS].tolist()
    eye, la, right, up = cam[0:3], cam[3:6], cam[6:9], cam[9:12]
    width, height = cam[12], cam[13]
    mt = table[CAM_COLS:].view(-1, MAT_COLS)

    def f(r):
        return F[r]

    t = H[0]
    nx0, ny0, nz0 = H[1], H[2], H[3]
    mati = H[4].to(torch.int32)
    pending = H[5] > 0.0
    mrow = mt[torch.where((mati >= 0) & (mati < mt.shape[0]), mati,
                          torch.zeros_like(mati)).long()]

    def mat(c):
        return mrow[:, c]

    px, py, pz = f(_RAYP), f(_RAYP + 1), f(_RAYP + 2)
    dx, dy, dz = f(_RAYD), f(_RAYD + 1), f(_RAYD + 2)
    has_hit = (t > 0.0) & ~pending
    safe_t = torch.where(has_hit, t, torch.zeros_like(t))
    hx, hy, hz = px + dx * safe_t, py + dy * safe_t, pz + dz * safe_t

    u = rng.fast_uniforms(key, step_idx, 0, n, 2, device=F.device)
    r1, r2 = u[0], u[1]

    mtype = mat(0).to(torch.int32)
    is_diff = has_hit & (mtype == 0)
    is_spec = has_hit & (mtype == 1)
    is_refr = has_hit & (mtype == 2)
    is_emit = has_hit & (mtype == 3)

    # Normal flipped toward the ray (prog.cl:326-328).
    flip = (dx * nx0 + dy * ny0 + dz * nz0) > 0.0
    nx = torch.where(flip, -nx0, nx0)
    ny = torch.where(flip, -ny0, ny0)
    nz = torch.where(flip, -nz0, nz0)

    # Diffuse bounce (prog.cl:186-218).
    near_y = (torch.abs(nx) <= EPS) & (torch.abs(nz) <= EPS)
    rl_a = 1.0 / fp.sqrt(ny * ny + nz * nz)
    rl_b = 1.0 / fp.sqrt(nx * nx + nz * nz)
    zero = torch.zeros_like(nx)
    zx = torch.where(near_y, zero, -nz * rl_b)
    zy = torch.where(near_y, -nz * rl_a, zero)
    zz = torch.where(near_y, ny * rl_a, nx * rl_b)
    xx = ny * zz - nz * zy
    xy = nz * zx - nx * zz
    xz = nx * zy - ny * zx
    rr = fp.sqrt(r1)
    theta = TWO_PI * r2
    sx_ = rr * torch.cos(theta)
    sy_ = rr * torch.sin(theta)
    sz_ = fp.sqrt(1.0 - r1)
    ddx, ddy, ddz = _norm3(xx * sx_ + nx * sz_ + zx * sy_,
                           xy * sx_ + ny * sz_ + zy * sy_,
                           xz * sx_ + nz * sz_ + zz * sy_)
    dpx, dpy, dpz = hx + nx * EPS, hy + ny * EPS, hz + nz * EPS

    # Specular bounce (prog.cl:223-227).
    cosa_s = nx * dx + ny * dy + nz * dz
    sdx, sdy, sdz = _norm3(dx - nx * cosa_s * 2.0, dy - ny * cosa_s * 2.0,
                           dz - nz * cosa_s * 2.0)
    spx, spy, spz = dpx, dpy, dpz

    # Fresnel (prog.cl:219-222).
    f0x, f0y, f0z = mat(12), mat(13), mat(14)
    om = 1.0 - torch.abs(nx * dx + ny * dy + nz * dz)
    p2 = om * om
    p5 = p2 * p2 * om
    frx = f0x + (1.0 - f0x) * p5
    fry = f0y + (1.0 - f0y) * p5
    frz = f0z + (1.0 - f0z) * p5

    # Refractive bounce (prog.cl:228-245, 346-357).
    inside_i = I[_INSIDE]
    mat_n = mat(1)
    n_eff = torch.where(inside_i != 0, 1.0 / mat_n, mat_n)
    cosa_r = -(dx * nx + dy * ny + dz * nz)
    disc = 1.0 - (1.0 - cosa_r * cosa_r) / n_eff / n_eff
    prob = fp.div(frx + fry + frz, 3.0)
    refracted = (disc > 0.0) & (r1 > prob)
    inv_n = 1.0 / n_eff
    sq = fp.sqrt(torch.clamp_min(disc, 0.0))
    rdx, rdy, rdz = _norm3(dx * inv_n + nx * (cosa_r * inv_n - sq),
                           dy * inv_n + ny * (cosa_r * inv_n - sq),
                           dz * inv_n + nz * (cosa_r * inv_n - sq))
    rpx, rpy, rpz = hx - nx * EPS, hy - ny * EPS, hz - nz * EPS
    new_inside_i = torch.where(is_refr & refracted, 1 - inside_i, inside_i)
    inv_1mp = 1.0 / (1.0 - prob)
    inv_p = 1.0 / prob
    rfx = torch.where(refracted, (1.0 - frx) * inv_1mp, frx * inv_p)
    rfy = torch.where(refracted, (1.0 - fry) * inv_1mp, fry * inv_p)
    rfz = torch.where(refracted, (1.0 - frz) * inv_1mp, frz * inv_p)

    # Blinn term with the camera view direction (prog.cl:329-340).
    ex, ey, ez = _norm3(eye[0] - hx, eye[1] - hy, eye[2] - hz)
    hwx, hwy, hwz = _norm3(ex + ddx, ey + ddy, ez + ddz)
    ndh = torch.clamp_min(nx * hwx + ny * hwy + nz * hwz, 0.0)
    intens_s = torch.pow(ndh, mat(2))
    intens_d = torch.clamp_min(ddx * nx + ddy * ny + ddz * nz, 0.0)

    # The new ray (the emitter shares the diffuse bounce).
    use_diff = is_diff | is_emit

    def choose(diff, refr, spec, old):
        v = torch.where(is_refr, torch.where(refracted, refr, spec), spec)
        return torch.where(has_hit, torch.where(use_diff, diff, v), old)

    new_p = (choose(dpx, rpx, spx, px), choose(dpy, rpy, spy, py),
             choose(dpz, rpz, spz, pz))
    new_d = (choose(ddx, rdx, sdx, dx), choose(ddy, rdy, sdy, dy),
             choose(ddz, rdz, sdz, dz))

    # Factor updates and the emitter pickup (prog.cl:329-366).
    kd, ks, em = (mat(3), mat(4), mat(5)), (mat(6), mat(7), mat(8)), \
        (mat(9), mat(10), mat(11))
    fr3 = (frx, fry, frz)
    rf3 = (rfx, rfy, rfz)
    fl = [torch.where(is_diff, f(_FL + k) * kd[k] * intens_d, f(_FL + k))
          for k in range(3)]
    fb = [torch.where(is_diff, f(_FB + k) * ks[k] * intens_s, f(_FB + k))
          for k in range(3)]
    fs = [torch.where(is_spec, f(_FS + k) * fr3[k], f(_FS + k))
          for k in range(3)]
    fr = [torch.where(is_refr, f(_FR + k) * rf3[k], f(_FR + k))
          for k in range(3)]
    emit_cos = torch.clamp_min(-(dx * nx + dy * ny + dz * nz), 0.0)
    cur = [f(_CUR + k) for k in range(3)]
    if iterations == 1:  # preview (prog.cl:323-325)
        cur = [torch.where(has_hit, kd[k] + em[k], cur[k]) for k in range(3)]
    cur = [torch.where(is_emit,
                       cur[k] + em[k] * (fl[k] + fb[k]) * fs[k] * fr[k]
                       * emit_cos, cur[k]) for k in range(3)]

    # Terminate, fold, regenerate (models/wavefront.py).
    active = ~pending
    bounce = torch.where(active, I[_BOUNCE] + 1, I[_BOUNCE])
    terminated = active & (~(t > 0.0) | (bounce >= iterations))
    s_f = I[_SAMP].to(torch.float32)
    inv = 1.0 / (s_f + 1.0)
    col = [torch.where(terminated, (f(_COL + k) * s_f + cur[k]) * inv,
                       f(_COL + k)) for k in range(3)]
    samples = torch.where(terminated, I[_SAMP] + 1, I[_SAMP])

    g = rng.fast_uniforms(key, step_idx, 1, n, 2, device=F.device)
    ndcx = fp.div(2.0 * (f(_CX) + g[0]), width) - 1.0
    ndcy = fp.div(2.0 * (f(_CY) + g[1]), height) - 1.0
    gd = _norm3(*(la[k] + right[k] * ndcx + up[k] * ndcy - eye[k]
                  for k in range(3)))

    def sel(term_val, cont_val):
        return torch.where(terminated, term_val, cont_val)

    one = torch.ones_like(s_f)
    zero = torch.zeros_like(s_f)
    Fo = torch.stack(
        col
        + [sel(torch.full_like(s_f, eye[k]), new_p[k]) for k in range(3)]
        + [sel(gd[k], new_d[k]) for k in range(3)]
        + [sel(one, v) for v in fl + fb + fs + fr]
        + [sel(zero, v) for v in cur]
        + [f(_CX), f(_CY)] + list(F[26:32]))
    Io = torch.stack([samples, I[_PIX], I[_RNG],
                      torch.where(terminated, 0, new_inside_i),
                      torch.where(terminated, 0, bounce)] + list(I[5:8]))
    return Fo, Io


def fused_step(F: torch.Tensor, I: torch.Tensor, step_idx: int,
               H: torch.Tensor, table: torch.Tensor, key, iterations: int):
    """K5: one fused step. F (32, N) float32, I (8, N) int32, H (6 or 8,
    N) float32 hit rows, table from fused_table, key the fast-mode key
    (rng.key). CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    n = F.shape[1]
    _build.check(F, "F", (F_ROWS, n))
    _build.check(I, "I", (I_ROWS, n), dtype=torch.int32)
    if H.shape[0] not in (6, 8):
        raise ValueError(f"H has {H.shape[0]} rows, expected 6 or 8")
    _build.check(H, "H", (H.shape[0], n))
    _build.check(table, "table", (None,))
    n_mats = (table.shape[0] - CAM_COLS) // MAT_COLS
    if n_mats < 1 or table.shape[0] != CAM_COLS + MAT_COLS * n_mats:
        raise ValueError("table must hold the camera and >= 1 material")
    if not (F.device == I.device == H.device == table.device):
        raise ValueError("F, I, H and table must be on one device")
    if not 1 <= iterations:
        raise ValueError("iterations must be >= 1")
    if F.device.type == "cpu":
        return step_plain(F, I, step_idx, H, table, key, iterations)
    Fo = torch.empty_like(F)
    Io = torch.empty_like(I)
    _build.launch("fused_step", F, I, H, table, n_mats, Fo, Io, n,
                  int(step_idx) & 0xFFFFFFFF, key[0] & 0xFFFFFFFF,
                  key[1] & 0xFFFFFFFF, iterations)
    return Fo, Io


def make_fused_step(cam: Camera, mats: MaterialsSoA, *, width: int,
                    height: int, iterations: int, key):
    """step(F, I, step_idx, H) -> (F', I') with this scene's constants
    (fast mode; key as rng.key(seed))."""
    table = fused_table(cam, mats, width, height)

    def step(F, I, step_idx, H):
        return fused_step(F, I, step_idx, H, table, key, iterations)

    return step
