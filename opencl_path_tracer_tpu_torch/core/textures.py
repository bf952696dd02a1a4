"""Image textures: the consumption path of an OBJ `map_Kd`.

Port of `opencl_path_tracer_tpu/core/textures.py`: `TexturesSoA` (the
atlas, built on the host in numpy as the JAX package builds it) and
`kd_scale` (the bilinear repeat-wrap sample), in plain PyTorch. The
reference's tinyobjloader parses `map_Kd` (tiny_obj_loader.h:124-182)
but the reference never samples it; here the bound image's sample at a
hit's texture coordinates multiplies the material's kd lane by lane
(`models.megakernel.fetch_material`, fed by
`runtime.engine.make_intersect_fn(textured=True)`).

Layout: all textures share one padded atlas of (N * hm * wm, 4) float32
rows [r, g, b, 0], each texture's rows bottom-up (t = 0 samples the
image's bottom row, the OBJ `vt` origin), so a tap is one row gather
where the JAX package takes each of the three components on its own; the
values are the JAX package's atlas bit for bit. Per-texture true sizes
and the per-material binding (-1: none) are small (N,) and (M,) int32
tables. Untextured lanes (texi < 0, misses, analytic-sphere winners)
get exactly 1.0.

Rounding: every operation is the JAX package's in the same order, so the
samples are bit-equal to its op-by-op evaluation; XLA's jit contracts
the bilinear blend into fused multiply-adds, which moves about 17 % of
the lanes of its jitted result by an ulp. A non-finite texture
coordinate makes the texel's float-to-int cast NaN, which is 0 in XLA
and on the card and INT_MIN on PyTorch's CPU: `remainder` takes either
back inside the atlas, and the blend weight is NaN, so the sample is NaN
in both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from opencl_path_tracer_tpu_torch.core.types import V3


@dataclasses.dataclass(frozen=True)
class TexturesSoA:
    """atlas: (N * hm * wm, 4) float32 rows, bottom-up per texture;
    height, width: (N,) int32 true sizes; mat_texi: (M,) int32 texture
    index per material (-1: untextured); hm, wm: the padded size."""

    atlas: torch.Tensor
    height: torch.Tensor
    width: torch.Tensor
    mat_texi: torch.Tensor
    hm: int
    wm: int

    @property
    def count(self) -> int:
        return int(self.height.shape[0])

    @staticmethod
    def build(images, mat_texi, device="cpu") -> "TexturesSoA":
        """images: top-down (H, W, 3) arrays (grey (H, W) widens to 3
        channels, a fourth channel is dropped), uint8 (divided by 255 in
        float32) or float in [0, 1]. mat_texi: (M,) texture index per
        material (-1 = untextured)."""
        if not images:
            raise ValueError("TexturesSoA.build needs >= 1 image")
        imgs = []
        for im in images:
            a = np.asarray(im)
            if a.dtype == np.uint8:
                a = a.astype(np.float32) / 255.0
            a = np.asarray(a, np.float32)
            if a.ndim == 2:
                a = np.stack([a] * 3, -1)
            if a.shape[-1] == 4:
                a = a[..., :3]
            imgs.append(a[::-1])   # bottom-up (the OBJ vt origin)
        hm = max(a.shape[0] for a in imgs)
        wm = max(a.shape[1] for a in imgs)
        pad = np.zeros((len(imgs), hm, wm, 4), np.float32)
        for i, a in enumerate(imgs):
            pad[i, :a.shape[0], :a.shape[1], :3] = a

        def i32(v):
            return torch.as_tensor(np.asarray(v, np.int32), device=device)

        return TexturesSoA(
            atlas=torch.as_tensor(pad.reshape(-1, 4), device=device),
            height=i32([a.shape[0] for a in imgs]),
            width=i32([a.shape[1] for a in imgs]),
            mat_texi=i32(mat_texi), hm=hm, wm=wm)

    def to(self, device) -> "TexturesSoA":
        return dataclasses.replace(
            self, atlas=self.atlas.to(device), height=self.height.to(device),
            width=self.width.to(device), mat_texi=self.mat_texi.to(device))


def _select_small(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tab[idx] for in-range idx: a chain of selects over a table of at
    most 64 rows (the JAX package's choice for tiny tables), a gather
    above."""
    m = int(tab.shape[0])
    if m > 64:
        return tab[idx.long()]
    acc = tab[0].expand(idx.shape).clone()
    for j in range(1, m):
        acc = torch.where(idx == j, tab[j], acc)
    return acc


def kd_scale(tex: TexturesSoA, mati: torch.Tensor, s: torch.Tensor,
             t: torch.Tensor, ok: torch.Tensor) -> V3:
    """Per-lane diffuse multiplier: the bilinear repeat-wrap sample of the
    material's bound texture at (s, t), or exactly 1.0 where `ok` is
    False or the material is unbound.

    mati: (R,) int32 material index at the hit; s, t: (R,) texture
    coordinates (`ops.shading.interpolate_uvs`); ok: (R,) bool, the
    lanes whose (s, t) is meaningful (triangle winners with UV data)."""
    texi = _select_small(tex.mat_texi, mati)
    has = ok & (texi >= 0)
    ti = torch.clamp_min(texi, 0)
    h = _select_small(tex.height, ti)
    w = _select_small(tex.width, ti)
    hf = h.to(torch.float32)
    wf = w.to(torch.float32)

    # Repeat wrap to [0, 1), then the texel-centred bilinear footprint.
    sf = s - torch.floor(s)
    tf = t - torch.floor(t)
    x = sf * wf - 0.5
    y = tf * hf - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0 = x0.to(torch.int32)
    y0 = y0.to(torch.int32)
    # remainder takes the -1 below and the size above back in range.
    x0w = torch.remainder(x0, w)
    x1w = torch.remainder(x0 + 1, w)
    y0w = torch.remainder(y0, h)
    y1w = torch.remainder(y0 + 1, h)

    base = ti * (tex.hm * tex.wm)

    def fetch(yy, xx):
        rows = tex.atlas[(base + yy * tex.wm + xx).long()]
        return rows[:, 0], rows[:, 1], rows[:, 2]

    c00 = fetch(y0w, x0w)
    c01 = fetch(y0w, x1w)
    c10 = fetch(y1w, x0w)
    c11 = fetch(y1w, x1w)
    gx = 1.0 - fx
    gy = 1.0 - fy
    return tuple(
        torch.where(has, (c00[k] * gx + c01[k] * fx) * gy
                    + (c10[k] * gx + c11[k] * fx) * fy, 1.0)
        for k in range(3))
