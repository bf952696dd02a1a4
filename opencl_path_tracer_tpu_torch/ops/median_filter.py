"""3x3 luminance-median filter and filmic tonemap: the reference's
dormant `filt_im` kernel (prog.cl:391-427; its host launch is commented
out at main.cpp:665-668).

Port of `opencl_path_tracer_tpu/ops/median_filter.py` (plain XLA there,
plain PyTorch here). Each pixel takes the colour of the 3x3 neighbour
whose grey value (the mean of RGB) is the median, filmic-tonemapped, and
the x == 0 and y == 0 borders keep the input (prog.cl:397: its x < width
test is vacuously true, so only the left and top edges are skipped; row
0 is the image's first row).

Bit-equality with the JAX package: the grey is `jnp.mean`'s rounding,
((r + g) + b) * float32(1/3) (a division by 3 differs in the last bit at
about a third of values, and an ulp can pick another neighbour), and the
nine greys are ranked by a stable argsort, as `jnp.argsort` ranks them,
so equal greys (flat walls, black misses, the edge-padded border) keep
neighbour order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from opencl_path_tracer_tpu_torch.ops.tonemap import filmic


def median3x3(img: torch.Tensor, tonemap: bool = True) -> torch.Tensor:
    """img: (H, W, 3) linear colour. Returns the filtered (and, with
    tonemap, filmic-tonemapped) image on img's device."""
    h, w, _ = img.shape
    pad = F.pad(img.permute(2, 0, 1)[None], (1, 1, 1, 1),
                mode="replicate")[0].permute(1, 2, 0)
    stack = torch.stack([pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
    grey = (stack[..., 0] + stack[..., 1] + stack[..., 2]) * (1.0 / 3.0)
    med_idx = torch.argsort(grey, dim=0, stable=True)[4]   # (H, W)
    med = torch.gather(stack, 0,
                       med_idx[None, :, :, None].expand(1, h, w, 3))[0]
    out = filmic(med) if tonemap else med
    base = filmic(img) if tonemap else img
    out[0, :] = base[0, :]
    out[:, 0] = base[:, 0]
    return out
