"""Random number generation.

Port of `opencl_path_tracer_tpu/ops/rng.py` (with its pure-Python
oracle `lehmer_reference_sequence`). Two engines:

1. Parity: the reference's Lehmer LCG, n' = n * 48271 mod (2^31 - 1),
   uniform = float32(n') / 2147483647.0f, one stream per pixel
   (prog.cl:72-77), seeded on the host by std::minstd_rand0 draws in
   pixel order (main.cpp:45, 522-527).
2. Fast: a counter-based double murmur3 finalizer over (lane, sample,
   bounce, draw), keyed by a threefry2x32 key.

Unsigned 32-bit arithmetic is done in int64 and masked back to 32 bits;
products are split so that no int64 product overflows.
"""

from __future__ import annotations

import numpy as np
import torch

from opencl_path_tracer_tpu_torch.core import fp

M31 = 0x7FFFFFFF          # 2^31 - 1, prime
LEHMER_A = 48271          # device multiplier (prog.cl:74)
MINSTD0_A = 16807         # std::minstd_rand0 multiplier
INV_M31_DEN = 2147483647.0  # the float literal the reference divides by
MASK32 = 0xFFFFFFFF


def modmul31(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod (2^31 - 1) for 0 <= a, b < 2^31, exact in int64."""
    return (a.long() * int(b)) % M31


def lehmer_step(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One rand() (prog.cl:72-77). state: int64 tensor of values < 2^31.
    Returns (new state, float32 uniform)."""
    new = modmul31(state, LEHMER_A)
    return new, fp.div(new.to(torch.float32), INV_M31_DEN)


def minstd_rand0_raw(n: int, seed: int = 1) -> np.ndarray:
    """First n outputs of std::minstd_rand0(seed) as uint32: block of 4096
    sequential draws, then jump-ahead by powers of 16807 mod m."""
    block = min(n, 4096)
    first = np.empty(block, np.int64)
    x = int(seed)
    for i in range(block):
        x = (x * MINSTD0_A) % M31
        first[i] = x
    out = np.empty(n, np.int64)
    out[:block] = first
    for start in range(block, n, block):
        m = min(block, n - start)
        jump = pow(MINSTD0_A, start, M31)
        out[start:start + m] = (first[:m] * jump) % M31
    return out.astype(np.uint32)


def seed_pixel_streams(num_pixels: int, seed: int = 1,
                       device="cpu") -> torch.Tensor:
    """Per-pixel Lehmer states as an int64 (num_pixels,) tensor."""
    return torch.as_tensor(minstd_rand0_raw(num_pixels, seed).astype(np.int64),
                           device=device)


# --- fast engine -----------------------------------------------------------

_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLD = 0x9E3779B9
_R2_A1 = 3242174889  # round(2^32 / phi2), phi2 the plastic constant
_R2_A2 = 2447445413  # round(2^32 / phi2^2)


def mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2^32 for 0 <= a < 2^32 and a constant b < 2^32."""
    lo, hi = b & 0xFFFF, b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = mul32(h, _M1)
    h = h ^ (h >> 13)
    h = mul32(h, _M2)
    return h ^ (h >> 16)


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(key: tuple[int, int], x: tuple[int, int]) -> tuple[int, int]:
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011), as JAX's PRNG."""
    k0, k1 = key[0] & MASK32, key[1] & MASK32
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0 = (x[0] + ks[0]) & MASK32
    x1 = (x[1] + ks[1]) & MASK32
    for i in range(5):
        for r in rot[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def key(seed: int) -> tuple[int, int]:
    """The key data of `jax.random.key(seed)` for 0 <= seed < 2^31."""
    return (0, int(seed) & MASK32)


def fold_in(k: tuple[int, int], data: int) -> tuple[int, int]:
    """`jax.random.fold_in` on threefry key data."""
    return threefry2x32(k, (0, int(data) & MASK32))


def fast_uniforms(k: tuple[int, int], sample: int, bounce: int, n: int,
                  num: int, lane_offset: int = 0,
                  device="cpu") -> torch.Tensor:
    """`num` uniform draws for each of n lanes for one (sample, bounce)
    event: float32 (num, n) in [0, 1), stateless in (key, sample,
    bounce, lane)."""
    lane = (torch.arange(n, dtype=torch.int64, device=device)
            + int(lane_offset)) & MASK32
    draw = torch.arange(num, dtype=torch.int64, device=device)[:, None]
    h = (mul32(lane, _GOLD) + k[0]) & MASK32
    h = h ^ ((int(sample) * _M1) & MASK32)
    h = (h + ((int(bounce) * _M2) & MASK32)) & MASK32
    h = h ^ mul32(draw, _GOLD) ^ k[1]
    h = fmix32(fmix32(h))
    return (h >> 8).to(torch.float32) * np.float32(1.0 / (1 << 24))


def r2_jitter(k: tuple[int, int], pixel_ids: torch.Tensor, sample):
    """(u, v) in [0, 1): the sample-th point of each pixel's rotated R2
    sequence, in uint32 fixed point (wraparound is the fract()). sample:
    an int, or a tensor of each lane's index (the wavefront's
    regeneration)."""
    p = pixel_ids.long() & MASK32
    rot1 = fmix32((mul32(p, _GOLD) + k[0]) & MASK32)
    rot2 = fmix32(rot1 ^ k[1] ^ _M2)
    if isinstance(sample, torch.Tensor):
        s = sample.long() & MASK32
        su, sv = mul32(s, _R2_A1), mul32(s, _R2_A2)
    else:
        su = (int(sample) * _R2_A1) & MASK32
        sv = (int(sample) * _R2_A2) & MASK32
    u = (rot1 + su) & MASK32
    v = (rot2 + sv) & MASK32
    to_f = np.float32(1.0 / (1 << 24))
    return ((u >> 8).to(torch.float32) * to_f,
            (v >> 8).to(torch.float32) * to_f)


def lehmer_reference_sequence(state: int, n: int) -> list[int]:
    """The next n states of the Lehmer stream that starts at `state`, in
    pure Python (closed form of prog.cl:72-77): the tests' oracle."""
    out = []
    x = int(state)
    for _ in range(n):
        x = (x * LEHMER_A) % M31
        out.append(x)
    return out
