"""The comparison that decides `correct`.

After the window, the benchmark reads the accumulated colour of a set of
pixels drawn from the seed (`checks/<workload>.json` gives how many) and
the number of samples the engine accumulated; the reference renders the
same pixels over the same samples. The numbers compared:

* `image_rel_mae`: the sum over the checked pixels and channels of
  |program - reference| over the sum of |reference|. A path that takes
  another branch on a rounding (an edge, a roulette draw) moves its one
  sample by a whole path's radiance, so single pixels differ by a lot
  now and then; this mean does not grow with the sample count, as that
  per-path divergence rate times its size over the mean radiance.
* `sample_count_error`: |samples the engine accumulated - samples the
  benchmark asked for| (exact: limit 0); the reference renders the
  samples asked for.
* `nonfinite_pixels`: checked pixels with a NaN or infinite channel
  (exact: limit 0). A non-finite channel counts as 0 in the mean above.
* `display_mae_levels` (cells whose loop displays): the mean absolute
  difference, in uint8 levels, between the last displayed frame's
  checked pixels and the reference's tonemapped, quantised colours.

Each has a limit per cell; the run is correct when every number is at
or under its limit.
"""

from __future__ import annotations

import numpy as np


def check_pixels(seed: int, num_pixels: int, count: int) -> np.ndarray:
    """`count` distinct pixel ids drawn from the seed, sorted (all of them
    when the frame has no more)."""
    if count >= num_pixels:
        return np.arange(num_pixels, dtype=np.int64)
    rs = np.random.default_rng(seed)
    return np.sort(rs.choice(num_pixels, size=count, replace=False))


def readings(prog: np.ndarray, ref: np.ndarray, prog_u8=None,
             ref_u8=None, samples=None, asked=None) -> dict:
    """The numbers compared, from (P, 3) program and reference colours,
    for a displayed frame the two (P, 3) uint8 arrays, and the samples
    accumulated and asked for."""
    prog = np.asarray(prog, np.float64)
    ref = np.asarray(ref, np.float64)
    finite = np.isfinite(prog)
    num = np.abs(np.where(finite, prog, 0.0) - ref).sum()
    den = np.abs(ref).sum()
    out = {"image_rel_mae": float(num / den) if den > 0 else float(num),
           "nonfinite_pixels": int((~finite).any(1).sum())}
    if asked is not None:
        out["sample_count_error"] = abs(int(samples) - int(asked))
    if prog_u8 is not None:
        out["display_mae_levels"] = float(np.abs(
            np.asarray(prog_u8, np.int64) - np.asarray(ref_u8, np.int64)
        ).mean())
    return out


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number without a limit, or a limit without a number, fails."""
    checks, ok = {}, True
    for name in sorted(set(values) | set(limits)):
        v, lim = values.get(name), limits.get(name)
        checks[name] = {"value": v, "limit": lim}
        ok &= v is not None and lim is not None and v <= lim
    return ok, checks
