"""Mesh layer: the slowest rank's device-busy ms a sample over the mean of
all ranks', each from its own profiled phase, with NCCL's kernels left
out (a rank that reaches a collective first spins in its kernel until
the slowest comes, which would even the ranks out). 1 when the tiles
cost alike; the render's collectives make every rank wait for the
slowest, so the excess is time the others stand idle."""


def read(t):
    if t.loop != "offline" or t.device != "cuda" or len(t.ranks) < 2:
        return None
    per = [r["compute_busy_s"] / r["samples"] for r in t.ranks]
    if min(per) <= 0:
        return None
    return max(per) / (sum(per) / len(per))
