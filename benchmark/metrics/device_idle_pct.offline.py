"""Device layer, offline cells: 100 x (1 - device busy seconds of the
profiled phase / wall seconds of the unprofiled phase of equal work)."""


def read(t):
    if t.loop != "offline" or t.device != "cuda" or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.wall_plain_s)
