"""Intersect layer: the intersector's share of its floor, in %: the least
time of its calls' rays on one H100 (peaks.isect_floor_s: bytes-bound)
over the device ms between the events around those calls."""

from benchmark import peaks


def read(t):
    if t.loop != "offline" or t.device != "cuda" or not t.isect_ms:
        return None
    return 100.0 * peaks.isect_floor_s(t.isect_rays) / (t.isect_ms / 1e3)
