"""Intersect layer: device ms between CUDA events recorded around every
call of the engine's intersector in the unprofiled phase, per sample
(host work inside a call, such as a schedule's reads, counts)."""


def read(t):
    if t.loop != "offline" or t.device != "cuda" or not t.isect_calls:
        return None
    return t.isect_ms / t.samples
