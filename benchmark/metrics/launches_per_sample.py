"""Model step layer: device operations (kernels, copies, fills) in the
profiled phase per per-pixel sample."""


def read(t):
    if t.loop != "offline" or t.device != "cuda" or not t.launches:
        return None
    return t.launches / t.samples
