"""NEE layer: device ms between CUDA events recorded around every call of
the engine's any-hit shadow test (K7) in the unprofiled phase, per
sample."""


def read(t):
    if t.loop != "offline" or t.device != "cuda" or not t.anyhit_calls:
        return None
    return t.anyhit_ms / t.samples
