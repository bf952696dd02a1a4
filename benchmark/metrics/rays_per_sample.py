"""Engine layer: `RenderEngine.rays_traced` over both traced phases per
per-pixel sample (live lanes at each bounce, once more for each shadow
batch; kept in a float32 device scalar, so good to about 1e-4)."""


def read(t):
    if t.loop != "offline" or not t.rays_samples:
        return None
    return t.rays / t.rays_samples
