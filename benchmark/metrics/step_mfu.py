"""Model step layer: the whole sample's share of the chip's float32 peak,
in %: the intersect floor's operations (peaks.RAY_FLOPS a ray handed to
the intersector) over the unprofiled phase's wall time at 67 TFLOP/s.
A floor count, so it bounds what any kernel's share can give back."""

from benchmark import peaks


def read(t):
    if t.loop != "offline" or t.device != "cuda" or not t.isect_rays:
        return None
    return 100.0 * peaks.isect_flops(t.isect_rays) / (
        t.wall_plain_s * peaks.FP32_FLOPS)
