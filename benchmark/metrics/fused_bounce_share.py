"""Model step layer: the share of the profiled phase's megakernel
bounces that ran through the bounce kernel K21, from the program's
counters `step.bounces.fused` and `step.bounces.plain`; None where the
program counts neither (a program without the kernel)."""

from benchmark import recorder


def read(t):
    c = recorder.counters()
    if t.loop != "offline" or c is None:
        return None
    fused = c.get("step.bounces.fused", 0)
    plain = c.get("step.bounces.plain", 0)
    if fused + plain == 0:
        return None
    return fused / (fused + plain)
