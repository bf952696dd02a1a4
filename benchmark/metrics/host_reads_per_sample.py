"""Engine layer: the program's blocking device reads in the profiled
phase per sample, the sum of its `host_reads.*` counters (the engine's
synchronise, the pair schedule's escalation and tail reads, the
display's copy)."""

from benchmark import recorder


def read(t):
    c = recorder.counters()
    if t.loop != "offline" or c is None or not t.samples:
        return None
    return sum(n for k, n in c.items()
               if k.startswith("host_reads.")) / t.samples
