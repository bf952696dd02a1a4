"""Intersect layer: ms a sample of the unprofiled phase's device idle
time put down to the intersect's spans (`isect` around each intersector
call, the pair schedule's `isect.round1`, `isect.escalate`, `isect.tail`
and its blocking reads, `isect.host_read`; `attribution.py`)."""

from benchmark import attribution, recorder


def read(t):
    if t.loop != "offline":
        return None
    return attribution.read_layer(t, recorder.program_spans(), "intersect")
