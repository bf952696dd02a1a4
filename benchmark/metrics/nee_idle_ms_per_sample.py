"""NEE layer: ms a sample of the unprofiled phase's device idle time put
down to NEE's spans (`nee.gather`, the emitter sample and its shading;
`nee.anyhit`, the any-hit shadow test; `attribution.py`)."""

from benchmark import attribution, recorder


def read(t):
    if t.loop != "offline":
        return None
    return attribution.read_layer(t, recorder.program_spans(), "NEE")
