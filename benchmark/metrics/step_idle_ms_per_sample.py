"""Model step layer: ms a sample of the unprofiled phase's device idle
time put down to the model step's own spans (`step`, `step.raygen`,
`step.bounce`, `step.rng`, `step.shade`, `step.fold`: the host was there
when the device went idle; `attribution.py`)."""

from benchmark import attribution, recorder


def read(t):
    if t.loop != "offline":
        return None
    return attribution.read_layer(t, recorder.program_spans(), "model step")
