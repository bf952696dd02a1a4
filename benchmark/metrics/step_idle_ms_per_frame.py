"""Model step layer, interactive cells: ms a frame of the unprofiled
phase's device idle time put down to the model step's spans (`step`,
`step.*`; `attribution.py`)."""

from benchmark import attribution, recorder


def read(t):
    if t.loop != "interactive":
        return None
    return attribution.read_layer(t, recorder.program_spans(), "model step")
