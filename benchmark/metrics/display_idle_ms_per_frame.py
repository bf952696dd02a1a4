"""Display layer: ms a frame of the unprofiled phase's device idle time
put down to the display's spans (`display`, `display.tonemap`,
`display.copy`: the uint8 frame's wait and host copy;
`attribution.py`)."""

from benchmark import attribution, recorder


def read(t):
    if t.loop != "interactive":
        return None
    return attribution.read_layer(t, recorder.program_spans(), "display")
