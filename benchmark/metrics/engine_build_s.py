"""Engine layer: seconds of set-up in the engine, host time: the span
`engine.init` (`RenderEngine.__init__`: the intersector and its packs,
the emitter table, the per-pixel streams) plus `engine.calibrate` (the
one instrumented sample of `estimated_rays`, at the first meter tick of
the warm-up), the latest of each."""

from benchmark import recorder


def read(t):
    init = recorder.last_span_s("engine.init")
    if init is None:
        return None
    return init + (recorder.last_span_s("engine.calibrate") or 0.0)
