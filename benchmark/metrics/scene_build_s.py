"""Engine layer: seconds of set-up spent uploading the scene, host time:
the span `scene.build` (`SceneBuilder.build`: the triangle and material
tables made and moved to the device; in a run it is the first device
upload, so it also holds the start of the device's context), the latest
one. With `engine_build_s` it splits `setup_s`; what neither holds is
the imports, the builder's calls a triangle and the warm-up."""

from benchmark import recorder


def read(t):
    return recorder.last_span_s("scene.build")
