"""Mesh layer: rank 0's host ms from an image() call to its return in the
unprofiled phase, per call: the frame's all_gather over the ranks, its
tonemap and its copy to the host, which every rank makes after each
render call where the traffic asks for the frame (`image_every_call`)."""

import statistics


def read(t):
    if t.loop != "offline" or not t.image_ms or len(t.ranks) < 2:
        return None
    return statistics.mean(t.image_ms)
