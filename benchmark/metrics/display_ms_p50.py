"""Display layer: the median host ms from a display_u8() call to its
return (tonemap, quantisation, the host copy) in the unprofiled phase."""

import statistics


def read(t):
    if t.loop != "interactive" or not t.display_ms:
        return None
    return statistics.median(t.display_ms)
