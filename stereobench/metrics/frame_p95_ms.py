"""95th percentile, over every trigger of the window, of the time from the
trigger's due time to the end of the synchronise after its answer (ms).  A
trigger that failed counts as infinitely late."""

import math

from stereobench.yardstick import percentile


def read(window):
    if not window.latencies_s and not window.failed:
        return None
    lat = list(window.latencies_s) + [math.inf] * window.failed
    return percentile(lat, 95) * 1e3
