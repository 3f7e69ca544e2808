"""`frame_ms_p90`: the 90th percentile (numpy's linear interpolation) of the
latencies of the frames counted in the window, each from when the entry took
the frame to when its result was on the host."""

import numpy as np


def read(run):
    lat = run.window.latencies_s()
    return float(np.percentile(lat, 90)) * 1e3 if lat else None
