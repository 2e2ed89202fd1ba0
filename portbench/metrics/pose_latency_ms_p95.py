"""pose_latency_ms_p95: the 95th percentile, over the traced frames, of the
host time from the call that handed a frame in to the end of the call after
which its pose was in the trajectory."""

import numpy as np

SOURCE = "host_clock"
UNIT = "ms"
LAYER = "entry"
MOVES = "setup_s"


def read(r):
    lat = r.get("trace", {}).get("latencies_ms")
    return float(np.percentile(lat, 95)) if lat else None
