"""lane_buffer_ms_p95: the 95th percentile, over the frames the
autonomous lane took in the profiled stretch, of the program's time from
a frame's `lane.submit` to the start of its own `lane.step`: the wait for
the rest of its batch (`program_trace.py`)."""

import numpy as np

from portbench import program_trace

SOURCE = "program_span"
UNIT = "ms"
LAYER = "entry"
MOVES = "setup_s"


def read(r):
    j = program_trace.from_readings(r)
    if not j or not j.get("lane"):
        return None
    return float(np.percentile([row[1] for row in j["lane"]], 95))
