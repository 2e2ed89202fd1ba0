"""frontend_launches_per_frame: the kernels launched inside the program's
front-end spans (`frontend.*`: `make_frame` and the pyramid, FAST and K1
inside it) in the profiled stretch, over the frames whose poses came back
in it (`program_trace.py`)."""

from portbench import program_trace

SOURCE = "device_trace"
UNIT = "launches"
LAYER = "front end"
MOVES = "setup_s"


def read(r):
    j = program_trace.from_readings(r)
    if not j or not j["launches"]:       # no device events: a run on the CPU
        return None
    return j["launches_by_layer"].get("frontend", 0) / j["frames"]
