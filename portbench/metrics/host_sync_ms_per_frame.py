"""host_sync_ms_per_frame: the host's time blocked on the device in the
profiled stretch, over the frames whose poses came back in it: the
runtime's synchronising calls and its copies to or from pageable host
memory, wherever on the main path they lie (`program_trace.py`)."""

from portbench import program_trace

SOURCE = "device_trace"
UNIT = "ms"
LAYER = "host launch path and device"
MOVES = "setup_s"


def read(r):
    j = program_trace.from_readings(r)
    if not j:
        return None
    return sum(ms for _, ms in j["waits_by_span"].values()) / j["frames"]
