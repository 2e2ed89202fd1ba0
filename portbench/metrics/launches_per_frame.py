"""launches_per_frame: the kernels the device ran in the profiled stretch
over the frames whose poses came back in it."""

SOURCE = "device_trace"
UNIT = "launches"
LAYER = "host launch path and device"
MOVES = "setup_s"


def read(r):
    t = r.get("trace", {})
    return t["launches"] / t["frames"] if t.get("launches") and t.get("frames") else None
