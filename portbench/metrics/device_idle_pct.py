"""device_idle_pct: the share of the profiled stretch in which no kernel
or copy ran on the device (1 - the union of their intervals over the
stretch), in percent."""

SOURCE = "device_trace"
UNIT = "%"
LAYER = "host launch path and device"
MOVES = "setup_s"


def read(r):
    t = r.get("trace", {})
    if not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
