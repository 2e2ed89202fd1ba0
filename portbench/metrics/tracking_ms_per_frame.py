"""tracking_ms_per_frame: the host time inside the tracking spans
(`track_frame`, `pose_optimization`; nested calls once) over the traced
frames."""

SOURCE = "program_span"
UNIT = "ms"
LAYER = "tracking"
MOVES = "setup_s"


def read(r):
    t = r.get("trace")
    if not t or not t["frames"] or "tracking" not in t["layer_s"]:
        return None
    return t["layer_s"]["tracking"] * 1e3 / t["frames"]
