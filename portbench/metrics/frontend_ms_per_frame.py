"""frontend_ms_per_frame: the host time inside the front end's spans
(`make_frame`; nested calls once) over the traced
frames."""

SOURCE = "program_span"
UNIT = "ms"
LAYER = "front end"
MOVES = "setup_s"


def read(r):
    t = r.get("trace")
    if not t or not t["frames"] or "frontend" not in t["layer_s"]:
        return None
    return t["layer_s"]["frontend"] * 1e3 / t["frames"]
