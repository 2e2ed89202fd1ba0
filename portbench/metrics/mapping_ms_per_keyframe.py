"""mapping_ms_per_keyframe: the host time inside the mapping spans (the
mapper chain or `on_new_keyframe`, `local_ba`, `bundle_adjust`) over the
keyframes made while traced. Nothing to read where none was made."""

SOURCE = "program_span"
UNIT = "ms"
LAYER = "mapping"
MOVES = "setup_s"


def read(r):
    t = r.get("trace")
    if not t or not t["keyframes"]:
        return None
    return t["layer_s"].get("mapping", 0.0) * 1e3 / t["keyframes"]
