"""mapping_launches_per_keyframe: the kernels launched inside the
program's mapping spans (`mapping.*`: the keyframe's insertion and the
mapper chain, its local BA with K2 and K3) in the profiled stretch, over
the keyframes inserted in it; nothing where none was (`program_trace.py`)."""

from portbench import program_trace

SOURCE = "device_trace"
UNIT = "launches"
LAYER = "mapping"
MOVES = "setup_s"


def read(r):
    j = program_trace.from_readings(r)
    if not j or not j["launches"] or not j["keyframes"]:
        return None
    return j["launches_by_layer"].get("mapping", 0) / j["keyframes"]
