"""k1_roofline: the least time the shapes of K1's calls allow
(`roofline.k1`, over the H100's 3.35 TB/s and 67 TFLOP/s) over the
kernel's device time in the profile, in percent. Nothing to read where the
kernel did not run."""

SOURCE = "device_trace"
UNIT = "%"
LAYER = "ORB kernel K1"
MOVES = "setup_s"


def read(r):
    t = r.get("trace", {})
    dev = t.get("kernel_s", {}).get("k1")
    if not dev:
        return None
    return 100.0 * t["bound_s"]["k1"] / dev
