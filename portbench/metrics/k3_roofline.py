"""k3_roofline: the least time the shapes of K3's calls allow
(`roofline.k3`, over the H100's 3.35 TB/s and 67 TFLOP/s) over the
kernel's device time in the profile, in percent. Nothing to read where the
kernel did not run."""

SOURCE = "device_trace"
UNIT = "%"
LAYER = "BA scatter kernels K2 K3"
MOVES = "setup_s"


def read(r):
    t = r.get("trace", {})
    dev = t.get("kernel_s", {}).get("k3")
    if not dev:
        return None
    return 100.0 * t["bound_s"]["k3"] / dev
