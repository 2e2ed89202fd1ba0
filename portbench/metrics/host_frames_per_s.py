"""host_frames_per_s: the poses returned inside the window over the time
from its start to the first return after `--seconds`, after a synchronise.
The program is paced by the host, so the rate follows the host's own speed
from run to run."""

SOURCE = "host_clock"
UNIT = "frames/s"
LAYER = "entry"
MOVES = "setup_s"


def read(r):
    return r["frames"] / r["window_s"]
