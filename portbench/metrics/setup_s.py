"""setup_s: from the process's start to the window's start: imports, the
kernels' build (first run only), the rendered sequence, the System and the
warm frames."""

SOURCE = "host_clock"
UNIT = "s"
LAYER = None
MOVES = None


def read(r):
    return r["setup_s"]
