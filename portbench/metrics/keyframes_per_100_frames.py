"""keyframes_per_100_frames: keyframes the program made of the frames fed
in the window, per 100 of those frames (read from its keyframe table once
the window has closed)."""

SOURCE = "program_counter"
UNIT = "kf/100frames"
LAYER = "mapping"
MOVES = "setup_s"


def read(r):
    return 100.0 * r["keyframes"] / r["fed"] if r["fed"] else None
