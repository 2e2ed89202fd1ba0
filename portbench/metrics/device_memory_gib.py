"""device_memory_gib: the device memory the system holds at its peak over
set-up and the window, from the CUDA allocator's own record of the card:
its peak less what the benchmark's inputs (the rendered sequence and the
world) hold there, in GiB. Nothing to read without a card."""

SOURCE = "device_trace"
UNIT = "GiB"
LAYER = None
MOVES = None


def read(r):
    return r.get("memory_gib")
