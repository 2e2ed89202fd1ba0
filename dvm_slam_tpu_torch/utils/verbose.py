"""Leveled logging (`Verbose::PrintMess`, `orb_slam3/include/System.h:47-66`):
QUIET < NORMAL < VERBOSE < VERY_VERBOSE < DEBUG, globally settable.

A copy of `dvm_slam_tpu/utils/verbose.py` (stdlib only): the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import sys

QUIET = 0
NORMAL = 1
VERBOSE = 2
VERY_VERBOSE = 3
DEBUG = 4

_level = NORMAL


def set_verbosity(level: int):
    global _level
    _level = level


def get_verbosity() -> int:
    return _level


def print_mess(msg: str, level: int = NORMAL, file=None):
    if level <= _level:
        print(msg, file=file or sys.stdout)
