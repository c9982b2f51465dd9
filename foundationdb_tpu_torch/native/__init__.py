"""Native (C++) components, loaded via ctypes over a C ABI.

The reference is ~90% C++ (REF:fdbserver/, REF:flow/); here native code
backs the pieces where Python can't meet the bar: the CPU conflict-set
baseline (the skiplist-analog, REF:fdbserver/SkipList.cpp) and, later,
hot IO paths.  Libraries build on demand with g++ (no pybind11 in the
image — plain C ABI + ctypes).
"""

from __future__ import annotations

import ctypes

from .build import build


def load_library(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(build(name))
