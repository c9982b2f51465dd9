"""ctypes wrapper for the C++ conflict set — the "cpp" resolver backend.

Exact byte-string semantics (no key encoding), matching the oracle on all
inputs; this is the CPU baseline BASELINE.md's north-star metric compares
the device kernels against.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .batch import TxnRequest
from ..native import load_library

_lib = None


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_library("conflictset")
        lib.cs_create.restype = ctypes.c_void_p
        lib.cs_create.argtypes = [ctypes.c_int64]
        lib.cs_destroy.argtypes = [ctypes.c_void_p]
        lib.cs_set_oldest.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.cs_get_oldest.restype = ctypes.c_int64
        lib.cs_get_oldest.argtypes = [ctypes.c_void_p]
        lib.cs_segment_count.restype = ctypes.c_int64
        lib.cs_segment_count.argtypes = [ctypes.c_void_p]
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.cs_resolve.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, i64p,
            i32p, i64p, i64p,
            i32p, i64p, i64p,
            ctypes.c_char_p, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS"),
        ]
        lib.cs_resolve_wire.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, i64p,
            i32p, i32p, i64p,
            ctypes.c_char_p, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS"),
        ]
        _lib = lib
    return _lib


class CppConflictSet:
    """Same resolve/oldest-version interface as the oracle, C++ speed."""

    def __init__(self, oldest_version: int = 0):
        self._lib = _get_lib()
        self._h = self._lib.cs_create(oldest_version)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.cs_destroy(self._h)
            self._h = None

    def set_oldest_version(self, v: int) -> None:
        self._lib.cs_set_oldest(self._h, v)

    @property
    def oldest_version(self) -> int:
        return self._lib.cs_get_oldest(self._h)

    @property
    def segment_count(self) -> int:
        return self._lib.cs_segment_count(self._h)

    def resolve_batch(self, txns: list[TxnRequest], commit_version: int) -> list[int]:
        n = len(txns)
        snapshots = np.empty(n, np.int64)
        r_off = np.empty(n + 1, np.int32)
        w_off = np.empty(n + 1, np.int32)
        blob_parts: list[bytes] = []
        r_offs: list[int] = []
        r_lens: list[int] = []
        w_offs: list[int] = []
        w_lens: list[int] = []
        pos = 0

        def add_key(k: bytes, offs, lens):
            nonlocal pos
            blob_parts.append(k)
            offs.append(pos)
            lens.append(len(k))
            pos += len(k)

        r_off[0] = w_off[0] = 0
        for i, t in enumerate(txns):
            snapshots[i] = t.read_snapshot
            for (b, e) in t.read_ranges:
                add_key(b, r_offs, r_lens)
                add_key(e, r_offs, r_lens)
            for (b, e) in t.write_ranges:
                add_key(b, w_offs, w_lens)
                add_key(e, w_offs, w_lens)
            r_off[i + 1] = len(r_offs) // 2
            w_off[i + 1] = len(w_offs) // 2

        verdicts = np.empty(n, np.int8)
        self._lib.cs_resolve(
            self._h, n, snapshots,
            r_off, np.asarray(r_offs, np.int64), np.asarray(r_lens, np.int64),
            w_off, np.asarray(w_offs, np.int64), np.asarray(w_lens, np.int64),
            b"".join(blob_parts), commit_version, verdicts)
        return verdicts.tolist()

    def resolve_wire(self, w, commit_version: int) -> list[int]:
        """Resolve a serialized WireBatch directly — zero Python walk;
        the baseline consumes the proxy wire form like the reference's
        resolver consumes its serialized request arena."""
        verdicts = np.empty(w.count, np.int8)
        self._lib.cs_resolve_wire(self._h, w.count, w.snapshots, w.nr,
                                  w.nw, w.offs, w.blob, commit_version,
                                  verdicts)
        return verdicts.tolist()

    # uniform backend interface (ops/backends.py)
    resolve = resolve_batch
