"""Vectorised key building: many keys at once as a padded byte matrix.

A set of keys is ``(mat, lens)``: ``mat`` [n, width] uint8, each key's
bytes left-aligned and zero-padded, and ``lens`` [n] int64.  The
generators build their keys this way, and ``flatten`` turns any list of
them into the one byte blob a wire batch carries.
"""

from __future__ import annotations

import numpy as np

INT_ZERO = 0x14         # the tuple layer's integer-zero code
STRING = 0x02           # the tuple layer's unicode-string code


def _fixed(prefix: bytes, n: int) -> tuple[np.ndarray, np.ndarray]:
    mat = np.tile(np.frombuffer(prefix, dtype=np.uint8), (n, 1))
    return mat, np.full(n, len(prefix), dtype=np.int64)


def concat(*parts: tuple[np.ndarray, np.ndarray]):
    """Row-wise concatenation of key sets of one length n."""
    n = parts[0][0].shape[0]
    lens = np.zeros(n, dtype=np.int64)
    width = sum(p[0].shape[1] for p in parts)
    out = np.zeros((n, width), dtype=np.uint8)
    rows = np.arange(n)
    for mat, plen in parts:
        for c in range(mat.shape[1]):
            m = c < plen
            out[rows[m], lens[m] + c] = mat[m, c]
        lens = lens + plen
    return trim(out, lens), lens


def trim(mat: np.ndarray, lens: np.ndarray) -> np.ndarray:
    width = int(lens.max()) if lens.size else 0
    return np.ascontiguousarray(mat[:, :width])


def tuple_int(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The tuple layer's encoding of non-negative ints below 2**63: the
    code 0x14 + n, then the value's n big-endian bytes (n = 0 for 0)."""
    v = np.asarray(v, dtype=np.int64)
    if v.size and int(v.min()) < 0:
        raise ValueError("tuple_int takes non-negative ints")
    nb = np.zeros(v.shape, dtype=np.int64)
    for k in range(8):
        nb += v >= (1 << (8 * k))
    be = np.stack([(v >> (8 * (7 - k))) & 0xFF for k in range(8)],
                  axis=1).astype(np.uint8)
    mat = np.zeros((v.size, 9), dtype=np.uint8)
    mat[:, 0] = INT_ZERO + nb
    for p in range(1, 9):
        src = np.clip(8 - nb + p - 1, 0, 7)
        mat[:, p] = np.where(p <= nb, be[np.arange(v.size), src], 0)
    return mat, 1 + nb


def tuple_keys(name: str, *ints: np.ndarray):
    """``pack((name, *ints))`` of the tuple layer for every row: the
    string ``name`` (no NUL bytes) then each int column."""
    n = np.asarray(ints[0]).size
    head = _fixed(bytes([STRING]) + name.encode() + b"\x00", n)
    return concat(head, *(tuple_int(c) for c in ints))


def decimal_keys(prefix: bytes, idx: np.ndarray, digits: int):
    """``prefix + str(i).zfill(digits)`` for every i (0 <= i < 10**18)."""
    idx = np.asarray(idx, dtype=np.int64)
    n = idx.size
    mat = np.zeros((n, len(prefix) + digits), dtype=np.uint8)
    mat[:, :len(prefix)] = np.frombuffer(prefix, dtype=np.uint8)
    for k in range(digits):
        power = digits - 1 - k
        col = len(prefix) + k
        if power > 18:
            mat[:, col] = ord("0")
        else:
            mat[:, col] = (idx // (10 ** power)) % 10 + ord("0")
    return mat, np.full(n, mat.shape[1], dtype=np.int64)


def with_suffix(keys, suffix: int):
    """Each key with one byte appended (``k + b'\\x00'`` is a point
    range's end)."""
    mat, lens = keys
    out = np.zeros((mat.shape[0], mat.shape[1] + 1), dtype=np.uint8)
    out[:, :mat.shape[1]] = mat
    out[np.arange(mat.shape[0]), lens] = suffix
    return out, lens + 1


def gather(sets: list, which: np.ndarray, row: np.ndarray):
    """Rows picked from several key sets: output i is row ``row[i]`` of
    set ``which[i]``."""
    width = max(s[0].shape[1] for s in sets)
    n = which.size
    mat = np.zeros((n, width), dtype=np.uint8)
    lens = np.zeros(n, dtype=np.int64)
    for k, (smat, slens) in enumerate(sets):
        m = which == k
        mat[m, :smat.shape[1]] = smat[row[m]]
        lens[m] = slens[row[m]]
    return mat, lens


def flatten(mat: np.ndarray, lens: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(blob uint8, offsets [n+1] int64): every key's bytes back to back."""
    width = mat.shape[1]
    mask = np.arange(width)[None, :] < lens[:, None]
    offs = np.zeros(lens.size + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    return mat[mask], offs
