"""Order-preserving fixed-width key encoding for the conflict kernels.

FDB keys are variable-length byte strings compared lexicographically
(REF:flow/Arena.h StringRef::compare, used throughout
REF:fdbserver/SkipList.cpp).  Device kernels want fixed shapes, so keys are encoded
into a fixed number of uint32 *lanes*:

    lanes[0 : W/4]  — the first W key bytes, big-endian, zero-padded
    lanes[W/4]      — min(len(key), W+1); W+1 marks ">W bytes, truncated"

Properties (proved by tests/test_keycode.py against random byte strings):

1. For keys with len <= W the encoding is injective and order-preserving:
   lexicographic comparison of lane vectors == lexicographic comparison of
   the byte strings.  (Zero-padding alone is not injective — b"ab" and
   b"ab\\x00" collide — which is why the length lane exists.)
2. For longer keys the encoding is monotone (a <= b implies enc(a) <= enc(b))
   and the only information loss is between two truncated keys sharing
   their first W bytes, whose encodings are equal.  ``possibly_lt`` treats
   that case as "maybe <", which makes conflict detection *conservative*:
   it can report a false conflict (safe — an unnecessary retry) but never
   a false negative (which would break serializability).

The all-ones lane vector is reserved as a padding sentinel: no real key
encodes to it (the length lane is at most W+1), so a padded range
[SENTINEL, SENTINEL) can never overlap anything.
"""

from __future__ import annotations

import numpy as np

DEFAULT_WIDTH = 32  # bytes of exact prefix; KEY_ENCODE_BYTES knob


def nlanes(width: int = DEFAULT_WIDTH) -> int:
    assert width % 4 == 0
    return width // 4 + 1


def sentinel(width: int = DEFAULT_WIDTH) -> np.ndarray:
    return np.full(nlanes(width), 0xFFFFFFFF, dtype=np.uint32)


def encode_key(key: bytes, width: int = DEFAULT_WIDTH) -> np.ndarray:
    out = np.zeros(nlanes(width), dtype=np.uint32)
    prefix = key[:width]
    for i in range(0, len(prefix), 4):
        chunk = prefix[i:i + 4]
        out[i // 4] = int.from_bytes(chunk.ljust(4, b"\x00"), "big")
    out[-1] = min(len(key), width + 1)
    return out


_kc_lib = None


def _keycodec():
    """The native codec (native/keycodec.cpp), built with g++ at first
    use.  There is no numpy fallback: a codec that does not build raises
    with the compiler's message."""
    global _kc_lib
    if _kc_lib is None:
        import ctypes

        from ..native import load_library

        lib = load_library("keycodec")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        i64 = ctypes.c_int64
        lib.kc_encode.argtypes = [ctypes.c_char_p, i64p, i64, i64, u32p]
        lib.kc_encode.restype = None
        lib.kc_encode_batch.argtypes = [
            ctypes.c_char_p, i64p, i32p, i32p, i64, i64, i64, i64,
            u32p, u32p, u32p, u32p]
        lib.kc_encode_batch.restype = None
        lib.kc_dict_new.argtypes = [i64]
        lib.kc_dict_new.restype = ctypes.c_void_p
        lib.kc_dict_free.argtypes = [ctypes.c_void_p]
        lib.kc_dict_free.restype = None
        lib.kc_dict_group.argtypes = [ctypes.c_void_p]
        lib.kc_dict_group.restype = None
        lib.kc_dict_live.argtypes = [ctypes.c_void_p]
        lib.kc_dict_live.restype = i64
        lib.kc_encode_batch_ids.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, i64p, i32p, i32p,
            i64, i64, i64, i64, u32p, u32p, u32p, u32p,
            u32p, u32p, i64, i64]
        lib.kc_encode_batch_ids.restype = i64
        lib.kc_encode_group_ids2.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, i64p, i32p, i32p, i32p,
            i64, i64, i64, i64, i64, u32p, u32p, u32p, i64, i64p]
        lib.kc_encode_group_ids2.restype = i64
        pvp = ctypes.POINTER(ctypes.c_void_p)
        lib.kc_encode_group_fused.argtypes = [
            ctypes.c_void_p,
            pvp,                         # blobs: array of byte ptrs
            pvp,                         # offs_list
            pvp, pvp,                    # nr_list, nw_list
            pvp,                         # snaps_list
            i32p,                        # counts
            i64p,                        # versions
            i64, i64, i64, i64, i64,
            u32p, u32p, u32p, i64, i64p, i64p]
        lib.kc_encode_group_fused.restype = i64
        _kc_lib = lib
    return _kc_lib


def _blob(keys: list[bytes]) -> tuple[bytes, np.ndarray, np.ndarray]:
    """(joined bytes, lengths [n], cumulative offsets [n+1]) of keys."""
    n = len(keys)
    lens = np.fromiter((len(k) for k in keys), dtype=np.int64, count=n)
    offs = np.empty(n + 1, dtype=np.int64)
    offs[0] = 0
    np.cumsum(lens, out=offs[1:])
    return b"".join(keys), lens, offs


def encode_keys(keys: list[bytes], width: int = DEFAULT_WIDTH) -> np.ndarray:
    """Batch encode → [N, nlanes] uint32: one join and one native call."""
    n = len(keys)
    out = np.empty((n, nlanes(width)), dtype=np.uint32)
    if n:
        flat_b, _, offs = _blob(keys)
        _keycodec().kc_encode(flat_b, offs, n, width, out)
    return out


def encode_keys_plain(keys: list[bytes],
                      width: int = DEFAULT_WIDTH) -> np.ndarray:
    """The codec's plain version: ``encode_keys`` by one numpy gather."""
    n = len(keys)
    L = nlanes(width)
    if n == 0:
        return np.zeros((0, L), dtype=np.uint32)
    flat_b, lens, offs = _blob(keys)
    flat = np.frombuffer(flat_b, dtype=np.uint8)
    starts = offs[:-1]
    plens = np.minimum(lens, width)
    buf = np.zeros((n, width), dtype=np.uint8)
    cols = np.arange(width)[None, :]
    mask = cols < plens[:, None]
    # clip keeps the flat index in range for masked-out (padding) cells
    src = np.minimum(starts[:, None] + cols, max(len(flat) - 1, 0))
    buf[mask] = flat[src[mask]]
    lanes = buf.reshape(n, width // 4, 4).astype(np.uint32)
    packed = (lanes[:, :, 0] << 24) | (lanes[:, :, 1] << 16) | (lanes[:, :, 2] << 8) | lanes[:, :, 3]
    out = np.empty((n, L), dtype=np.uint32)
    out[:, :-1] = packed
    out[:, -1] = np.minimum(lens, width + 1).astype(np.uint32)
    return out


def prefix_u64(key: bytes) -> int:
    """First 8 key bytes big-endian, zero-padded — lanes 0-1 of
    ``encode_key`` fused into one uint64.  Monotone: a <= b implies
    prefix_u64(a) <= prefix_u64(b), so a searchsorted over an array of
    these narrows any exact bisect to the equal-prefix band."""
    return int.from_bytes(key[:8].ljust(8, b"\x00"), "big")


def encode_prefix_u64(keys: list[bytes]) -> np.ndarray:
    """Vectorized ``prefix_u64`` over a sorted (or any) key list →
    uint64[N].  Used by storage/key_index.py as the searchsorted fast
    path for range bounds over large key indexes — the storage-side
    cousin of the resolver's ``encode_keys`` lane packing."""
    n = len(keys)
    if n == 0:
        return np.zeros(0, dtype=np.uint64)
    flat_b, lens, offs = _blob(keys)
    flat = np.frombuffer(flat_b, dtype=np.uint8)
    starts = offs[:-1]
    plens = np.minimum(lens, 8)
    buf = np.zeros((n, 8), dtype=np.uint8)
    cols = np.arange(8)[None, :]
    mask = cols < plens[:, None]
    # clip keeps the flat index in range for masked-out (padding) cells
    src = np.minimum(starts[:, None] + cols, max(len(flat) - 1, 0))
    buf[mask] = flat[src[mask]]
    return buf.view(">u8").ravel().astype(np.uint64)


def decode_trunc_flag(enc: np.ndarray, width: int = DEFAULT_WIDTH):
    """True where the encoded key was truncated (len lane == W+1)."""
    return enc[..., -1] == width + 1


def lex_lt(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Strict lexicographic < over the last (lane) axis, broadcasting the rest."""
    L = a.shape[-1]
    lt = np.zeros(np.broadcast_shapes(a.shape[:-1], b.shape[:-1]), dtype=bool)
    eq = np.ones_like(lt)
    for l in range(L):
        al, bl = a[..., l], b[..., l]
        lt = lt | (eq & (al < bl))
        eq = eq & (al == bl)
    return lt


def lex_eq(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    L = a.shape[-1]
    eq = np.ones(np.broadcast_shapes(a.shape[:-1], b.shape[:-1]), dtype=bool)
    for l in range(L):
        eq = eq & (a[..., l] == b[..., l])
    return eq


def possibly_lt(a: np.ndarray, b: np.ndarray,
                width: int = DEFAULT_WIDTH) -> np.ndarray:
    """True where the *true* byte strings might satisfy a < b.

    Exact (== definite) unless both keys were truncated to the same prefix.
    """
    both_trunc = (a[..., -1] == width + 1) & (b[..., -1] == width + 1)
    return lex_lt(a, b) | (lex_eq(a, b) & both_trunc)
