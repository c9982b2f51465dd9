"""Python binding over the C ABI (NOT the native client).

Reference: REF:bindings/python/fdb/impl.py — the real Python binding
dlopens fdb_c and goes through the C surface; this does the same against
the port's libfdbtpu_c.so via ctypes, so the ABI itself is exercised
end to end.  (The port's native client — foundationdb_tpu_torch.client —
stays the fast path; this module exists to prove the binding surface.)

The library is ``foundationdb_tpu_torch/_build/libfdbtpu_c.so``, built
by ``foundationdb_tpu_torch/native/build.py`` at the first ``open`` when
it is missing or older than its source.  The repository root must be
importable (the library's host module is
``foundationdb_tpu_torch.capi_host``).
"""

from __future__ import annotations

import ctypes

_lib: ctypes.CDLL | None = None


class FdbtpuError(Exception):
    def __init__(self, code: int, message: str = ""):
        super().__init__(f"fdbtpu error {code}: {message}")
        self.code = code


def _check(code: int) -> None:
    if code != 0:
        msg = _lib.fdbtpu_get_error(code).decode()
        raise FdbtpuError(code, msg)


def open(cluster_file: str) -> "Database":
    """Start the network against the cluster file; returns the database."""
    global _lib
    if _lib is None:
        from foundationdb_tpu_torch.native.build import build
        lib = ctypes.CDLL(build("fdbtpu_c"), mode=ctypes.RTLD_GLOBAL)
        lib.fdbtpu_init.argtypes = [ctypes.c_char_p]
        lib.fdbtpu_create_transaction.argtypes = [
            ctypes.POINTER(ctypes.c_void_p)]
        lib.fdbtpu_transaction_destroy.argtypes = [ctypes.c_void_p]
        lib.fdbtpu_transaction_get.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int)]
        lib.fdbtpu_transaction_set.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int]
        lib.fdbtpu_transaction_clear.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.fdbtpu_transaction_get_range.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.fdbtpu_transaction_atomic_op.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int]
        lib.fdbtpu_transaction_get_read_version.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
        lib.fdbtpu_transaction_set_option.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p]
        lib.fdbtpu_transaction_commit.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
        lib.fdbtpu_transaction_on_error.argtypes = [ctypes.c_void_p,
                                                    ctypes.c_int]
        lib.fdbtpu_transaction_reset.argtypes = [ctypes.c_void_p]
        lib.fdbtpu_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        lib.fdbtpu_get_error.restype = ctypes.c_char_p
        lib.fdbtpu_get_error.argtypes = [ctypes.c_int]
        _lib = lib
        _check(_lib.fdbtpu_init(cluster_file.encode()))
    return Database()


class Database:
    def create_transaction(self) -> "CTransaction":
        h = ctypes.c_void_p()
        _check(_lib.fdbtpu_create_transaction(ctypes.byref(h)))
        return CTransaction(h)

    def run(self, fn):
        """The @transactional retry loop over the C surface."""
        tr = self.create_transaction()
        try:
            while True:
                try:
                    out = fn(tr)
                    tr.commit()
                    return out
                except FdbtpuError as e:
                    rc = _lib.fdbtpu_transaction_on_error(tr._h, e.code)
                    if rc != 0:
                        raise
        finally:
            tr.destroy()


class CTransaction:
    def __init__(self, handle):
        self._h = handle

    def get(self, key: bytes) -> bytes | None:
        present = ctypes.c_int()
        val = ctypes.POINTER(ctypes.c_uint8)()
        vlen = ctypes.c_int()
        _check(_lib.fdbtpu_transaction_get(
            self._h, key, len(key), ctypes.byref(present),
            ctypes.byref(val), ctypes.byref(vlen)))
        if not present.value:
            return None
        out = ctypes.string_at(val, vlen.value)
        _lib.fdbtpu_free(val)
        return out

    def set(self, key: bytes, value: bytes) -> None:
        _check(_lib.fdbtpu_transaction_set(self._h, key, len(key),
                                           value, len(value)))

    def clear(self, key: bytes) -> None:
        _check(_lib.fdbtpu_transaction_clear(self._h, key, len(key)))

    def get_range(self, begin: bytes, end: bytes, limit: int = 0,
                  reverse: bool = False) -> list[tuple[bytes, bytes]]:
        buf = ctypes.POINTER(ctypes.c_uint8)()
        blen = ctypes.c_int()
        count = ctypes.c_int()
        _check(_lib.fdbtpu_transaction_get_range(
            self._h, begin, len(begin), end, len(end), limit,
            1 if reverse else 0, ctypes.byref(buf), ctypes.byref(blen),
            ctypes.byref(count)))
        raw = ctypes.string_at(buf, blen.value) if blen.value else b""
        # the C side mallocs even for empty results: free unconditionally
        _lib.fdbtpu_free(buf)
        out: list[tuple[bytes, bytes]] = []
        pos = 0
        import struct
        for _ in range(count.value):
            (klen,) = struct.unpack_from("<I", raw, pos)
            pos += 4
            k = raw[pos:pos + klen]
            pos += klen
            (vlen,) = struct.unpack_from("<I", raw, pos)
            pos += 4
            v = raw[pos:pos + vlen]
            pos += vlen
            out.append((k, v))
        return out

    def atomic_op(self, op: int, key: bytes, operand: bytes) -> None:
        _check(_lib.fdbtpu_transaction_atomic_op(
            self._h, op, key, len(key), operand, len(operand)))

    def add(self, key: bytes, operand: bytes) -> None:
        self.atomic_op(2, key, operand)            # MutationType.ADD

    def get_read_version(self) -> int:
        ver = ctypes.c_int64()
        _check(_lib.fdbtpu_transaction_get_read_version(
            self._h, ctypes.byref(ver)))
        return ver.value

    def set_option(self, option: str) -> None:
        _check(_lib.fdbtpu_transaction_set_option(self._h,
                                                  option.encode()))

    def commit(self) -> int:
        ver = ctypes.c_int64()
        _check(_lib.fdbtpu_transaction_commit(self._h, ctypes.byref(ver)))
        return ver.value

    def reset(self) -> None:
        _check(_lib.fdbtpu_transaction_reset(self._h))

    def destroy(self) -> None:
        if self._h:
            _lib.fdbtpu_transaction_destroy(self._h)
            self._h = None
