"""Self-describing binary wire codec.

Reference: REF:flow/serialize.h + ObjectSerializer/flat_buffers — FDB
serializes RPC structs into a tagged binary format so old/new versions can
interoperate.  This codec is deliberately simple and deterministic:
tag byte + payload, varints for ints, length-prefixed bytes, and a
registry for dataclass "structs" (encoded as tag + registry id + field
list).  numpy arrays are supported for the resolver batch path (dtype
string + shape + raw bytes, C-order).

Not pickle: no code execution on decode, stable across processes, and
implementable from C++ for the native bridge.
"""

from __future__ import annotations

import dataclasses
import enum
import struct as _struct
from typing import Any, Type

import numpy as np

# tags
_NONE, _FALSE, _TRUE, _INT, _NEGINT, _BYTES, _STR, _LIST, _TUPLE, _DICT, \
    _STRUCT, _FLOAT, _NDARRAY, _ENUM = range(14)

_STRUCTS: dict[int, Type] = {}
_STRUCT_IDS: dict[Type, int] = {}
_ENUMS: dict[int, Type] = {}
_ENUM_IDS: dict[Type, int] = {}


def register_struct(cls: Type, *, sid: int | None = None) -> Type:
    """Register a dataclass for wire encoding.  Ids are assigned in
    registration order; both sides must register the same structs in the
    same order (they share the module that defines them)."""
    i = sid if sid is not None else len(_STRUCTS)
    assert i not in _STRUCTS, f"struct id {i} taken"
    _STRUCTS[i] = cls
    _STRUCT_IDS[cls] = i
    return cls


def register_enum(cls: Type, *, eid: int | None = None) -> Type:
    i = eid if eid is not None else len(_ENUMS)
    _ENUMS[i] = cls
    _ENUM_IDS[cls] = i
    return cls


def _put_varint(out: bytearray, n: int) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _get_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    n = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not (b & 0x80):
            return n, pos
        shift += 7


def _enc(out: bytearray, obj: Any) -> None:
    if obj is None:
        out.append(_NONE)
    elif obj is False:
        out.append(_FALSE)
    elif obj is True:
        out.append(_TRUE)
    elif isinstance(obj, enum.Enum):
        out.append(_ENUM)
        _put_varint(out, _ENUM_IDS[type(obj)])
        _put_varint(out, obj.value)
    elif isinstance(obj, int):
        if obj >= 0:
            out.append(_INT)
            _put_varint(out, obj)
        else:
            out.append(_NEGINT)
            _put_varint(out, -obj)
    elif isinstance(obj, float):
        out.append(_FLOAT)
        out += _struct.pack("<d", obj)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        out.append(_BYTES)
        b = bytes(obj)
        _put_varint(out, len(b))
        out += b
    elif isinstance(obj, str):
        out.append(_STR)
        b = obj.encode("utf-8")
        _put_varint(out, len(b))
        out += b
    elif isinstance(obj, list):
        out.append(_LIST)
        _put_varint(out, len(obj))
        for x in obj:
            _enc(out, x)
    elif isinstance(obj, tuple):
        out.append(_TUPLE)
        _put_varint(out, len(obj))
        for x in obj:
            _enc(out, x)
    elif isinstance(obj, dict):
        out.append(_DICT)
        _put_varint(out, len(obj))
        for k, v in obj.items():
            _enc(out, k)
            _enc(out, v)
    elif isinstance(obj, np.ndarray):
        out.append(_NDARRAY)
        dt = obj.dtype.str.encode()
        _put_varint(out, len(dt))
        out += dt
        _put_varint(out, obj.ndim)
        for d in obj.shape:
            _put_varint(out, d)
        b = np.ascontiguousarray(obj).tobytes()
        _put_varint(out, len(b))
        out += b
    elif dataclasses.is_dataclass(obj) and type(obj) in _STRUCT_IDS:
        out.append(_STRUCT)
        _put_varint(out, _STRUCT_IDS[type(obj)])
        fields = dataclasses.fields(obj)
        _put_varint(out, len(fields))
        for f in fields:
            _enc(out, getattr(obj, f.name))
    else:
        raise TypeError(f"cannot encode {type(obj)}")


def encode(obj: Any) -> bytes:
    out = bytearray()
    _enc(out, obj)
    return bytes(out)


def _dec(buf: memoryview, pos: int) -> tuple[Any, int]:
    tag = buf[pos]
    pos += 1
    if tag == _NONE:
        return None, pos
    if tag == _FALSE:
        return False, pos
    if tag == _TRUE:
        return True, pos
    if tag == _INT:
        return _get_varint(buf, pos)
    if tag == _NEGINT:
        n, pos = _get_varint(buf, pos)
        return -n, pos
    if tag == _FLOAT:
        return _struct.unpack_from("<d", buf, pos)[0], pos + 8
    if tag == _BYTES:
        n, pos = _get_varint(buf, pos)
        return bytes(buf[pos:pos + n]), pos + n
    if tag == _STR:
        n, pos = _get_varint(buf, pos)
        return bytes(buf[pos:pos + n]).decode("utf-8"), pos + n
    if tag in (_LIST, _TUPLE):
        n, pos = _get_varint(buf, pos)
        items = []
        for _ in range(n):
            x, pos = _dec(buf, pos)
            items.append(x)
        return (items if tag == _LIST else tuple(items)), pos
    if tag == _DICT:
        n, pos = _get_varint(buf, pos)
        d = {}
        for _ in range(n):
            k, pos = _dec(buf, pos)
            v, pos = _dec(buf, pos)
            d[k] = v
        return d, pos
    if tag == _NDARRAY:
        n, pos = _get_varint(buf, pos)
        dt = np.dtype(bytes(buf[pos:pos + n]).decode())
        pos += n
        ndim, pos = _get_varint(buf, pos)
        shape = []
        for _ in range(ndim):
            d, pos = _get_varint(buf, pos)
            shape.append(d)
        n, pos = _get_varint(buf, pos)
        arr = np.frombuffer(bytes(buf[pos:pos + n]), dtype=dt).reshape(shape)
        return arr, pos + n
    if tag == _ENUM:
        eid, pos = _get_varint(buf, pos)
        val, pos = _get_varint(buf, pos)
        return _ENUMS[eid](val), pos
    if tag == _STRUCT:
        sid, pos = _get_varint(buf, pos)
        cls = _STRUCTS[sid]
        n, pos = _get_varint(buf, pos)
        vals = []
        for _ in range(n):
            v, pos = _dec(buf, pos)
            vals.append(v)
        return cls(*vals), pos
    raise ValueError(f"bad tag {tag} at {pos - 1}")


_FRAME_HDR = _struct.Struct("<II")      # payload length, crc32(payload)


def frame(payload: bytes) -> bytes:
    """crc32-stamp one payload: [u32 len][u32 crc][payload] — the shared
    torn-write detector for single-blob durable files (engine snapshots,
    manifests, commit headers).  A torn or corrupted write
    fails ``unframe`` instead of decoding into garbage."""
    import zlib
    return _FRAME_HDR.pack(len(payload), zlib.crc32(payload)) + payload


def unframe(raw: bytes) -> bytes:
    """Inverse of ``frame``; raises ValueError on a short or corrupt
    frame (callers map that to their torn-vs-corrupt policy)."""
    import zlib
    if len(raw) < _FRAME_HDR.size:
        raise ValueError("short frame")
    length, crc = _FRAME_HDR.unpack_from(raw)
    payload = raw[_FRAME_HDR.size:_FRAME_HDR.size + length]
    if len(payload) != length or zlib.crc32(payload) != crc:
        raise ValueError("frame crc mismatch")
    return payload


def decode(data: bytes) -> Any:
    obj, pos = _dec(memoryview(data), 0)
    if pos != len(data):
        raise ValueError(f"trailing {len(data) - pos} bytes")
    return obj


class SlottedBlob:
    """Dual-slot crc-framed single-blob persistence — THE one audited
    corruption policy for small durable state files: the lsm MANIFEST, the
    coordinator state, and the backup
    ``logs.manifest`` each hand-rolled the same discipline three times.

    Invariants (the DiskQueue ``_write_header`` discipline):

    - writes ALTERNATE between two slot files, so the slot not being
      written always holds the previous synced payload — a kill tearing
      one write can never destroy the committed state;
    - the sequence number advances only AFTER the write+sync, so a
      failed (retried) save re-targets the SAME slot, never the one
      holding the freshest synced state;
    - ``load`` returns the highest-seq slot that passes its crc frame; a
      torn slot silently loses to the intact one.  What to do when
      slots exist but NONE decodes is the CALLER's policy (each site
      raises its own corruption class with its own evidence rule) —
      ``slots_seen`` carries the evidence.

    The payload travels as ``frame(MAGIC + seq_u64_le + payload)``, so
    the seq lives inside the crc envelope and sites no longer embed
    their own copy.  The magic makes the envelope self-identifying: a
    pre-helper slot (``frame(encode(dict))`` — encode output always
    leads with a type tag < 14, never an ASCII 'S') also passes
    ``unframe``, and without the magic its first 8 content bytes would
    parse as a garbage seq and the mis-sliced remainder would be
    returned as a "valid" payload — crashing every caller's decode AND
    making their legacy-format fallbacks unreachable.  Callers own
    serialization of concurrent saves (two in-flight saves could
    otherwise dirty BOTH slots at once)."""

    MAGIC = b"SBv1"

    def __init__(self, fs, base: str,
                 suffixes: tuple[str, str] = (".a", ".b")) -> None:
        self.fs = fs
        self.base = base
        self.suffixes = suffixes
        self._seq: int | None = None    # lazily learned from load

    def _slot(self, seq: int) -> str:
        return self.base + self.suffixes[0 if seq % 2 else 1]

    def seed(self, seq: int) -> None:
        """Arm the save sequence from a LEGACY-format slot's embedded
        seq (the envelope-migration path): keeps the alternation parity
        continuous so the next save never targets the only valid
        old-format slot."""
        self._seq = seq

    async def load(self) -> tuple[bytes | None, int]:
        """(newest valid payload or None, slot files seen).  Also arms
        the save sequence, so load-before-first-save is the expected
        lifecycle (a never-loaded save starts at seq 1)."""
        best: bytes | None = None
        best_seq = 0
        seen = 0
        for suffix in self.suffixes:
            f = self.fs.open(self.base + suffix)
            try:
                raw = await f.read(0, f.size())
            finally:
                await f.close()
            if not raw:
                continue
            seen += 1
            try:
                payload = unframe(raw)
                if not payload.startswith(self.MAGIC):
                    # a pre-helper-format slot (or foreign frame): not
                    # ours to parse — the caller's legacy fallback owns
                    # it, and it still counts as evidence in ``seen``
                    continue
                m = len(self.MAGIC)
                seq = int.from_bytes(payload[m:m + 8], "little")
                body = payload[m + 8:]
            except Exception:   # noqa: BLE001 — torn slot: other one wins
                continue
            if best is None or seq > best_seq:
                best, best_seq = body, seq
        if self._seq is None or best_seq > self._seq:
            self._seq = best_seq
        return best, seen

    async def save(self, payload: bytes) -> int:
        """Write ``payload`` into the next slot; returns the new seq."""
        if self._seq is None:
            await self.load()
        seq = (self._seq or 0) + 1
        f = self.fs.open(self._slot(seq))
        blob = frame(self.MAGIC + seq.to_bytes(8, "little") + payload)
        try:
            # a faulted disk op must not leak the handle — persist
            # retries on a sick disk (an erroring disk)
            # would otherwise exhaust fds one per attempt
            await f.write(0, blob)
            await f.truncate(len(blob))
            await f.sync()
        finally:
            await f.close()
        self._seq = seq
        return seq


def _register_core_structs() -> None:
    """Register the shared RPC structs in one canonical order."""
    from ..core import change_feed as cf
    from ..core import data as d
    from ..core import resolver as r
    from ..core import tlog as t
    from ..ops import batch as b
    from ..runtime import span as sp
    register_enum(d.MutationType, eid=0)
    for i, cls in enumerate([
        d.Mutation, d.KeyRange, d.KeySelector, d.CommitTransactionRequest,
        d.CommitResult, b.TxnRequest, r.ResolveBatchRequest,
        r.ResolveBatchReply, t.TLogPushRequest, t.TLogPeekReply,
        sp.SpanEnvelope, d.MutationBatch,
        cf.ChangeFeedStreamRequest, cf.ChangeFeedStreamReply,
        d.GetValuesRequest, d.GetValuesReply,
        d.GetRangeRequest, d.GetRangeReply,
        d.GetKeyRequest, d.GetKeyReply,
        d.ScrubPageRequest, d.ScrubPageReply,
    ]):
        register_struct(cls, sid=i)


_register_core_structs()
