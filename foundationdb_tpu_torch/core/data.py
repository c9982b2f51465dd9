"""Shared transaction data types.

Reference: REF:flow/Arena.h (KeyRef/KeyRangeRef/StringRef),
REF:fdbclient/CommitTransaction.h (MutationRef, CommitTransactionRef),
REF:fdbclient/FDBTypes.h (KeySelectorRef, Version).  Keys and values are
plain ``bytes``; Python's refcounted immutable bytes replace the Arena —
no region allocator is needed because nothing here is manually managed.
"""

from __future__ import annotations

import dataclasses
import enum
import struct
import sys
from array import array as _array

from ..runtime.errors import InvertedRange, KeyOutsideLegalRange

# MutationBatch.bounds is little-endian u32 ON THE WIRE (like every other
# fixed-width field in rpc/wire.py); the fast in-memory views below are
# native-order, so big-endian hosts byte-swap at the boundary (a no-op on
# the little-endian hosts everything actually runs on)
_NATIVE_LE = sys.byteorder == "little"


def _bounds_to_wire(bounds: "_array") -> bytes:
    if not _NATIVE_LE:
        bounds = _array("I", bounds)
        bounds.byteswap()
    return bounds.tobytes()

Version = int
INVALID_VERSION: Version = -1
MAX_VERSION: Version = (1 << 63) - 1

# Keys at or above \xff are the system keyspace (REF:fdbclient/SystemData.cpp);
# \xff\xff is the special-key space handled client-side.
SYSTEM_PREFIX = b"\xff"
SPECIAL_PREFIX = b"\xff\xff"
MAX_KEY = b"\xff\xff\xff"  # allowedRange end for system-access txns


def key_after(key: bytes) -> bytes:
    """Smallest key strictly greater than ``key`` (keyAfter in REF:flow)."""
    return key + b"\x00"


def strinc(key: bytes) -> bytes:
    """Smallest key greater than every key with prefix ``key`` (strinc).

    Strips trailing 0xff bytes and increments the last remaining byte;
    all-0xff input has no upper bound and raises, like the reference.
    """
    k = key.rstrip(b"\xff")
    if not k:
        raise KeyOutsideLegalRange("strinc of empty/all-0xff key")
    return k[:-1] + bytes([k[-1] + 1])


@dataclasses.dataclass(frozen=True, order=True)
class KeyRange:
    """Half-open [begin, end); empty if begin >= end (KeyRangeRef)."""

    begin: bytes
    end: bytes

    def __post_init__(self):
        if self.begin > self.end:
            raise InvertedRange(f"{self.begin!r} > {self.end!r}")

    @property
    def empty(self) -> bool:
        return self.begin >= self.end

    def contains(self, key: bytes) -> bool:
        return self.begin <= key < self.end

    def intersects(self, other: "KeyRange") -> bool:
        return self.begin < other.end and other.begin < self.end

    def intersection(self, other: "KeyRange") -> "KeyRange":
        if not self.intersects(other):
            return KeyRange(self.begin, self.begin)  # empty
        return KeyRange(max(self.begin, other.begin), min(self.end, other.end))

    @staticmethod
    def single(key: bytes) -> "KeyRange":
        return KeyRange(key, key_after(key))

    @staticmethod
    def all() -> "KeyRange":
        return KeyRange(b"", b"\xff")

    @staticmethod
    def everything() -> "KeyRange":
        return KeyRange(b"", MAX_KEY)


class MutationType(enum.IntEnum):
    """Mutation opcodes (MutationRef::Type, REF:fdbclient/CommitTransaction.h).

    Numeric values match upstream where an equivalent exists so a future C
    ABI can pass them through unchanged.
    """

    SET_VALUE = 0
    CLEAR_RANGE = 1
    ADD = 2
    # upstream has deprecated And/Or at 3/4; we use the *IfExists-correct
    # versions the C API exposes (fdb_c.h FDBMutationType)
    BIT_AND = 6
    BIT_OR = 7
    BIT_XOR = 8
    APPEND_IF_FITS = 9
    MAX = 12
    MIN = 13
    SET_VERSIONSTAMPED_KEY = 14
    SET_VERSIONSTAMPED_VALUE = 15
    BYTE_MIN = 16
    BYTE_MAX = 17
    COMPARE_AND_CLEAR = 20
    # Private mutations (no upstream opcode equivalent at this number):
    # control messages the commit proxy injects into a storage tag's
    # mutation stream so ownership changes land at an exact version
    # (REF:fdbserver/ApplyMetadataMutation.cpp private mutations with the
    # \xff\xff systemKeysPrefix).  param1=begin, param2=end of the range
    # this tag stops owning as of the mutation's version.
    PRIVATE_DROP_SHARD = 30
    # Change-feed control markers (REF:fdbserver/ApplyMetadataMutation.cpp
    # changeFeedPrivatePrefix): a \xff/changeFeeds state transaction is
    # translated by the OWNING commit proxy into these, tagged to every
    # storage tag whose shard intersects the feed range, so feed
    # lifecycle transitions land at an exact point in each tag's version
    # order.  REGISTER: param1=feed id, param2=encoded {begin, end}.
    # DESTROY: param1=feed id.  POP: param1=feed id, param2=encoded
    # pop version (the consumer's durable low-water mark).
    PRIVATE_FEED_REGISTER = 31
    PRIVATE_FEED_DESTROY = 32
    PRIVATE_FEED_POP = 33


PRIVATE_TYPES = frozenset((
    MutationType.PRIVATE_DROP_SHARD, MutationType.PRIVATE_FEED_REGISTER,
    MutationType.PRIVATE_FEED_DESTROY, MutationType.PRIVATE_FEED_POP,
))

ATOMIC_TYPES = frozenset(
    t for t in MutationType
    if t not in (MutationType.SET_VALUE, MutationType.CLEAR_RANGE)
    and t not in PRIVATE_TYPES
)


@dataclasses.dataclass(frozen=True)
class Mutation:
    """One mutation: set(param1=key, param2=value), clear(param1=begin,
    param2=end), or atomic(param1=key, param2=operand) — MutationRef."""

    type: MutationType
    param1: bytes
    param2: bytes

    @staticmethod
    def set(key: bytes, value: bytes) -> "Mutation":
        return Mutation(MutationType.SET_VALUE, key, value)

    @staticmethod
    def clear_range(begin: bytes, end: bytes) -> "Mutation":
        return Mutation(MutationType.CLEAR_RANGE, begin, end)

    @property
    def is_atomic(self) -> bool:
        return self.type in ATOMIC_TYPES


@dataclasses.dataclass
class MutationBatch:
    """Packed columnar mutation batch — the commit pipeline's wire form
    (PROTOCOL_VERSION 712).

    Built ONCE per commit batch at the commit proxy and shipped as-is
    through tagging, TLog append/spill/peek, and the storage apply path
    (the flat-buffer discipline of REF:fdbserver/TLogServer.actor.cpp's
    opaque StringRef message blocks: mutation payloads never need to be
    re-materialized between roles).  Layout:

    - ``types``  — one ``MutationType`` code byte per mutation;
    - ``bounds`` — native little-endian u32 pairs, one per mutation:
      (param1 end, param2 end), cumulative offsets into ``blob`` (so
      mutation i's param1 starts at pair i-1's param2 end);
    - ``blob``   — every param1+param2 concatenated in mutation order.

    ``nbytes`` (the TLog's queue accounting unit) is O(1): len(blob).
    Consumers that need ``Mutation`` objects (atomics, metadata paths,
    backup/DR replay) decode lazily per item via ``__iter__``/indexing.
    For simple SET/CLEAR batches the type codes coincide with the
    storage engines' WAL op codes (OP_SET=0, OP_CLEAR=1), so a packed
    batch doubles as a durability-buffer segment with zero copies.
    """

    types: bytes = b""
    bounds: bytes = b""
    blob: bytes = b""

    def __len__(self) -> int:
        return len(self.types)

    def __bool__(self) -> bool:
        return bool(self.types)

    @property
    def nbytes(self) -> int:
        return len(self.blob)

    def offsets(self):
        """Indexable u32 view of ``bounds`` (cached; index 2i = param1
        end, 2i+1 = param2 end of mutation i).  A zero-copy memoryview
        cast on little-endian hosts; a byte-swapped array on big-endian
        ones (bounds is little-endian on the wire)."""
        offs = self.__dict__.get("_offs")
        if offs is None:
            if _NATIVE_LE:
                offs = memoryview(self.bounds).cast("I")
            else:
                offs = _array("I")
                offs.frombytes(self.bounds)
                offs.byteswap()
            self.__dict__["_offs"] = offs
        return offs

    @property
    def simple_only(self) -> bool:
        """True when every op is a plain SET_VALUE/CLEAR_RANGE — the
        storage fast path that never builds ``Mutation`` objects."""
        s = self.__dict__.get("_simple")
        if s is None:
            t = self.types
            s = (max(t) <= 1) if t else True
            self.__dict__["_simple"] = s
        return s

    def param1(self, i: int) -> bytes:
        offs = self.offsets()
        return self.blob[(offs[2 * i - 1] if i else 0):offs[2 * i]]

    def param2(self, i: int) -> bytes:
        offs = self.offsets()
        return self.blob[offs[2 * i]:offs[2 * i + 1]]

    def mutation(self, i: int) -> "Mutation":
        offs = self.offsets()
        start = offs[2 * i - 1] if i else 0
        e1, e2 = offs[2 * i], offs[2 * i + 1]
        return Mutation(MutationType(self.types[i]),
                        self.blob[start:e1], self.blob[e1:e2])

    def __getitem__(self, i: int) -> "Mutation":
        n = len(self.types)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        return self.mutation(i)

    def __iter__(self):
        for i in range(len(self.types)):
            yield self.mutation(i)

    def iter_ops(self):
        """(type_code, param1, param2) triples — the engine WAL op shape
        for simple-only batches (type codes == OP codes)."""
        offs = self.offsets()
        blob = self.blob
        types = self.types
        prev = 0
        for i in range(len(types)):
            e1, e2 = offs[2 * i], offs[2 * i + 1]
            yield types[i], blob[prev:e1], blob[e1:e2]
            prev = e2

    def set_payload_bytes(self) -> int:
        """Sum of param bytes over SET_VALUE ops (logical-size
        accounting) without materializing any payload."""
        offs = self.offsets()
        types = self.types
        total = prev = 0
        for i in range(len(types)):
            e2 = offs[2 * i + 1]
            if types[i] == 0:           # SET_VALUE
                total += e2 - prev
            prev = e2
        return total

    def select(self, idxs: list[int]) -> "MutationBatch":
        """Sub-batch of the given (non-decreasing) mutation indices —
        how the proxy slices one packed batch per destination tag and
        how a storage server clips a batch to a change feed's range.
        Selecting exactly everything returns self (the single-shard
        common case ships with zero copies); a same-length list with
        duplicates is NOT the identity and is sliced for real.

        Offset arithmetic is vectorized with numpy above a small-list
        threshold: change feeds make
        per-apply ``select`` calls hot, and the cumulative-offset
        rebuild is exactly a gather + cumsum."""
        n_sel = len(idxs)
        if n_sel == len(self.types) \
                and all(idxs[i] == i for i in range(n_sel)):
            return self
        blob = self.blob
        if n_sel < 16:
            # tiny slices (the proxy's few-mutations-per-tag case):
            # numpy call overhead exceeds the loop
            offs = self.offsets()
            bounds = _array("I")
            chunks: list[bytes] = []
            pos = 0
            for i in idxs:
                start = offs[2 * i - 1] if i else 0
                e1, e2 = offs[2 * i], offs[2 * i + 1]
                chunks.append(blob[start:e2])
                pos += e2 - start
                bounds.append(pos - (e2 - e1))
                bounds.append(pos)
            return MutationBatch(bytes(self.types[i] for i in idxs),
                                 _bounds_to_wire(bounds), b"".join(chunks))
        import numpy as np
        idx = np.asarray(idxs, dtype=np.int64)
        offs = np.frombuffer(self.bounds, dtype="<u4").astype(np.int64)
        e1 = offs[2 * idx]
        e2 = offs[2 * idx + 1]
        # param1 of mutation i starts at pair i-1's param2 end (0 for i=0);
        # offs[-1] under the mask is never selected by the where
        starts = np.where(idx > 0, offs[2 * idx - 1], 0)
        pos = np.cumsum(e2 - starts)
        bounds_arr = np.empty(2 * n_sel, dtype="<u4")
        bounds_arr[0::2] = pos - (e2 - e1)
        bounds_arr[1::2] = pos
        types = np.frombuffer(self.types, dtype=np.uint8)[idx].tobytes()
        return MutationBatch(
            types, bounds_arr.tobytes(),
            b"".join(blob[s:e] for s, e in zip(starts.tolist(), e2.tolist())))

    @classmethod
    def from_mutations(cls, muts) -> "MutationBatch":
        b = MutationBatchBuilder()
        for m in muts:
            b.add(int(m.type), m.param1, m.param2)
        return b.finish()


class _PackedKeys:
    """Shared surface for the packed key/value columns of the multiget
    wire structs: one contiguous ``blob`` plus little-endian u32
    cumulative end offsets (``bounds``), exactly the MutationBatch
    offset discipline with a single column."""

    def __len__(self) -> int:
        return len(self.bounds) // 4

    def offsets(self):
        offs = self.__dict__.get("_offs")
        if offs is None:
            if _NATIVE_LE:
                offs = memoryview(self.bounds).cast("I")
            else:
                offs = _array("I")
                offs.frombytes(self.bounds)
                offs.byteswap()
            self.__dict__["_offs"] = offs
        return offs

    def _item(self, blob: bytes, i: int) -> bytes:
        offs = self.offsets()
        return blob[(offs[i - 1] if i else 0):offs[i]]


# GetValuesReply per-key status codes: one byte per key so a single
# too-old/moved key degrades that KEY, not the whole batch RPC.
GV_FOUND, GV_MISSING, GV_TOO_OLD, GV_FUTURE_VERSION, GV_WRONG_SHARD = range(5)
# status byte -> FDB error code (runtime.errors.error_from_code)
GV_ERROR_CODES = {GV_TOO_OLD: 1007, GV_FUTURE_VERSION: 1009,
                  GV_WRONG_SHARD: 1001}


@dataclasses.dataclass
class GetValuesRequest(_PackedKeys):
    """Packed multi-key point-read batch (PROTOCOL_VERSION 714) — the
    getValuesQ analog of the paper's storage-server read batching
    (REF:fdbserver/storageserver.actor.cpp getValueQ, batched).

    ``keys`` holds every probe key concatenated in SORTED ascending
    order (distinct — the client's coalescer dedupes); ``bounds`` is
    one little-endian u32 cumulative end offset per key.  Sortedness is
    part of the wire contract: the storage server resolves shard/drop
    fences as contiguous index runs via bisect, and the engines'
    ``get_batch`` descend their sorted runs once per leaf/block run.
    """

    version: Version = 0
    bounds: bytes = b""
    keys: bytes = b""

    def key(self, i: int) -> bytes:
        return self._item(self.keys, i)

    def iter_keys(self):
        offs = self.offsets()
        blob = self.keys
        prev = 0
        for i in range(len(offs)):
            e = offs[i]
            yield blob[prev:e]
            prev = e

    @classmethod
    def from_keys(cls, keys: list, version: Version) -> "GetValuesRequest":
        bounds = _array("I")
        pos = 0
        for k in keys:
            pos += len(k)
            bounds.append(pos)
        return cls(version, _bounds_to_wire(bounds), b"".join(keys))


@dataclasses.dataclass
class GetValuesReply(_PackedKeys):
    """Reply to GetValuesRequest: ``codes`` is one status byte per key
    (GV_FOUND / GV_MISSING / a GV_* error code), ``blob`` the found
    values concatenated, ``bounds`` one cumulative u32 end per key
    (missing/errored keys occupy a zero-length span)."""

    codes: bytes = b""
    bounds: bytes = b""
    blob: bytes = b""

    def value(self, i: int) -> bytes:
        return self._item(self.blob, i)

    def unpack(self, i: int) -> tuple[int | None, bytes | None]:
        """(FDB error code or None, value or None) for key i — the ONE
        home of the per-key status contract, shared by the coalescer
        and ``get_multi`` so the decode can never diverge.  GV_MISSING
        (and any unknown future code) decodes as (None, None)."""
        c = self.codes[i]
        if c == GV_FOUND:
            return None, self.value(i)
        return GV_ERROR_CODES.get(c), None

    @classmethod
    def build(cls, codes, values: list) -> "GetValuesReply":
        """``values`` aligned with ``codes``; None contributes nothing."""
        bounds = _array("I")
        chunks: list[bytes] = []
        pos = 0
        for v in values:
            if v:
                chunks.append(v)
                pos += len(v)
            bounds.append(pos)
        return cls(bytes(codes), _bounds_to_wire(bounds), b"".join(chunks))

    @classmethod
    def uniform(cls, code: int, n: int) -> "GetValuesReply":
        """Whole-batch status (a batch-wide wait failed before any
        per-key work): every key carries ``code``, no payload."""
        return cls(bytes([code]) * n, _bounds_to_wire(_array("I", [0] * n)),
                   b"")


class PackedRows:
    """Columnar key-value rows — one key blob + one value blob, each
    with little-endian cumulative u32 end offsets (the MutationBatch /
    GetValuesReply bounds discipline, two columns).  THE carrier of a
    packed range page everywhere rows move in bulk: ``GetRangeReply``
    exposes its payload as one, the client's packed snapshot stream
    concatenates reply pages into one per backup file, and
    ``BackupContainer`` writes the columns to disk verbatim — so a
    snapshot page read over the wire reaches the ``.kvr`` frame without
    ever re-materializing a tuple list.

    Rows are stored in SCAN order (ascending for forward reads); the
    row surface (``__len__``/``__getitem__``/``__iter__``/``key``/
    ``value``) makes it a drop-in for a ``list[tuple[bytes, bytes]]``
    consumer that only iterates and indexes."""

    __slots__ = ("key_bounds", "key_blob", "val_bounds", "val_blob",
                 "_ko", "_vo")

    def __init__(self, key_bounds: bytes = b"", key_blob: bytes = b"",
                 val_bounds: bytes = b"", val_blob: bytes = b"") -> None:
        self.key_bounds = key_bounds
        self.key_blob = key_blob
        self.val_bounds = val_bounds
        self.val_blob = val_blob
        self._ko = None
        self._vo = None

    def __len__(self) -> int:
        return len(self.key_bounds) // 4

    @staticmethod
    def _offs(bounds: bytes):
        if _NATIVE_LE:
            return memoryview(bounds).cast("I")
        a = _array("I")
        a.frombytes(bounds)
        a.byteswap()
        return a

    def _koffs(self):
        if self._ko is None:
            self._ko = self._offs(self.key_bounds)
        return self._ko

    def _voffs(self):
        if self._vo is None:
            self._vo = self._offs(self.val_bounds)
        return self._vo

    def key(self, i: int) -> bytes:
        offs = self._koffs()
        return self.key_blob[(offs[i - 1] if i else 0):offs[i]]

    def value(self, i: int) -> bytes:
        offs = self._voffs()
        return self.val_blob[(offs[i - 1] if i else 0):offs[i]]

    def __getitem__(self, i: int) -> tuple[bytes, bytes]:
        n = len(self)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        return self.key(i), self.value(i)

    def __iter__(self):
        return iter(self.rows())

    def rows(self) -> list[tuple[bytes, bytes]]:
        """Materialize [(key, value), ...] — the bounds unpack is all
        C-speed map/zip over slice objects, never a per-row Python
        frame: this is the client-side unpack of every reply chunk."""
        n = len(self)
        if not n:
            return []
        from itertools import starmap
        ko = list(self._koffs())
        vo = list(self._voffs())
        ks = map(self.key_blob.__getitem__,
                 starmap(slice, zip([0] + ko, ko)))
        vs = map(self.val_blob.__getitem__,
                 starmap(slice, zip([0] + vo, vo)))
        return list(zip(ks, vs))

    def nbytes(self) -> int:
        return len(self.key_blob) + len(self.val_blob)

    def slice(self, lo: int, hi: int) -> "PackedRows":
        """Rows [lo, hi) as a new PackedRows (bounds rebased)."""
        n = len(self)
        lo, hi = max(0, lo), min(hi, n)
        if lo >= hi:
            return PackedRows()
        if lo == 0 and hi == n:
            return self
        ko, vo = self._koffs(), self._voffs()
        kp = ko[lo - 1] if lo else 0
        vp = vo[lo - 1] if lo else 0
        kb = _array("I", (ko[i] - kp for i in range(lo, hi)))
        vb = _array("I", (vo[i] - vp for i in range(lo, hi)))
        return PackedRows(_bounds_to_wire(kb), self.key_blob[kp:ko[hi - 1]],
                          _bounds_to_wire(vb), self.val_blob[vp:vo[hi - 1]])

    @classmethod
    def from_rows(cls, rows) -> "PackedRows":
        """Pack (key, value) sequences — the bounds build is C-speed
        (map(len) through itertools.accumulate), never a per-row Python
        loop: this runs once per reply chunk on the serving path."""
        from itertools import accumulate
        if not isinstance(rows, list):
            rows = list(rows)
        if not rows:
            return cls()
        ks, vs = zip(*rows)
        ko = _array("I", accumulate(map(len, ks)))
        vo = _array("I", accumulate(map(len, vs)))
        return cls(_bounds_to_wire(ko), b"".join(ks),
                   _bounds_to_wire(vo), b"".join(vs))

    @classmethod
    def concat(cls, parts: list["PackedRows"]) -> "PackedRows":
        """Concatenate pages: blobs join, bounds rebase by the running
        blob offsets (a vectorized add — never a per-row re-slice)."""
        parts = [p for p in parts if len(p)]
        if not parts:
            return cls()
        if len(parts) == 1:
            return parts[0]
        import numpy as np
        kbs: list[bytes] = []
        vbs: list[bytes] = []
        kblobs: list[bytes] = []
        vblobs: list[bytes] = []
        kbase = vbase = 0
        for p in parts:
            for bounds, base, out in ((p.key_bounds, kbase, kbs),
                                      (p.val_bounds, vbase, vbs)):
                arr = np.frombuffer(bounds, dtype="<u4")
                out.append((arr + np.uint32(base)).astype("<u4").tobytes()
                           if base else bounds)
            kblobs.append(p.key_blob)
            vblobs.append(p.val_blob)
            kbase += len(p.key_blob)
            vbase += len(p.val_blob)
        return cls(b"".join(kbs), b"".join(kblobs),
                   b"".join(vbs), b"".join(vblobs))


@dataclasses.dataclass
class GetRangeRequest:
    """Packed range-read request (PROTOCOL_VERSION 715) — the
    getKeyValuesQ shape (REF:fdbserver/storageserver.actor.cpp
    getKeyValuesQ) with the reply columnar.  Limits mirror the legacy
    ``get_key_values`` positional surface exactly: ``limit`` rows,
    ``byte_limit`` payload bytes (the crossing row is included),
    ``reverse`` scans descending."""

    begin: bytes = b""
    end: bytes = b""
    version: Version = 0
    limit: int = 0
    reverse: bool = False
    byte_limit: int = 0


@dataclasses.dataclass
class GetRangeReply:
    """Reply to GetRangeRequest: rows as packed columns plus ONE
    per-chunk status byte and a ``more`` continuation flag.

    ``status`` reuses the GV_* codes (GV_FOUND == 0 == ok): a chunk that
    cannot be served at all — too-old version, future version, a
    relinquished/moved range — refuses WHOLESALE with the code instead
    of raising through the RPC, so the client's replica failover can
    distinguish "this replica lags" (try a teammate) from "the team no
    longer owns the range" (refresh the shard map), exactly the
    GetValuesReply discipline.  ``more`` true means limits truncated the
    chunk; the continuation cursor is the last row's key (the client
    resumes from ``key_after(last)`` forward, exclusive-``last``
    reverse, as the legacy tuple path always has)."""

    status: int = 0
    more: bool = False
    key_bounds: bytes = b""
    key_blob: bytes = b""
    val_bounds: bytes = b""
    val_blob: bytes = b""

    def __len__(self) -> int:
        return len(self.key_bounds) // 4

    def columns(self) -> PackedRows:
        """The payload as a PackedRows — zero-copy (the same byte
        strings; no per-row work)."""
        return PackedRows(self.key_bounds, self.key_blob,
                          self.val_bounds, self.val_blob)

    def rows(self) -> list[tuple[bytes, bytes]]:
        return self.columns().rows()

    @classmethod
    def from_rows(cls, rows, more: bool) -> "GetRangeReply":
        p = rows if isinstance(rows, PackedRows) else PackedRows.from_rows(rows)
        return cls(0, more, p.key_bounds, p.key_blob,
                   p.val_bounds, p.val_blob)

    @classmethod
    def refuse(cls, status: int) -> "GetRangeReply":
        """Whole-chunk refusal: no payload, just the GV_* code."""
        return cls(status, False)


@dataclasses.dataclass
class GetKeyRequest:
    """Packed selector-resolve request (PROTOCOL_VERSION 716)
    — the getKeyQ shape (REF:fdbserver/storageserver.actor.cpp getKeyQ).
    Asks one storage server for the ``offset``-th LIVE row of its clip
    of [begin, end) at ``version`` (counting from the end when
    ``reverse``).  The client walks shards with the residual offset, so
    a cross-shard selector costs one tiny reply per shard instead of
    shipping ``offset`` full rows through the range path — the last
    per-row client surface gone columnar."""

    begin: bytes = b""
    end: bytes = b""
    version: Version = 0
    offset: int = 1
    reverse: bool = False


@dataclasses.dataclass
class GetKeyReply:
    """Reply to GetKeyRequest: ONE key instead of ``offset`` rows.

    ``status`` reuses the GV_* codes (0 = ok) with the GetRangeReply
    wholesale-refusal discipline (a lagging/compacted replica refuses,
    the client's replica failover tries a teammate).  ``count`` is how
    many live rows the clip actually held (capped at the requested
    offset); when ``count == offset``, ``key`` is the resolved key —
    otherwise the client carries ``offset - count`` into the next
    shard."""

    status: int = 0
    count: int = 0
    key: bytes = b""


@dataclasses.dataclass
class ScrubPageRequest:
    """Paged shard-checksum request (PROTOCOL_VERSION 718) —
    the consistency-scan read shape (REF:fdbserver/workloads/
    ConsistencyCheck.actor.cpp checkDataConsistency, paged).  Asks one
    storage server for per-page digests over its clip of [begin, end)
    at a pinned ``version``: pages are cut every ``page_rows`` LIVE
    rows (a LOGICAL boundary, so replicas running different engines —
    or none — page identically over identical data), at most
    ``max_pages`` pages per request.  The digest pass rides the run-
    wise columnar extraction; no per-row tuples are materialized on
    the server."""

    begin: bytes = b""
    end: bytes = b""
    version: Version = 0
    page_rows: int = 256
    max_pages: int = 32


@dataclasses.dataclass
class ScrubPageReply:
    """Reply to ScrubPageRequest: one (end_key, row_count, digest)
    triple per page, columnar.

    ``status`` reuses the GV_* codes with the GetRangeReply wholesale-
    refusal discipline — a lagging/compacted/moved replica refuses the
    WHOLE request and the scrubber re-pins or re-routes; a refusal is
    never a mismatch (the zero-false-positive lever).  ``end_blob``
    holds each page's LAST key concatenated with cumulative u32
    ``end_bounds`` (the shared bounds discipline), ``counts`` one
    little-endian u32 live-row count per page, ``digests`` 8 bytes of
    blake2b per page.  ``more`` true means the range continues past
    the last page's end key; the scrubber resumes from
    ``key_after(last_end)``."""

    status: int = 0
    more: bool = False
    end_bounds: bytes = b""
    end_blob: bytes = b""
    counts: bytes = b""
    digests: bytes = b""

    def __len__(self) -> int:
        return len(self.counts) // 4

    def pages(self) -> list[tuple[bytes, int, bytes]]:
        """Decode to [(end_key, count, digest)] — comparison form."""
        offs = _array("I")
        offs.frombytes(self.end_bounds)
        counts = _array("I")
        counts.frombytes(self.counts)
        if not _NATIVE_LE:
            offs.byteswap()
            counts.byteswap()
        out = []
        prev = 0
        for i, e in enumerate(offs):
            out.append((self.end_blob[prev:e], counts[i],
                        self.digests[8 * i:8 * i + 8]))
            prev = e
        return out

    @classmethod
    def from_pages(cls, pages: list, more: bool) -> "ScrubPageReply":
        """``pages`` is [(end_key, count, digest)] in scan order."""
        bounds = _array("I")
        counts = _array("I")
        pos = 0
        for end_key, count, _ in pages:
            pos += len(end_key)
            bounds.append(pos)
            counts.append(count)
        return cls(0, more, _bounds_to_wire(bounds),
                   b"".join(p[0] for p in pages), _bounds_to_wire(counts),
                   b"".join(p[2] for p in pages))

    @classmethod
    def refuse(cls, status: int) -> "ScrubPageReply":
        """Whole-request refusal: no payload, just the GV_* code."""
        return cls(status, False)


class MutationBatchBuilder:
    """Append-only MutationBatch assembly (one blob join at finish)."""

    __slots__ = ("_types", "_bounds", "_chunks", "_pos")

    def __init__(self) -> None:
        self._types = bytearray()
        self._bounds = _array("I")
        self._chunks: list[bytes] = []
        self._pos = 0

    def __len__(self) -> int:
        return len(self._types)

    def add(self, type_code: int, p1: bytes, p2: bytes) -> int:
        """Append one mutation; returns its index in the batch."""
        i = len(self._types)
        self._types.append(type_code)
        self._chunks.append(p1)
        self._chunks.append(p2)
        self._pos += len(p1)
        self._bounds.append(self._pos)
        self._pos += len(p2)
        self._bounds.append(self._pos)
        return i

    def finish(self) -> MutationBatch:
        assert self._pos < (1 << 32), "mutation batch blob exceeds u32 offsets"
        return MutationBatch(bytes(self._types),
                             _bounds_to_wire(self._bounds),
                             b"".join(self._chunks))


def as_mutation_batch(msgs) -> MutationBatch:
    """Normalize a TLog message payload: packed batches pass through,
    legacy ``list[Mutation]`` (old DiskQueue frames, unit tests, sidecar
    producers) packs once at the boundary."""
    if isinstance(msgs, MutationBatch):
        return msgs
    return MutationBatch.from_mutations(msgs)


def _pad_to_common(a: bytes, b: bytes) -> tuple[bytes, bytes, int]:
    n = max(len(a), len(b))
    return a.ljust(n, b"\x00"), b.ljust(n, b"\x00"), n


def _as_le_int(b: bytes) -> int:
    return int.from_bytes(b, "little", signed=False)


def apply_atomic(op: MutationType, existing: bytes | None, operand: bytes) -> bytes | None:
    """Evaluate an atomic op against the current value (doAtomicOp,
    REF:fdbserver/storageserver.actor.cpp + flow/Arena atomics).

    Returns the new value, or None meaning "clear the key"
    (COMPARE_AND_CLEAR match).
    """
    if op == MutationType.ADD:
        old = existing if existing is not None else b""
        n = len(operand)
        if n == 0:
            return b""
        total = (_as_le_int(old[:n].ljust(n, b"\x00")) + _as_le_int(operand)) % (1 << (8 * n))
        return total.to_bytes(n, "little")
    if op in (MutationType.BIT_AND, MutationType.BIT_OR, MutationType.BIT_XOR):
        # Modern opcodes are the AndV2-style *IfExists semantics: on a
        # missing key the operand is stored unchanged.
        if existing is None:
            return operand
        a, b, n = _pad_to_common(existing, operand)
        if op == MutationType.BIT_AND:
            return bytes(x & y for x, y in zip(a, b))
        if op == MutationType.BIT_OR:
            return bytes(x | y for x, y in zip(a, b))
        return bytes(x ^ y for x, y in zip(a, b))
    if op == MutationType.APPEND_IF_FITS:
        old = existing if existing is not None else b""
        from ..runtime.knobs import KNOBS
        if len(old) + len(operand) <= KNOBS.VALUE_SIZE_LIMIT:
            return old + operand
        return old
    if op == MutationType.MAX:
        old = existing if existing is not None else b""
        a, b, n = _pad_to_common(old, operand)
        return a if _as_le_int(a) >= _as_le_int(b) else b
    if op == MutationType.MIN:
        if existing is None:
            return operand
        a, b, n = _pad_to_common(existing, operand)
        return a if _as_le_int(a) <= _as_le_int(b) else b
    if op == MutationType.BYTE_MIN:
        if existing is None:
            return operand
        return min(existing, operand)
    if op == MutationType.BYTE_MAX:
        if existing is None:
            return operand
        return max(existing, operand)
    if op == MutationType.COMPARE_AND_CLEAR:
        if existing is not None and existing == operand:
            return None  # clear
        return existing
    raise ValueError(f"unhandled atomic op {op}")


@dataclasses.dataclass(frozen=True)
class KeySelector:
    """Resolves to a key relative to an anchor (KeySelectorRef).

    Semantics (REF:fdbclient/NativeAPI.actor.cpp resolveKey): start from
    the anchor key; if or_equal, step past it; then move |offset| keys
    forward (offset > 0) or backward (offset <= 0) in the database.
    offset=1, or_equal=False is firstGreaterOrEqual(key).
    """

    key: bytes
    or_equal: bool = False
    offset: int = 1

    @staticmethod
    def first_greater_or_equal(key: bytes) -> "KeySelector":
        return KeySelector(key, False, 1)

    @staticmethod
    def first_greater_than(key: bytes) -> "KeySelector":
        return KeySelector(key, True, 1)

    @staticmethod
    def last_less_or_equal(key: bytes) -> "KeySelector":
        return KeySelector(key, True, 0)

    @staticmethod
    def last_less_than(key: bytes) -> "KeySelector":
        return KeySelector(key, False, 0)

    def __add__(self, n: int) -> "KeySelector":
        return KeySelector(self.key, self.or_equal, self.offset + n)

    def __sub__(self, n: int) -> "KeySelector":
        return KeySelector(self.key, self.or_equal, self.offset - n)


@dataclasses.dataclass
class CommitTransactionRequest:
    """The commit payload a client sends to a commit proxy
    (CommitTransactionRequest wrapping CommitTransactionRef,
    REF:fdbclient/CommitProxyInterface.h + CommitTransaction.h)."""

    read_conflict_ranges: list[tuple[bytes, bytes]]
    write_conflict_ranges: list[tuple[bytes, bytes]]
    mutations: list[Mutation]
    read_snapshot: Version
    report_conflicting_keys: bool = False
    # FDB's LOCK_AWARE transaction option: permitted to commit while the
    # database is locked (REF:fdbclient/NativeAPI.actor.cpp lockedKey check)
    lock_aware: bool = False

    def expected_size(self) -> int:
        n = 0
        for m in self.mutations:
            n += len(m.param1) + len(m.param2)
        for b, e in self.read_conflict_ranges:
            n += len(b) + len(e)
        for b, e in self.write_conflict_ranges:
            n += len(b) + len(e)
        return n


@dataclasses.dataclass
class CommitResult:
    """Reply to a commit: the committed version, or raised FdbError."""

    version: Version
    versionstamp: bytes  # 10-byte commit versionstamp (8B version + 2B batch order)


def pack_versionstamp(version: Version, order: int) -> bytes:
    return struct.pack(">QH", version, order)
