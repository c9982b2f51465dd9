"""Subspace — tuple-addressed key prefixes.

Reference: REF:bindings/python/fdb/subspace_impl.py — a Subspace wraps a
byte prefix; keys inside it are ``prefix + tuple.pack(t)``, so the
ordered tuple encoding gives each subspace a contiguous, nestable key
range.  The API (pack/unpack/range/contains/subscript) is the
cross-binding standard surface layers build on (Directory, queues,
indexes).
"""

from __future__ import annotations

from . import tuple as tuplelayer


class Subspace:
    def __init__(self, prefix_tuple: tuple = (), raw_prefix: bytes = b"") -> None:
        self._prefix = bytes(raw_prefix) + tuplelayer.pack(tuple(prefix_tuple))

    @classmethod
    def from_raw(cls, raw_prefix: bytes) -> "Subspace":
        return cls((), raw_prefix)

    def key(self) -> bytes:
        return self._prefix

    def pack(self, t: tuple = ()) -> bytes:
        return self._prefix + tuplelayer.pack(tuple(t))

    def unpack(self, key: bytes) -> tuple:
        if not self.contains(key):
            raise ValueError("key is not in this subspace")
        return tuplelayer.unpack(key[len(self._prefix):])

    def range(self, t: tuple = ()) -> tuple[bytes, bytes]:
        """[begin, end) covering every key packed under tuple ``t`` in this
        subspace (strict: the bare ``pack(t)`` key itself is excluded,
        matching the reference's ``Subspace.range``)."""
        p = self.pack(t)
        return p + b"\x00", p + b"\xff"

    def contains(self, key: bytes) -> bool:
        return key.startswith(self._prefix)

    def subspace(self, t: tuple) -> "Subspace":
        return Subspace.from_raw(self.pack(t))

    def __getitem__(self, item) -> "Subspace":
        return self.subspace((item,))

    def __repr__(self) -> str:
        return f"Subspace(raw_prefix={self._prefix!r})"

    def __eq__(self, other) -> bool:
        return isinstance(other, Subspace) and self._prefix == other._prefix

    def __hash__(self) -> int:
        return hash(self._prefix)
