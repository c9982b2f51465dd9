"""Directory layer — hierarchical namespaces over short allocated prefixes.

Reference: REF:bindings/python/fdb/directory_impl.py — directories map
path tuples like ("app", "users") to short, allocator-assigned key
prefixes, stored in a node tree under ``\\xfe``; applications get a
DirectorySubspace per path and never embed long paths in keys.  The
cross-binding contract (same node tree layout, same allocator behavior)
is what lets every binding open the same directories.

Differences from the reference, driven by this client being async:
every operation takes an explicit transaction and is ``await``-ed; the
reference's transactional decorators become the caller's ``db.run``.

Components:

- ``HighContentionAllocator`` — windowed prefix allocator.  Counters
  advance a window; candidates are drawn uniformly from it and claimed
  with an OCC read+write of the candidate key, so concurrent allocators
  conflict on the claim (one retries) instead of on a single hot counter
  key.
- ``DirectoryLayer`` — create/open/move/remove/list over the node tree.
- ``DirectorySubspace`` — a Subspace bound to its path + layer, with
  directory methods relative to it.
- partitions (layer=b"partition") — a subtree whose nodes AND content
  live under the partition's own prefix, so the whole subtree moves as
  one unit.
"""

from __future__ import annotations

import struct

from . import tuple as tuplelayer
from ..runtime.rng import deterministic_random
from .subspace import Subspace

_SUBDIRS = 0
_VERSION = (1, 0, 0)


class DirectoryError(Exception):
    pass


class HighContentionAllocator:
    """REF:bindings/python/fdb/directory_impl.py::HighContentionAllocator.

    State: ``counters[start] -> allocation count`` (windows) and
    ``recent[candidate] -> b''`` (claims).  The window with the highest
    start is current; when it is half-consumed the window advances and
    older state is cleared.
    """

    def __init__(self, subspace: Subspace, rng=None) -> None:
        self.counters = subspace[0]
        self.recent = subspace[1]
        # injectable for the bindingtester (two implementations must draw
        # identical candidate sequences); defaults to the process RNG
        self._rng = rng

    @staticmethod
    def _window_size(start: int) -> int:
        if start < 255:
            return 64
        if start < 65535:
            return 1024
        return 8192

    async def _current_start(self, tr) -> int:
        rows = await tr.get_range(self.counters.key(),
                                  self.counters.key() + b"\xff",
                                  limit=1, reverse=True, snapshot=True)
        if not rows:
            return 0
        return self.counters.unpack(bytes(rows[0][0]))[0]

    async def allocate(self, tr) -> bytes:
        """Returns a packed integer never allocated before (and never
        again), usable as a key prefix shorter than a path tuple."""
        while True:
            start = await self._current_start(tr)
            window_advanced = False
            while True:
                if window_advanced:
                    tr.clear_range(self.counters.key(),
                                   self.counters.pack((start,)))
                    tr.clear_range(self.recent.key(),
                                   self.recent.pack((start,)))
                tr.add(self.counters.pack((start,)),
                       struct.pack("<q", 1))
                raw = await tr.get(self.counters.pack((start,)),
                                   snapshot=True)
                count = struct.unpack("<q", raw.ljust(8, b"\x00"))[0] \
                    if raw else 0
                window = self._window_size(start)
                if count * 2 < window:
                    break
                start += window
                window_advanced = True
            while True:
                # the process RNG, NOT os.urandom: every source of
                # randomness must flow through the seeded generator or
                # simulation replay loses bit-for-bit determinism
                rng = self._rng if self._rng is not None \
                    else deterministic_random()
                candidate = start + rng.random_int(0, window - 1)
                latest = await self._current_start(tr)
                if latest > start:
                    break       # window moved under us: restart outer
                # OCC claim: both contenders read the key and write it, so
                # each one's read conflicts with the other's write and
                # exactly one commits (the reference does the same with an
                # explicit write-conflict key)
                taken = await tr.get(self.recent.pack((candidate,)))
                tr.set(self.recent.pack((candidate,)), b"")
                if taken is None:
                    return tuplelayer.pack((candidate,))


class DirectorySubspace(Subspace):
    """A directory's content subspace, carrying its path and layer and
    offering directory ops relative to itself."""

    def __init__(self, path: tuple, prefix: bytes,
                 directory_layer: "DirectoryLayer", layer: bytes = b"") -> None:
        super().__init__((), prefix)
        self.path = tuple(path)
        self.layer = layer
        self._dl = directory_layer

    def _partition_subpath(self, path):
        return self.path[len(self._dl._path):] + tuple(path)

    def _effective_dl(self) -> "DirectoryLayer":
        return self._dl

    async def create_or_open(self, tr, path, layer: bytes = b""):
        return await self._effective_dl().create_or_open(
            tr, self._partition_subpath(path), layer)

    async def open(self, tr, path, layer: bytes = b""):
        return await self._effective_dl().open(
            tr, self._partition_subpath(path), layer)

    async def create(self, tr, path, layer: bytes = b"",
                     prefix: bytes | None = None):
        return await self._effective_dl().create(
            tr, self._partition_subpath(path), layer, prefix)

    async def list(self, tr, path=()):
        return await self._effective_dl().list(
            tr, self._partition_subpath(path))

    async def move_to(self, tr, new_path):
        return await self._dl.move(tr, self.path, tuple(new_path))

    async def move(self, tr, old_sub, new_sub):
        return await self._effective_dl().move(
            tr, self._partition_subpath(old_sub),
            self._partition_subpath(new_sub))

    async def remove(self, tr, path=()):
        return await self._effective_dl().remove(
            tr, self._partition_subpath(path))

    async def exists(self, tr, path=()) -> bool:
        return await self._effective_dl().exists(
            tr, self._partition_subpath(path))

    def __repr__(self) -> str:
        return f"DirectorySubspace(path={self.path}, prefix={self.key()!r})"


class DirectoryPartition(DirectorySubspace):
    """layer=b"partition": a subtree whose node metadata lives inside its
    own prefix, so moving/removing the partition moves everything.  Using
    a partition as a raw subspace is an error in the reference, and here."""

    def __init__(self, path: tuple, prefix: bytes,
                 parent_dl: "DirectoryLayer") -> None:
        super().__init__(path, prefix, parent_dl, b"partition")
        self._contents_dl = DirectoryLayer(
            node_subspace=Subspace.from_raw(prefix + b"\xfe"),
            content_subspace=Subspace.from_raw(prefix))
        self._contents_dl._path = tuple(path)

    def _effective_dl(self) -> "DirectoryLayer":
        return self._contents_dl

    def _partition_subpath(self, path):
        return tuple(path)

    def _raw_used(self, what: str):
        raise DirectoryError(
            f"cannot {what} a directory partition's raw subspace")

    def key(self):                    # noqa: D102 — guard, not accessor
        self._raw_used("key()")

    def pack(self, t=()):
        self._raw_used("pack()")

    def range(self, t=()):
        self._raw_used("range()")


class DirectoryLayer:
    def __init__(self,
                 node_subspace: Subspace | None = None,
                 content_subspace: Subspace | None = None,
                 rng=None) -> None:
        self._nodes = node_subspace if node_subspace is not None \
            else Subspace.from_raw(b"\xfe")
        self._content = content_subspace if content_subspace is not None \
            else Subspace()
        # the root node's key prefix is the node subspace's own prefix
        self._root = self._nodes[self._nodes.key()]
        self._allocator = HighContentionAllocator(self._root[b"hca"], rng)
        self._path: tuple = ()

    # --- node helpers.  A node is nodes[prefix]; children live at
    # node[_SUBDIRS][name] -> child_prefix; the layer id at node[b"layer"].

    def _node(self, prefix: bytes) -> Subspace:
        return self._nodes[prefix]

    def _prefix_of(self, node: Subspace) -> bytes:
        return self._nodes.unpack(node.key())[0]

    async def _check_version(self, tr, write: bool) -> None:
        raw = await tr.get(self._root.pack((b"version",)))
        if raw is None:
            if write:
                tr.set(self._root.pack((b"version",)),
                       struct.pack("<III", *_VERSION))
            return
        major, minor, _ = struct.unpack("<III", raw)
        if major != _VERSION[0]:
            raise DirectoryError(
                f"directory version {major}.{minor} unreadable")

    async def _route(self, tr, path: tuple):
        """Resolve partition crossings: a path whose PROPER ancestor is a
        partition belongs to that partition's own directory layer (its
        nodes live under the partition prefix, not this layer's \\xfe
        tree).  Returns (layer, subpath) — possibly (self, path)."""
        node = self._root
        for i, name in enumerate(path[:-1]):
            child = await tr.get(node.pack((_SUBDIRS, name)))
            if child is None:
                return self, path
            node = self._node(bytes(child))
            raw = await tr.get(node.pack((b"layer",)))
            if raw == b"partition":
                part = DirectoryPartition(
                    self._path + tuple(path[:i + 1]),
                    self._prefix_of(node), self)
                return await part._contents_dl._route(tr, path[i + 1:])
        return self, path

    async def _find(self, tr, path: tuple):
        """Walk the node tree; returns (node | None, layer) for path."""
        node = self._root
        layer = b""
        for name in path:
            child = await tr.get(node.pack((_SUBDIRS, name)))
            if child is None:
                return None, b""
            node = self._node(bytes(child))
            raw = await tr.get(node.pack((b"layer",)))
            layer = bytes(raw) if raw is not None else b""
        return node, layer

    def _contents(self, path: tuple, node: Subspace,
                  layer: bytes) -> DirectorySubspace:
        prefix = self._prefix_of(node)
        full = self._path + tuple(path)
        if layer == b"partition":
            return DirectoryPartition(full, prefix, self)
        return DirectorySubspace(full, prefix, self, layer)

    async def _node_containing_key(self, tr, key: bytes):
        """The deepest existing node whose prefix contains key, if any —
        the prefix-freedom probe (REF directory_impl.py NodeFinder)."""
        if key.startswith(self._nodes.key()):
            return self._root
        rows = await tr.get_range(self._nodes.key(),
                                  self._nodes.pack((key,)) + b"\x00",
                                  limit=1, reverse=True, snapshot=True)
        for k, _ in rows:
            prev = self._nodes.unpack(bytes(k))[0]
            if key.startswith(prev):
                return self._node(prev)
        return None

    async def _is_prefix_free(self, tr, prefix: bytes) -> bool:
        if not prefix:
            return False
        if await self._node_containing_key(tr, prefix) is not None:
            return False
        rows = await tr.get_range(self._nodes.pack((prefix,)),
                                  self._nodes.pack((prefix + b"\xff",)),
                                  limit=1, snapshot=True)
        return not rows

    # --- public surface ---

    async def create_or_open(self, tr, path, layer: bytes = b""):
        return await self._create_or_open(tr, tuple(path), layer,
                                          prefix=None, allow_create=True,
                                          allow_open=True)

    async def open(self, tr, path, layer: bytes = b""):
        return await self._create_or_open(tr, tuple(path), layer,
                                          prefix=None, allow_create=False,
                                          allow_open=True)

    async def create(self, tr, path, layer: bytes = b"",
                     prefix: bytes | None = None):
        return await self._create_or_open(tr, tuple(path), layer,
                                          prefix=prefix, allow_create=True,
                                          allow_open=False)

    async def _create_or_open(self, tr, path: tuple, layer: bytes,
                              prefix: bytes | None, allow_create: bool,
                              allow_open: bool):
        await self._check_version(tr, write=False)
        if not path:
            raise DirectoryError("the root directory cannot be opened")
        dl, sub = await self._route(tr, path)
        if dl is not self:
            return await dl._create_or_open(tr, sub, layer, prefix,
                                            allow_create, allow_open)
        existing, found_layer = await self._find(tr, path)
        if existing is not None:
            if not allow_open:
                raise DirectoryError(f"directory {path} already exists")
            if layer and found_layer != layer:
                raise DirectoryError(
                    f"{path}: layer mismatch ({found_layer!r} != {layer!r})")
            return self._contents(path, existing, found_layer)
        if not allow_create:
            raise DirectoryError(f"directory {path} does not exist")
        await self._check_version(tr, write=True)

        if prefix is None:
            alloc = await self._allocator.allocate(tr)
            prefix = self._content.key() + alloc
            rows = await tr.get_range(prefix, prefix + b"\xff", limit=1,
                                      snapshot=True)
            if rows:
                raise DirectoryError(
                    f"allocated prefix {prefix!r} is not empty")
            if not await self._is_prefix_free(tr, prefix):
                raise DirectoryError(
                    f"allocated prefix {prefix!r} is already in use")
        elif not await self._is_prefix_free(tr, prefix):
            raise DirectoryError(f"prefix {prefix!r} is already in use")

        # parent must exist (created recursively, layerless)
        if len(path) > 1:
            parent = await self._create_or_open(
                tr, path[:-1], b"", None, allow_create=True, allow_open=True)
            parent_node = self._node(
                parent.key() if not isinstance(parent, DirectoryPartition)
                else self._prefix_of_partition(parent))
        else:
            parent_node = self._root
        node = self._node(prefix)
        tr.set(parent_node.pack((_SUBDIRS, path[-1])), prefix)
        tr.set(node.pack((b"layer",)), layer)
        return self._contents(path, node, layer)

    @staticmethod
    def _prefix_of_partition(p: DirectoryPartition) -> bytes:
        return Subspace.key(p)      # bypass the raw-use guard internally

    async def exists(self, tr, path) -> bool:
        await self._check_version(tr, write=False)
        dl, sub = await self._route(tr, tuple(path))
        if dl is not self:
            return await dl.exists(tr, sub)
        node, _ = await self._find(tr, tuple(path))
        return node is not None

    async def list(self, tr, path=()) -> list:
        await self._check_version(tr, write=False)
        path = tuple(path)
        if path:
            dl, sub = await self._route(tr, path)
            if dl is not self:
                return await dl.list(tr, sub)
            node, layer = await self._find(tr, path)
            if node is None:
                raise DirectoryError(f"directory {path} does not exist")
            if layer == b"partition":
                return await self._contents(path, node, layer) \
                    ._effective_dl().list(tr, ())
        else:
            node = self._root
        rows = await tr.get_range(*node.range((_SUBDIRS,)), limit=0)
        return [node.unpack(bytes(k))[1] for k, _ in rows]

    async def move(self, tr, old_path, new_path):
        await self._check_version(tr, write=True)
        old_path, new_path = tuple(old_path), tuple(new_path)
        if new_path[:len(old_path)] == old_path:
            raise DirectoryError("cannot move a directory into itself")
        dl_old, sub_old = await self._route(tr, old_path)
        dl_new, sub_new = await self._route(tr, new_path)
        if dl_old._nodes.key() != dl_new._nodes.key():
            raise DirectoryError(
                "cannot move between directory partitions")
        if dl_old is not self:
            return await dl_old.move(tr, sub_old, sub_new)
        old_node, layer = await self._find(tr, old_path)
        if old_node is None:
            raise DirectoryError(f"directory {old_path} does not exist")
        if await self.exists(tr, new_path):
            raise DirectoryError(f"directory {new_path} already exists")
        if len(new_path) > 1:
            parent_node, _ = await self._find(tr, new_path[:-1])
        else:
            parent_node = self._root
        if parent_node is None:
            raise DirectoryError(
                f"new parent {new_path[:-1]} does not exist")
        prefix = self._prefix_of(old_node)
        tr.set(parent_node.pack((_SUBDIRS, new_path[-1])), prefix)
        await self._remove_from_parent(tr, old_path)
        return self._contents(new_path, old_node, layer)

    async def _remove_from_parent(self, tr, path: tuple) -> None:
        if len(path) > 1:
            parent, _ = await self._find(tr, path[:-1])
        else:
            parent = self._root
        tr.clear(parent.pack((_SUBDIRS, path[-1])))

    async def remove(self, tr, path) -> bool:
        """Remove the directory, its contents, and its whole subtree."""
        await self._check_version(tr, write=True)
        path = tuple(path)
        if not path:
            raise DirectoryError("the root directory cannot be removed")
        dl, sub = await self._route(tr, path)
        if dl is not self:
            return await dl.remove(tr, sub)
        node, _ = await self._find(tr, path)
        if node is None:
            return False
        await self._remove_recursive(tr, node)
        await self._remove_from_parent(tr, path)
        return True

    async def _remove_recursive(self, tr, node: Subspace) -> None:
        rows = await tr.get_range(*node.range((_SUBDIRS,)), limit=0)
        for _k, child_prefix in rows:
            await self._remove_recursive(tr, self._node(bytes(child_prefix)))
        prefix = self._prefix_of(node)
        tr.clear_range(prefix, prefix + b"\xff")        # content
        tr.clear_range(*node.range())                   # node metadata
        tr.clear(node.key())
