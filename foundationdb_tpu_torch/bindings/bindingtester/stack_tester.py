"""The bindingtester stack machine — the cross-implementation spec test.

Reference: REF:bindings/bindingtester/spec/bindingApiTester.md — every
FDB binding implements one stack-machine interpreter over its client
API; the tester runs the same instruction stream through two
implementations and diffs the resulting stacks and database contents
byte for byte.  Here the two implementations are the native async client
(foundationdb_tpu_torch.client) and a brute-force model — plus the
ctypes C-ABI binding (``bindings/python/fdbtpu.py`` in this package) for
the subset it exposes.

Instruction names follow the upstream spec (PUSH, SUB, GET, GET_RANGE,
ATOMIC_OP, TUPLE_PACK, ...); arguments travel on the data stack exactly
as specified, and errors push the packed ("ERROR", code) tuple.
"""

from __future__ import annotations

import random
from typing import Any

from foundationdb_tpu_torch.client import tuple as fdbtuple
from foundationdb_tpu_torch.core.data import MutationType, apply_atomic
from foundationdb_tpu_torch.runtime.errors import FdbError

RESULT_NOT_PRESENT = b"RESULT_NOT_PRESENT"

ATOMIC_NAMES = {
    "ADD": MutationType.ADD,
    "BIT_AND": MutationType.BIT_AND,
    "BIT_OR": MutationType.BIT_OR,
    "BIT_XOR": MutationType.BIT_XOR,
    "APPEND_IF_FITS": MutationType.APPEND_IF_FITS,
    "MAX": MutationType.MAX,
    "MIN": MutationType.MIN,
    "BYTE_MIN": MutationType.BYTE_MIN,
    "BYTE_MAX": MutationType.BYTE_MAX,
    "COMPARE_AND_CLEAR": MutationType.COMPARE_AND_CLEAR,
}


class StackMachine:
    """One interpreter over a Database-like async client.

    Directory ops (DIRECTORY_*) follow the upstream directory tester: a
    directory list holds opened DirectorySubspaces; DIRECTORY_CHANGE
    selects the active one.  Both implementations get a DirectoryLayer
    seeded with the SAME allocator RNG, so prefix allocation — and hence
    the raw database bytes — must match exactly."""

    def __init__(self, db, dir_seed: int | None = None) -> None:
        self.db = db
        self.dirs: list = []
        self.dir_idx = 0
        if dir_seed is not None:
            from foundationdb_tpu_torch.client.directory import DirectoryLayer
            from foundationdb_tpu_torch.runtime.rng import DeterministicRandom
            self.dirs = [DirectoryLayer(rng=DeterministicRandom(dir_seed))]
        self.stack: list[Any] = []
        self.tr = db.create_transaction()

    # --- stack helpers ---

    def push(self, item: Any) -> None:
        self.stack.append(item)

    def pop(self, n: int = 1):
        if n == 1:
            return self.stack.pop()
        out = [self.stack.pop() for _ in range(n)]
        return out

    # --- the interpreter ---

    async def run(self, program: list[tuple]) -> None:
        for inst in program:
            await self.step(*inst)

    async def step(self, op: str, *args) -> None:
        try:
            await self._dispatch(op, *args)
        except FdbError as e:
            # spec behavior: failed operations push the packed error
            self.push(fdbtuple.pack((b"ERROR", str(e.code).encode())))

    async def _dispatch(self, op: str, *args) -> None:
        if op == "PUSH":
            self.push(args[0])
        elif op == "DUP":
            self.push(self.stack[-1])
        elif op == "EMPTY_STACK":
            self.stack.clear()
        elif op == "SWAP":
            i = self.pop()
            d = len(self.stack) - 1
            self.stack[d], self.stack[d - i] = \
                self.stack[d - i], self.stack[d]
        elif op == "POP":
            self.pop()
        elif op == "SUB":
            a, b = self.pop(2)
            self.push(a - b)
        elif op == "CONCAT":
            a, b = self.pop(2)
            self.push(a + b)
        elif op == "NEW_TRANSACTION":
            self.tr = self.db.create_transaction()
        elif op == "GET":
            v = await self.tr.get(self.pop())
            self.push(v if v is not None else RESULT_NOT_PRESENT)
        elif op == "GET_RANGE":
            begin, end, limit, reverse = self.pop(4)
            rows = await self.tr.get_range(begin, end, limit=limit,
                                           reverse=bool(reverse))
            flat: list[Any] = []
            for k, v in rows:
                flat.append(bytes(k))
                flat.append(bytes(v))
            self.push(fdbtuple.pack(flat))
        elif op == "GET_READ_VERSION":
            await self.tr.get_read_version()
            self.push(b"GOT_READ_VERSION")
        elif op == "SET":
            key, value = self.pop(2)
            self.tr.set(key, value)
        elif op == "CLEAR":
            self.tr.clear(self.pop())
        elif op == "CLEAR_RANGE":
            begin, end = self.pop(2)
            self.tr.clear_range(begin, end)
        elif op == "ATOMIC_OP":
            name, key, value = self.pop(3)
            self.tr.atomic_op(ATOMIC_NAMES[name], key, value)
        elif op == "COMMIT":
            await self.tr.commit()
            self.push(RESULT_NOT_PRESENT)
            self.tr = self.db.create_transaction()
        elif op == "RESET":
            self.tr.reset()
        elif op == "TUPLE_PACK":
            n = self.pop()
            items = [self.pop() for _ in range(n)]
            self.push(fdbtuple.pack(list(reversed(items))))
        elif op == "TUPLE_UNPACK":
            for item in fdbtuple.unpack(self.pop()):
                self.push(fdbtuple.pack((item,)))
        elif op == "TUPLE_RANGE":
            n = self.pop()
            items = [self.pop() for _ in range(n)]
            b, e = fdbtuple.range_of(list(reversed(items)))
            self.push(b)
            self.push(e)
        elif op.startswith("DIRECTORY_"):
            await self._dispatch_directory(op)
        else:
            raise ValueError(f"unknown stack op {op!r}")

    def _cur_dir(self):
        return self.dirs[self.dir_idx]

    async def _dispatch_directory(self, op: str) -> None:
        from foundationdb_tpu_torch.client.directory import DirectoryError
        try:
            if op == "DIRECTORY_CREATE_OR_OPEN":
                path, layer = self.pop(2)
                d = await self._cur_dir().create_or_open(
                    self.tr, fdbtuple.unpack(path), layer)
                self.dirs.append(d)
                self.push(len(self.dirs) - 1)
            elif op == "DIRECTORY_OPEN":
                path, layer = self.pop(2)
                d = await self._cur_dir().open(self.tr,
                                               fdbtuple.unpack(path), layer)
                self.dirs.append(d)
                self.push(len(self.dirs) - 1)
            elif op == "DIRECTORY_CREATE":
                path, layer = self.pop(2)
                d = await self._cur_dir().create(self.tr,
                                                 fdbtuple.unpack(path), layer)
                self.dirs.append(d)
                self.push(len(self.dirs) - 1)
            elif op == "DIRECTORY_CHANGE":
                i = self.pop()
                self.dir_idx = i if 0 <= i < len(self.dirs) else 0
            elif op == "DIRECTORY_EXISTS":
                path = self.pop()
                ok = await self._cur_dir().exists(self.tr,
                                                  fdbtuple.unpack(path))
                self.push(1 if ok else 0)
            elif op == "DIRECTORY_LIST":
                path = self.pop()
                names = await self._cur_dir().list(self.tr,
                                                   fdbtuple.unpack(path))
                self.push(fdbtuple.pack([str(n) for n in names]))
            elif op == "DIRECTORY_MOVE":
                old, new = self.pop(2)
                d = await self._cur_dir().move(self.tr, fdbtuple.unpack(old),
                                               fdbtuple.unpack(new))
                self.dirs.append(d)
                self.push(len(self.dirs) - 1)
            elif op == "DIRECTORY_REMOVE":
                path = self.pop()
                ok = await self._cur_dir().remove(self.tr,
                                                  fdbtuple.unpack(path))
                self.push(1 if ok else 0)
            elif op == "DIRECTORY_PACK_KEY":
                t = self.pop()
                d = self._cur_dir()
                if not hasattr(d, "pack"):
                    raise DirectoryError("cannot pack through the layer")
                self.push(d.pack(fdbtuple.unpack(t)))
            elif op == "DIRECTORY_SET":
                t, value = self.pop(2)
                d = self._cur_dir()
                if not hasattr(d, "pack"):
                    raise DirectoryError("cannot set through the layer")
                self.tr.set(d.pack(fdbtuple.unpack(t)), value)
            else:
                raise ValueError(f"unknown directory op {op!r}")
        except DirectoryError:
            self.push(fdbtuple.pack((b"DIRECTORY_ERROR",)))


class ModelTransaction:
    """Brute-force transaction over a dict — the oracle half."""

    def __init__(self, model: "ModelDatabase") -> None:
        self.model = model
        self._writes: list[tuple] = []

    def reset(self) -> None:
        self._writes.clear()

    def _view(self) -> dict[bytes, bytes]:
        data = dict(self.model.data)
        for w in self._writes:
            self._apply(data, w)
        return data

    @staticmethod
    def _apply(data: dict, w: tuple) -> None:
        kind = w[0]
        if kind == "set":
            data[w[1]] = w[2]
        elif kind == "clear":
            data.pop(w[1], None)
        elif kind == "clear_range":
            for k in [k for k in data if w[1] <= k < w[2]]:
                del data[k]
        elif kind == "atomic":
            new = apply_atomic(w[1], data.get(w[2]), w[3])
            if new is None:
                data.pop(w[2], None)
            else:
                data[w[2]] = new

    async def get(self, key: bytes, snapshot: bool = False):
        return self._view().get(key)

    async def get_range(self, begin, end, limit=0, reverse=False,
                        snapshot: bool = False):
        rows = sorted((k, v) for k, v in self._view().items()
                      if begin <= k < end)
        if reverse:
            rows.reverse()
        return rows[:limit] if limit else rows

    async def get_read_version(self) -> int:
        return self.model.version

    def set(self, key, value) -> None:
        self._writes.append(("set", key, value))

    def clear(self, key) -> None:
        self._writes.append(("clear", key))

    def clear_range(self, begin, end) -> None:
        self._writes.append(("clear_range", begin, end))

    def atomic_op(self, op, key, operand) -> None:
        self._writes.append(("atomic", op, key, operand))

    def add(self, key, operand) -> None:
        self.atomic_op(MutationType.ADD, key, operand)

    async def commit(self) -> int:
        for w in self._writes:
            self._apply(self.model.data, w)
        self._writes.clear()
        self.model.version += 1
        return self.model.version


class ModelDatabase:
    def __init__(self) -> None:
        self.data: dict[bytes, bytes] = {}
        self.version = 0

    def create_transaction(self) -> ModelTransaction:
        return ModelTransaction(self)


def generate_program(seed: int, n_ops: int = 300,
                     prefix: bytes = b"st/") -> list[tuple]:
    """A seeded, always-valid instruction stream over a key prefix —
    what the upstream tester's python generator produces, in miniature."""
    rng = random.Random(seed)
    prog: list[tuple] = [("NEW_TRANSACTION",)]
    depth = 0

    def key() -> bytes:
        return prefix + fdbtuple.pack((rng.randrange(40),))

    for _ in range(n_ops):
        choices = ["SET", "GET", "CLEAR", "CLEAR_RANGE", "ATOMIC_OP",
                   "GET_RANGE", "COMMIT", "TUPLE", "PUSHPOP"]
        op = rng.choice(choices)
        if op == "SET":
            prog += [("PUSH", b"v%04d" % rng.randrange(10_000)),
                     ("PUSH", key()), ("SET",)]
        elif op == "GET":
            prog += [("PUSH", key()), ("GET",)]
            depth += 1
        elif op == "CLEAR":
            prog += [("PUSH", key()), ("CLEAR",)]
        elif op == "CLEAR_RANGE":
            a, b = sorted((key(), key()))
            prog += [("PUSH", b), ("PUSH", a), ("CLEAR_RANGE",)]
        elif op == "ATOMIC_OP":
            name = rng.choice(sorted(ATOMIC_NAMES))
            operand = bytes([rng.randrange(256) for _ in range(8)])
            prog += [("PUSH", operand), ("PUSH", key()),
                     ("PUSH", name), ("ATOMIC_OP",)]
        elif op == "GET_RANGE":
            a, b = sorted((key(), key()))
            prog += [("PUSH", 0), ("PUSH", rng.randrange(0, 20)),
                     ("PUSH", b), ("PUSH", a), ("GET_RANGE",)]
            depth += 1
        elif op == "COMMIT":
            prog += [("COMMIT",)]
            depth += 1
        elif op == "TUPLE":
            items = [rng.randrange(-1000, 1000), b"x", "s", None,
                     rng.random()]
            rng.shuffle(items)
            k = rng.randrange(1, len(items) + 1)
            for x in items[:k]:
                prog.append(("PUSH", x))
            prog += [("PUSH", k), ("TUPLE_PACK",)]
            depth += 1
        elif op == "PUSHPOP" and depth > 1:
            prog.append(("SWAP",) if rng.random() < 0.3 else ("POP",))
            if prog[-1][0] == "SWAP":
                prog.insert(-1, ("PUSH", rng.randrange(min(depth, 3))))
            else:
                depth -= 1
    prog.append(("COMMIT",))
    return prog


def generate_directory_program(seed: int, n_ops: int = 60) -> list[tuple]:
    """A seeded directory-op stream (DIRECTORY_* spec subset).  Tracks
    the machine's directory-list length so CHANGE indices are always
    valid, and only packs/sets through real DirectorySubspaces (index
    > 0)."""
    rng = random.Random(seed)
    names = ["a", "b", "c", "d"]
    prog: list[tuple] = [("NEW_TRANSACTION",)]

    def path() -> bytes:
        return fdbtuple.pack([rng.choice(names)
                              for _ in range(rng.randrange(1, 3))])

    for _ in range(n_ops):
        op = rng.choice(["CREATE_OR_OPEN", "OPEN", "CREATE", "EXISTS",
                         "LIST", "MOVE", "REMOVE", "CHANGE", "PACK",
                         "SET", "COMMIT"])
        if op in ("CREATE_OR_OPEN", "OPEN", "CREATE"):
            layer = rng.choice([b"", b"", b"queue"])
            prog += [("PUSH", layer), ("PUSH", path()),
                     (f"DIRECTORY_{op}",)]
        elif op == "EXISTS":
            prog += [("PUSH", path()), ("DIRECTORY_EXISTS",)]
        elif op == "LIST":
            prog += [("PUSH", fdbtuple.pack(())), ("DIRECTORY_LIST",)]
        elif op == "MOVE":
            prog += [("PUSH", path()), ("PUSH", path()),
                     ("DIRECTORY_MOVE",)]
        elif op == "REMOVE":
            prog += [("PUSH", path()), ("DIRECTORY_REMOVE",)]
        elif op == "CHANGE":
            # invalid indices clamp to 0 (the layer) in the machine; the
            # same clamp happens in both implementations
            prog += [("PUSH", rng.randrange(0, 6)), ("DIRECTORY_CHANGE",)]
        elif op == "PACK":
            # on the layer (index 0) this pushes DIRECTORY_ERROR — in
            # both implementations identically
            prog += [("PUSH", fdbtuple.pack((rng.randrange(10),))),
                     ("DIRECTORY_PACK_KEY",)]
        elif op == "SET":
            prog += [("PUSH", b"v%03d" % rng.randrange(1000)),
                     ("PUSH", fdbtuple.pack((rng.randrange(10),))),
                     ("DIRECTORY_SET",)]
        elif op == "COMMIT":
            prog.append(("COMMIT",))
    prog.append(("COMMIT",))
    return prog
