"""ConflictRange workload — OCC verdict correctness under contention.

Reference: REF:fdbserver/workloads/ConflictRange.actor.cpp — hammer a
tiny keyspace with range reads + writes and prove the resolver's
verdicts are CORRECT, not merely convergent:

- **no false commits** (the serializability half): a transaction that
  committed with a strict range read must not have any OTHER committed
  write inside its read range between its read version and its commit
  version.  Every write also appends to a per-key versionstamped log
  subspace in the same transaction, so the exact global write history is
  reconstructible after quiescence and the check is exhaustive;
- **snapshot reads take no read conflicts**: snapshot-read transactions
  whose writes are disjoint by construction must never abort with
  not_committed.
"""

from __future__ import annotations

from ..core.data import MutationType
from ..runtime.errors import FdbError, NotCommitted
from .workload import TestWorkload, register_workload

KEYS = b"cr/"          # the contended keyspace: cr/00 .. cr/NN
LOG = b"crlog/"        # crlog/<key>/<versionstamp> -> commit marker


def _key(i: int) -> bytes:
    return KEYS + b"%02d" % i


@register_workload
class ConflictRangeWorkload(TestWorkload):
    name = "ConflictRange"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.n_keys = int(self.opt("nodeCount", 8))
        self.ops = int(self.opt("opsPerClient", 25))
        # pooled across clients (the options dict is shared per spec, and
        # only client 0 runs check): (read_version, commit_version,
        # begin_idx, end_idx) per strict-read commit
        self.shared = ctx.options.setdefault(
            "_pool", {"reads": [], "snapshot_aborts": 0})
        self.commits = 0
        self.conflicts = 0

    async def setup(self) -> None:
        if self.ctx.client_id != 0:
            return

        async def init(tr):
            for i in range(self.n_keys):
                tr.set(_key(i), b"0")
        await self.db.run(init)

    async def start(self) -> None:
        for op in range(self.ops):
            b = int(self.rng.random_int(0, self.n_keys))
            e = b + 1 + int(self.rng.random_int(0, self.n_keys - b))
            wk = int(self.rng.random_int(0, self.n_keys))
            snapshot_only = self.rng.coinflip(0.3)
            tr = self.db.create_transaction()
            while True:
                try:
                    rv = await tr.get_read_version()
                    await tr.get_range(_key(b), _key(e),
                                       snapshot=snapshot_only)
                    # the write: bump the key and append to its history
                    # log in the SAME transaction (versionstamped key =
                    # exact commit version, unique order suffix)
                    tr.set(_key(wk), b"%d-%d" % (self.ctx.client_id, op))
                    stamp_key = (LOG + _key(wk) + b"/"
                                 + b"\x00" * 10
                                 + len(LOG + _key(wk) + b"/").to_bytes(
                                     4, "little"))
                    tr.atomic_op(MutationType.SET_VERSIONSTAMPED_KEY,
                                 stamp_key, b"1")
                    if snapshot_only:
                        # disjoint write-conflict space per client makes
                        # a not_committed abort provably a FALSE read
                        # conflict — snapshot reads must not create any
                        tr.add_write_conflict_range(
                            b"wcr/%d" % self.ctx.client_id,
                            b"wcr/%d\x00" % self.ctx.client_id)
                    cv = await tr.commit()
                    self.commits += 1
                    if not snapshot_only:
                        self.shared["reads"].append((rv, cv, b, e))
                    break
                except NotCommitted as err:
                    if snapshot_only:
                        # a snapshot-only txn has no read conflict ranges
                        # at all (writes never abort their own txn), so
                        # ANY not_committed on it is a false conflict
                        self.shared["snapshot_aborts"] += 1
                    self.conflicts += 1
                    await tr.on_error(err)
                except FdbError as err:
                    await tr.on_error(err)

    async def check(self) -> bool:
        if self.ctx.client_id != 0:
            return True
        aborts = self.shared["snapshot_aborts"]
        assert aborts == 0, (
            f"{aborts} snapshot-read txns aborted with not_committed — "
            f"snapshot reads must take no read conflicts")
        # reconstruct the exact write history per key from the log
        history: dict[bytes, list[int]] = {}
        tr = self.db.create_transaction()
        while True:
            try:
                rows = await tr.get_range(LOG, LOG + b"\xff", limit=0,
                                          snapshot=True)
                break
            except FdbError as e:
                await tr.on_error(e)
        for k, _v in rows:
            body = bytes(k)[len(LOG):]
            # layout: <key> b"/" <10-byte versionstamp> — the stamp may
            # itself contain 0x2f, so split positionally, not by rsplit
            key, stamp = body[:-11], body[-10:]
            version = int.from_bytes(stamp[:8], "big")
            history.setdefault(key, []).append(version)
        for vs in history.values():
            vs.sort()
        # no false commits: no committed write to a strictly-read key in
        # (read_version, commit_version)
        import bisect
        for rv, cv, b, e in self.shared["reads"]:
            for i in range(b, e):
                vs = history.get(_key(i), [])
                lo = bisect.bisect_right(vs, rv)
                assert lo >= len(vs) or vs[lo] >= cv, (
                    f"FALSE COMMIT: read [{b},{e}) at rv={rv} committed "
                    f"at cv={cv}, but {_key(i)} was written at {vs[lo]}")
        return True

    def metrics(self):
        return {"commits": self.commits, "conflicts": self.conflicts}
