"""Coordination — the generation register and leader election.

Reference: REF:fdbserver/Coordination.actor.cpp (GenerationReg /
coordinationServer) + REF:fdbserver/LeaderElection.actor.cpp — a small set
of coordinator processes store the cluster's most important few hundred
bytes (who leads, which TLog generation is live) behind a Paxos-flavored
generation register:

- ``read(gen)``: a reader first *registers* its read generation; the
  coordinator promises never to accept a write from any older generation,
  and returns the freshest (write_gen, value) it has accepted.
- ``write(gen, value)``: accepted iff ``gen`` is newer than both the
  largest read generation registered and the largest write generation
  accepted.

A client that completes both phases against a **majority** of
coordinators knows its value is the unique latest — the single-decree
Paxos core FDB uses for cluster state (CoordinatedState).  Leader
election rides the same machinery plus per-coordinator candidacy
tracking with virtual-time leases.

State is durable when a filesystem is provided (OnDemandStore analog):
a coordinator that reboots remembers its promises.
"""

from __future__ import annotations

import asyncio
import dataclasses
from typing import Any

from ..runtime.errors import FdbError, _err
from ..runtime.knobs import Knobs
from ..runtime.trace import TraceEvent

# 2910/2911: these used to claim 2903/2904, COLLIDING with the
# change-feed errors in runtime/errors.py — error_from_code resolved
# whichever registered last, so a feed stream's change_feed_not_
# registered surfaced client-side as not_latest_generation and escaped
# the cursor's handling (found by the hostile-disk farm at seed 4:
# io-error-induced stream failovers hit the mistyped path)
NotLatestGeneration = _err(2910, "not_latest_generation",
                           "A newer generation has been seen by this coordinator")
CoordinatorsUnreachable = _err(
    2911, "coordinators_unreachable",
    "No majority of coordinators reachable")


# generations order lexicographically: (counter, candidate_id)
Generation = tuple[int, int]
GEN_ZERO: Generation = (0, 0)


@dataclasses.dataclass
class LeaderInfo:
    leader_id: int
    address: Any            # NetworkAddress of the cluster controller
    lease_end: float        # virtual-time lease expiry (coordinator clock)


@dataclasses.dataclass
class Nomination:
    candidate_id: int
    address: Any
    expires: float          # nominations are soft: a dead candidate's
                            # entry lapses and the next-best takes over


class Coordinator:
    """One coordinator process (role "coordinator")."""

    def __init__(self, knobs: Knobs, fs=None, path: str | None = None) -> None:
        self.knobs = knobs
        self._fs = fs
        self._path = path
        self.max_read_gen: Generation = GEN_ZERO
        self.write_gen: Generation = GEN_ZERO
        self.value: Any = None
        self._leader: LeaderInfo | None = None
        self._nominations: dict[int, Nomination] = {}
        # set by change_coordinators (MovableCoordinatedState's forward
        # pointer): once retired, this coordinator refuses register and
        # election traffic and forwards callers to the new set
        self.moved_to: list | None = None

    # --- durability (OnDemandStore) ---

    @classmethod
    async def open(cls, knobs: Knobs, fs, path: str) -> "Coordinator":
        """Recover from the newest valid of two alternating crc-framed
        slots.  The state used to be truncate-rewritten in
        place, so a kill tearing the write (truncate persisted, data
        dropped) silently reset this coordinator to GEN_ZERO — a
        split-brain seed the hostile-disk sim surfaces immediately.  The
        un-written slot always holds the previous synced state; the
        legacy single file is still read for pre-slot disks."""
        from ..rpc.wire import SlottedBlob, decode, unframe
        co = cls(knobs, fs, path)
        co._slots = SlottedBlob(fs, path)
        best = None
        payload, slots_seen = await co._slots.load()
        found = slots_seen
        if payload is not None:
            best = decode(payload)
        if best is None:
            # pre-helper slot format: crc-framed dict with
            # its own embedded seq
            for suffix in (".a", ".b"):
                f = fs.open(path + suffix)
                data = await f.read(0, f.size())
                if not data:
                    continue
                try:
                    st = decode(unframe(data))
                except Exception:  # noqa: BLE001 — torn slot: other wins
                    continue
                if best is None or st.get("seq", 0) > best.get("seq", 0):
                    best = st
            if best is not None:
                # keep alternation continuous across the envelope
                # migration (never clobber the only valid slot)
                co._slots.seed(best.get("seq", 0))
        if best is None and slots_seen >= 2:
            # both slots populated yet neither decodes: a crash always
            # leaves the previously-synced slot intact (the write
            # alternates), so this is corruption of COMMITTED quorum
            # state — silently resetting to GEN_ZERO would let a stale
            # leader win a quorum it already lost (the split-brain seed
            # the dual slots exist to prevent)
            from ..runtime.errors import DiskCorrupt
            raise DiskCorrupt(
                f"both coordinator state slots of {path} are damaged — "
                f"refusing to silently reset the quorum state")
        if best is None:
            f = fs.open(path)
            data = await f.read(0, f.size())
            if data:
                found += 1
                try:
                    best = decode(data)
                except Exception:  # noqa: BLE001 — legacy torn write
                    pass
        if best is not None:
            co.max_read_gen = tuple(best["r"])
            co.write_gen = tuple(best["w"])
            co.value = best["v"]
            co.moved_to = best.get("m")
        elif found:
            TraceEvent("CoordStateCorrupt", severity=30).detail(
                "Path", path).detail("Slots", found).log()
        return co

    _slots = None
    _persist_lock = None

    async def _persist(self) -> None:
        if self._fs is None:
            return
        from ..rpc.wire import SlottedBlob, encode
        # serialized: concurrent RPC handlers must never have BOTH slots
        # dirty at once (a kill could then tear both, and the recovery
        # invariant "one synced slot always survives" would not hold),
        # nor write their seqs out of order.  The seq/slot-turn
        # discipline lives in the shared SlottedBlob.
        if self._persist_lock is None:
            import asyncio
            self._persist_lock = asyncio.Lock()
        async with self._persist_lock:
            if self._slots is None:
                self._slots = SlottedBlob(self._fs, self._path)
            await self._slots.save(encode({
                "r": list(self.max_read_gen),
                "w": list(self.write_gen),
                "v": self.value,
                "m": self.moved_to}))

    # --- quorum migration (MovableCoordinatedState,
    #     REF:fdbserver/Coordination.actor.cpp) ---

    def _check_moved(self) -> None:
        if self.moved_to is not None:
            from ..runtime.errors import CoordinatorsChanged
            raise CoordinatorsChanged()

    async def move(self, new_addrs: list) -> bool:
        """Retire this coordinator: record the forward pointer and refuse
        all register/election traffic from now on.  Idempotent.  Called
        by change_coordinators AFTER the cluster state has been copied to
        the new quorum — so a visible forward pointer always implies the
        new set is authoritative."""
        if self.moved_to is None:
            self.moved_to = [list(a) if isinstance(a, tuple) else a
                             for a in new_addrs]
            self._leader = None
            self._nominations.clear()
            await self._persist()
            TraceEvent("CoordinatorMoved").detail(
                "NewSet", str(self.moved_to)).log()
        return True

    async def get_forward(self) -> list | None:
        """Where did this quorum go?  None while still serving."""
        return self.moved_to

    # --- generation register (GenerationRegInterface) ---

    async def read(self, gen: list | Generation) -> tuple[Generation, Generation, Any]:
        """Register a read at ``gen``; promise excludes older writers.
        Returns (max_read_gen, write_gen, value)."""
        self._check_moved()
        gen = tuple(gen)
        if gen > self.max_read_gen:
            self.max_read_gen = gen
            await self._persist()
        return self.max_read_gen, self.write_gen, self.value

    async def write(self, gen: list | Generation, value: Any) -> Generation:
        """Accept iff gen is at least as new as every promise; returns the
        coordinator's max read generation (so a rejected writer learns
        what to beat)."""
        self._check_moved()
        gen = tuple(gen)
        if gen < self.max_read_gen or gen <= self.write_gen:
            raise NotLatestGeneration()
        self.write_gen = gen
        self.value = value
        await self._persist()
        return self.max_read_gen

    async def open_database(self) -> Any:
        """Read-only client entry (OpenDatabaseCoordRequest analog): hand
        back the latest accepted cluster state WITHOUT registering a read
        generation — clients must never invalidate writers.  After a
        quorum change, clients get the forward pointer instead."""
        if self.moved_to is not None:
            return {"__moved_to__": self.moved_to}
        return self.value

    # --- leader election (LeaderElectionRegInterface) ---
    #
    # Two-phase nominate/confirm (REF:fdbserver/LeaderElection.actor.cpp
    # CandidacyRequest -> LeaderHeartbeat): NOMINATE records a candidate
    # without granting anything; each coordinator independently converges
    # on a deterministic best nominee; CONFIRM grants the lease only when
    # the confirmer is still this coordinator's best nominee AND no other
    # leader holds an unexpired lease.  Grant-on-first-ask (the previous
    # single-phase candidacy) let a freshly-restarted coordinator hand
    # its slot to whichever bystander asked first — split grants and
    # leadership ping-pong under churn.  With two phases, two candidates
    # can never both assemble confirming majorities inside one lease:
    # the majorities intersect at a coordinator whose lease guard
    # rejects the second confirm.

    def _best_nominee(self, now: float) -> "Nomination | None":
        live = [n for n in self._nominations.values() if now < n.expires]
        if not live:
            return None
        return min(live, key=lambda n: n.candidate_id)

    async def nominate(self, candidate_id: int, address: Any) -> list:
        """Phase 1: record/refresh this candidacy; grants nothing.
        Returns [0, leader_id, addr] when an unexpired confirmed leader
        exists, else [1, best_nominee_id, addr]."""
        self._check_moved()
        now = asyncio.get_running_loop().time()
        self._nominations[candidate_id] = Nomination(
            candidate_id, address, now + self.knobs.NOMINATION_TIMEOUT)
        if self._leader is not None and now < self._leader.lease_end:
            return [0, self._leader.leader_id, self._leader.address]
        best = self._best_nominee(now)
        return [1, best.candidate_id, best.address]

    async def confirm(self, candidate_id: int, round_id: int = 0) -> bool:
        """Phase 2: grant the lease iff the caller is still this
        coordinator's best nominee and no OTHER unexpired leader exists.
        Idempotent for the incumbent (True without extending the lease —
        renewal is leader_heartbeat's job).  ``round_id`` fences the grant
        against stale withdraws (see withdraw)."""
        self._check_moved()
        now = asyncio.get_running_loop().time()
        if self._leader is not None and now < self._leader.lease_end:
            if self._leader.leader_id == candidate_id:
                # monotonic re-fence: a DELAYED confirm from an older
                # round must never lower the fence, or the matching stale
                # withdraw could revoke the newer win
                self._lease_round = max(
                    getattr(self, "_lease_round", 0), round_id)
                return True
            return False
        best = self._best_nominee(now)
        if best is None or best.candidate_id != candidate_id:
            return False
        self._leader = LeaderInfo(
            candidate_id, best.address,
            now + self.knobs.LEADER_LEASE_DURATION)
        self._lease_round = round_id
        TraceEvent("CoordLeaderChange").detail("Leader", candidate_id).log()
        return True

    async def withdraw(self, candidate_id: int, round_id: int = 0) -> bool:
        """Release a lease this candidate holds HERE (losing candidates
        call this after a failed confirm round).  A candidate that won
        confirm at only a minority otherwise parks those coordinators
        behind its unexpired lease for LEADER_LEASE_DURATION, stalling
        the next election wave.  Safe: the caller did not believe it was
        leader in ``round_id`` (it saw < majority), and the round fence
        rejects a withdraw delivered late (e.g. past a client timeout
        over TCP) after the SAME candidate legitimately won a LATER
        confirm round — without it, the stale withdraw would revoke the
        new lease and open a split-brain window."""
        if self._leader is not None \
                and self._leader.leader_id == candidate_id \
                and getattr(self, "_lease_round", 0) == round_id:
            self._leader = None
            TraceEvent("CoordLeaseWithdrawn") \
                .detail("Candidate", candidate_id).log()
            return True
        return False

    async def read_leader(self) -> tuple[int, Any] | None:
        """Read-only leader query (the reference's monitorLeader side):
        returns the CURRENT unexpired leader or None — never grants.
        Candidacy-on-read is what seeds leader ping-pong: a respawned
        (empty) coordinator would grant to the first caller while the
        quorum still honors the incumbent's lease."""
        self._check_moved()
        now = asyncio.get_running_loop().time()
        if self._leader is not None and now < self._leader.lease_end:
            return self._leader.leader_id, self._leader.address
        return None

    async def leader_heartbeat(self, candidate_id: int) -> bool:
        """Renew the lease; False tells a deposed leader to stand down."""
        self._check_moved()
        now = asyncio.get_running_loop().time()
        if self._leader is not None and self._leader.leader_id == candidate_id \
                and now < self._leader.lease_end:
            self._leader.lease_end = now + self.knobs.LEADER_LEASE_DURATION
            return True
        return False


class CoordinatedState:
    """Client view over a quorum of coordinators — CoordinatedState /
    MovableCoordinatedState in the reference: read-modify-write of the
    cluster state blob with single-decree safety."""

    def __init__(self, coordinators: list, my_id: int,
                 knobs: Knobs | None = None) -> None:
        self.coordinators = coordinators      # Coordinator objects or stubs
        self.my_id = my_id
        self.knobs = knobs
        self._gen_counter = 0
        self._read_gen: Generation | None = None

    @property
    def _majority(self) -> int:
        return len(self.coordinators) // 2 + 1

    async def _quorum(self, calls) -> list:
        """Run calls; return successful results, raising unless a
        majority succeeded.  Each call is individually bounded: a dead
        coordinator must cost at most the bound — derived from the knobs
        like elect_leader's — not stall the whole round (its vote just
        doesn't count)."""
        timeout = (self.knobs.FAILURE_TIMEOUT * 2
                   if self.knobs is not None else 4.0)

        async def bounded(c):
            return await asyncio.wait_for(c, timeout)

        results = await asyncio.gather(*(bounded(c) for c in calls),
                                       return_exceptions=True)
        ok = [r for r in results if not isinstance(r, BaseException)]
        if len(ok) < self._majority:
            real = [r for r in results if isinstance(r, FdbError)]
            if real and all(isinstance(r, NotLatestGeneration) for r in real):
                raise NotLatestGeneration()
            from ..runtime.errors import CoordinatorsChanged
            if any(isinstance(r, CoordinatorsChanged) for r in real):
                # a retired quorum: the caller must follow the forward
                # pointers (get_forward) to the new set
                raise CoordinatorsChanged()
            raise CoordinatorsUnreachable()
        return ok

    async def read(self, raw: bool = False) -> tuple[Generation, Any]:
        """Phase-1 read from a majority: registers a fresh read generation
        and returns (read_gen, freshest accepted value).  After this, no
        writer at an older generation can commit at any majority (the two
        majorities intersect at a coordinator holding our promise).

        If the freshest value is a quorum-change INTENT marker (written by
        change_coordinators phase 1), normal consumers get
        CoordinatorsChanged carrying the target set — the caller must
        complete or follow the move (ClusterHost does).  ``raw=True``
        (the mover itself) returns the marker."""
        self._gen_counter += 1
        gen = (self._gen_counter, self.my_id)
        replies = await self._quorum(
            [c.read(list(gen)) for c in self.coordinators])
        # learn the newest generation around so the next read beats it
        max_seen = max(r[0] for r in replies)
        self._gen_counter = max(self._gen_counter, max_seen[0])
        self._read_gen = gen
        best = max(replies, key=lambda r: r[1])    # freshest accepted write
        value = best[2]
        if not raw and isinstance(value, dict) and "__moving_to__" in value:
            from ..runtime.errors import CoordinatorsChanged
            e = CoordinatorsChanged()
            e.moving_to = value["__moving_to__"]
            e.inner_value = value.get("__value__")
            raise e
        return gen, value

    async def write(self, value: Any) -> None:
        """Phase-2 write at the generation of OUR read phase — never a
        fresher one, or a value committed after our read could be silently
        overwritten (the single-decree Paxos ballot discipline).  Raises
        NotLatestGeneration if a newer reader/writer got in; the caller
        must re-read (adopting the newer value) before retrying."""
        if self._read_gen is None:
            raise RuntimeError("write() before read()")
        gen, self._read_gen = self._read_gen, None
        await self._quorum([c.write(list(gen), value)
                            for c in self.coordinators])

    async def read_modify_write(self, update) -> Any:
        """Retry loop: read, apply ``update(old) -> new``, write."""
        while True:
            _, old = await self.read()
            new = update(old)
            try:
                await self.write(new)
                return new
            except NotLatestGeneration:
                await asyncio.sleep(0.05)


async def change_coordinators(old_coords: list, new_coords: list,
                              new_addrs: list, knobs: Knobs,
                              mover_id: int = 0) -> None:
    """Change the coordinator set — changeQuorum
    (REF:fdbclient/ManagementAPI.actor.cpp::changeQuorum over
    MovableCoordinatedState, REF:fdbserver/Coordination.actor.cpp).

    Three phases, each crash-safe:
      1. INTENT through the OLD quorum: the cluster-state value is
         replaced by a generation-fenced marker {__moving_to__, __value__}.
         Any concurrent writer (another mover, the CC) now conflicts; any
         reader learns the move and can complete it (ClusterHost does).
      2. COPY: the preserved value is written into the NEW quorum's
         registers.  A crash before phase 3 leaves the old quorum
         authoritative-but-marked; re-running is idempotent.
      3. RETIRE: every old coordinator records the forward pointer and
         refuses register/election traffic (majority required; the rest
         best-effort — a visible forward always implies phase 2 is done,
         so two quorums can never both accept writes: the old set's
         majority is fenced by the intent generation until retired, and
         retired coordinators serve only the forward).

    ``new_addrs`` are the wire-shaped addresses ([ip, port]) recorded in
    forward pointers and intent markers; ``new_coords`` the matching
    stubs (or Coordinator objects in-process)."""
    if len(new_coords) != len(new_addrs) or not new_coords:
        raise ValueError("new coordinator stubs/addresses mismatch")
    wire_addrs = [list(a) if isinstance(a, tuple) else
                  ([a.ip, a.port] if hasattr(a, "ip") else list(a))
                  for a in new_addrs]
    cs_old = CoordinatedState(old_coords, mover_id, knobs=knobs)
    while True:
        _gen, cur = await cs_old.read(raw=True)
        if isinstance(cur, dict) and "__moving_to__" in cur:
            # an interrupted move: preserve the ORIGINAL value; our
            # target set wins via the generation fence below
            cur = cur.get("__value__")
        try:
            await cs_old.write({"__moving_to__": wire_addrs,
                                "__value__": cur})
            break
        except NotLatestGeneration:
            # the CC wrote cstate between our read and write: adopt the
            # newer value and retry the intent (read_modify_write loop)
            await asyncio.sleep(0.05)
    await complete_coordinator_move(old_coords, new_coords, wire_addrs,
                                    cur, knobs, mover_id)
    TraceEvent("CoordinatorsChangedOK").detail(
        "NewSet", str(wire_addrs)).log()


async def complete_coordinator_move(old_coords: list, new_coords: list,
                                    wire_addrs: list, value: Any,
                                    knobs: Knobs, mover_id: int = 0) -> None:
    """Phases 2-3 of change_coordinators — also the completion path a
    ClusterHost runs when it finds an interrupted move's intent marker.

    Clobber guard: if ANY old coordinator already serves a forward
    pointer, phase 2 is known complete and a new-set CC may already be
    writing newer state there — the copy is skipped and only the
    retirement of the remaining old coordinators is finished.
    Concurrent completers that both pass the guard write the SAME
    preserved value (idempotent)."""
    timeout = (knobs.FAILURE_TIMEOUT * 2 if knobs is not None else 4.0)

    async def fwd(c):
        return await asyncio.wait_for(c.get_forward(), timeout)

    fwds = await asyncio.gather(*(fwd(c) for c in old_coords),
                                return_exceptions=True)
    already = any(f for f in fwds if f and not isinstance(f, BaseException))
    if not already:
        cs_new = CoordinatedState(new_coords, mover_id, knobs=knobs)
        try:
            await cs_new.read(raw=True)
            await cs_new.write(value)
        except NotLatestGeneration:
            pass    # a racing completer's identical copy won — fine

    async def retire(c):
        return await asyncio.wait_for(c.move(wire_addrs), timeout)

    # coordinators in BOTH sets keep serving (the common replace-one
    # operation); safety holds because any still-electable old majority
    # and any new majority intersect at a shared coordinator whose
    # single-lease guard serializes the two elections
    new_keys = {tuple(a) for a in wire_addrs}

    def shared(c) -> bool:
        if c in new_coords:
            return True
        a = getattr(c, "_address", None)
        return a is not None and (a.ip, a.port) in {(k[0], k[1])
                                                    for k in new_keys}

    retiring = [c for c in old_coords if not shared(c)]
    if retiring:
        acks = await asyncio.gather(*(retire(c) for c in retiring),
                                    return_exceptions=True)
        good = sum(1 for a in acks if a is True)
        if good < len(retiring) // 2 + 1:
            raise CoordinatorsUnreachable()


def _addr_key(a: Any):
    """Addresses decode from the wire as lists; normalize for hashing."""
    return tuple(a) if isinstance(a, list) else a


def _addr_restore(a: Any):
    return list(a) if isinstance(a, tuple) else a


async def elect_leader(coordinators: list, candidate_id: int, address: Any,
                       knobs: Knobs) -> tuple[int, Any]:
    """Find (or become) the leader — two-phase nominate/confirm.

    Phase 0 — read-only: if a MAJORITY already agrees on a live leader,
    follow it without nominating (a healthy incumbent is never disturbed
    by an election storm — nominations grant nothing, but skipping them
    keeps restarted-coordinator registers quiet).

    Phase 1 — nominate: record this candidacy at every coordinator and
    learn each one's deterministic best nominee (lowest live candidate
    id) or its confirmed leader.  A majority reporting the same
    confirmed leader ⇒ follow it.

    Phase 2 — confirm, only when a majority's best nominee is US: each
    coordinator re-checks its own nominee view and incumbent lease at
    grant time, so two candidates can never both assemble confirming
    majorities inside one lease.  A majority of True ⇒ we lead.

    Otherwise (someone else is the convergent nominee, or the confirm
    race was lost) back off with per-candidate deterministic jitter and
    retry until ELECTION_TIMEOUT, then raise CoordinatorsUnreachable so
    the caller's outer loop takes over.  Every per-coordinator RPC is
    bounded well under the lease duration: an unreachable coordinator
    must not delay a round past the winner's own lease."""
    from ..runtime.rng import DeterministicRandom

    k = knobs
    rpc_timeout = min(k.LEADER_LEASE_DURATION / 4, k.FAILURE_TIMEOUT)
    majority = len(coordinators) // 2 + 1
    loop = asyncio.get_running_loop()
    # jitter decorrelates candidates' retry rounds; seeding off the
    # candidate id keeps simulation replays exact
    rng = DeterministicRandom((candidate_id << 16) ^ 0x1eade1ec)
    deadline = loop.time() + k.ELECTION_TIMEOUT

    async def bounded(c):
        return await asyncio.wait_for(c, rpc_timeout)

    def top(tally: dict) -> tuple[tuple[int, Any], int] | None:
        if not tally:
            return None
        # deterministic: most votes, ties to the lowest candidate id
        return min(tally.items(), key=lambda kv: (-kv[1], kv[0][0]))

    async def poll_leader() -> tuple[int, Any] | None:
        """Read-only leader check: a MAJORITY agreeing on one unexpired
        leader ⇒ (id, addr), else None."""
        reads = await asyncio.gather(
            *(bounded(c.read_leader()) for c in coordinators),
            return_exceptions=True)
        tally: dict[tuple[int, Any], int] = {}
        for r in reads:
            if isinstance(r, BaseException) or r is None:
                continue
            key = (r[0], _addr_key(r[1]))
            tally[key] = tally.get(key, 0) + 1
        best = top(tally)
        if best is not None and best[1] >= majority:
            (lid, laddr), _ = best
            return lid, _addr_restore(laddr)
        return None

    # Liveness under asymmetric partitions: a candidate every coordinator
    # converges on (it can NOMINATE everywhere) whose CONFIRM path is
    # broken would otherwise keep refreshing its nominations forever and
    # park the election — rivals can never become best nominee.  After
    # two consecutive failed confirm rounds as the convergent nominee,
    # stand down: stop nominating long enough for our nominations to
    # lapse (NOMINATION_TIMEOUT) so rivals converge, while still polling
    # read-only for the leader they elect.
    failed_confirms = 0
    # Round fence for confirm/withdraw: a withdraw delivered late (past a
    # client timeout) must not revoke a lease won in a LATER round.
    # Seeded from the monotonic clock so rounds stay strictly increasing
    # ACROSS elect_leader invocations of the same candidate — a stale
    # withdraw from a previous invocation must not match a fresh win's
    # fence (the coordinator-side fence is monotonic too).
    round_id = int(loop.time() * 1e6)

    while True:
        # Phase 0: follow an already-confirmed live leader.
        led = await poll_leader()
        if led is not None:
            return led

        # Phase 1: nominate everywhere; tally leaders and nominees.
        noms = await asyncio.gather(
            *(bounded(c.nominate(candidate_id, address))
              for c in coordinators),
            return_exceptions=True)
        ok = [r for r in noms if not isinstance(r, BaseException)]
        if len(ok) < majority:
            from ..runtime.errors import CoordinatorsChanged
            if any(isinstance(r, CoordinatorsChanged) for r in noms):
                # a retired quorum: surface the typed error so the caller
                # follows the forward pointers instead of blind-retrying
                raise CoordinatorsChanged()
            raise CoordinatorsUnreachable()
        lead_tally: dict[tuple[int, Any], int] = {}
        nom_tally: dict[tuple[int, Any], int] = {}
        for kind, cid, a in ok:
            t = lead_tally if kind == 0 else nom_tally
            key = (cid, _addr_key(a))
            t[key] = t.get(key, 0) + 1
        bestl = top(lead_tally)
        if bestl is not None and bestl[1] >= majority:
            (lid, laddr), _ = bestl
            return lid, _addr_restore(laddr)

        # Phase 2: confirm only when the convergent nominee is us.
        bestn = top(nom_tally)
        if bestn is not None and bestn[1] >= majority \
                and bestn[0][0] == candidate_id:
            round_id += 1
            confs = await asyncio.gather(
                *(bounded(c.confirm(candidate_id, round_id))
                  for c in coordinators),
                return_exceptions=True)
            if sum(1 for r in confs if r is True) >= majority:
                return candidate_id, address
            failed_confirms += 1
            # Lost the round: release every lease this round may have
            # granted — including at coordinators whose True reply was
            # LOST (timeout), or they stay parked behind the unexpired
            # lease for LEADER_LEASE_DURATION.  Safe: we know we lost
            # round_id, and the fence stops a late-delivered withdraw
            # from revoking a lease we win in a later round.
            await asyncio.gather(
                *(bounded(c.withdraw(candidate_id, round_id))
                  for c in coordinators),
                return_exceptions=True)
            if failed_confirms >= 2:
                # our confirm path is broken while our nominate path works
                # (asymmetric partition): stand down so our nominations
                # lapse and rivals can converge; keep watching read-only
                # for whoever they elect
                failed_confirms = 0
                lapse_end = loop.time() + k.NOMINATION_TIMEOUT * 1.25
                while loop.time() < lapse_end:
                    await asyncio.sleep(k.ELECTION_BACKOFF)
                    led = await poll_leader()
                    if led is not None:
                        return led
                    if loop.time() >= deadline:
                        raise CoordinatorsUnreachable()
        else:
            failed_confirms = 0

        if loop.time() >= deadline:
            raise CoordinatorsUnreachable()
        await asyncio.sleep(k.ELECTION_BACKOFF * (0.5 + rng.random()))
