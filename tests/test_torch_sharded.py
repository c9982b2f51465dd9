"""The port's multi-resolver step against the JAX package's.

``foundationdb_tpu_torch.parallel.sharded`` keeps S key-range partitions
as the leading dimension of the state on one device; the reference runs
``make_sharded_resolve_step`` under shard_map on conftest's 8-device CPU
mesh.  The same seeded streams (those of tests/test_sharded.py: every
txn inside one partition, and wide ranges that span partitions) go
through both at S ∈ {1, 2, 8}, without and with a window, and through a
small ring that wraps and evicts so TOO_OLD appears.  After every batch
the verdicts and every partition's hb/he/hver/floor must be
bit-identical (tolerance 0).  The port runs on ``torch.device("cpu")``,
where the kernels' plain versions answer; a ``cuda``-marked twin holds
the card against the CPU.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from foundationdb_tpu.ops.batch import TxnRequest, encode_batch
from foundationdb_tpu.parallel import sharded as ref
from foundationdb_tpu.runtime import DeterministicRandom
from foundationdb_tpu_torch.parallel import sharded as port

CPU = torch.device("cpu")
W = 16
B, R = 8, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def contained_stream(seed: int, n: int):
    """tests/test_sharded.py's partition-contained stream: each txn's
    ranges come from one of 8 per-partition key pools."""
    rng = DeterministicRandom(seed)
    pools = [[bytes([32 * p + off]) * 3 for off in range(4)]
             for p in range(8)]

    def rand_txn(version):
        pool = rng.choice(pools)

        def rr():
            k = rng.choice(pool)
            return (k, k + b"\x01")
        return TxnRequest([rr() for _ in range(rng.random_int(0, R))],
                          [rr() for _ in range(rng.random_int(0, R))],
                          rng.random_int(max(0, version - 40), version + 1))

    version = 100
    for _ in range(n):
        nt = rng.random_int(1, B + 1)
        txns = [rand_txn(version) for _ in range(nt)]
        version += rng.random_int(1, 15)
        yield encode_batch(txns, B, R, W), version


def cross_stream(seed: int, n: int):
    """tests/test_sharded.py's cross-partition stream: wide ranges over
    two-byte keys that often span several partitions."""
    rng = DeterministicRandom(seed)

    def wide():
        a = bytes([rng.random_int(0, 256), rng.random_int(0, 256)])
        b = bytes([rng.random_int(0, 256), rng.random_int(0, 256)])
        lo, hi = min(a, b), max(a, b)
        return (lo, hi + b"\x01")

    version = 100
    for _ in range(n):
        nt = rng.random_int(1, B + 1)
        txns = [TxnRequest([wide() for _ in range(rng.random_int(0, R))],
                           [wide() for _ in range(rng.random_int(0, R))],
                           rng.random_int(max(0, version - 40), version + 1))
                for _ in range(nt)]
        version += rng.random_int(1, 15)
        yield encode_batch(txns, B, R, W), version


def run_both(S: int, stream, capacity: int, window: int,
             device=CPU) -> np.ndarray:
    """Both steps over the stream, state and verdicts compared after
    every batch; returns every verdict."""
    mesh = Mesh(np.array(jax.devices()[:S]), ("resolvers",))
    rstep = ref.make_sharded_resolve_step(mesh, W, window)
    rst = ref.init_sharded_state(mesh, capacity, W)
    pstep = port.make_sharded_resolve_step(S, W, window, device=device)
    pst = port.init_sharded_state(S, capacity, W, device=device)
    out = []
    for i, (eb, version) in enumerate(stream):
        args = (eb.read_begin, eb.read_end, eb.write_begin, eb.write_end,
                eb.read_snapshot)
        rst, rv = rstep(rst, *args, np.int64(version))
        pst, pv = pstep(pst, *args, version)
        rv = np.asarray(rv)
        np.testing.assert_array_equal(pv.cpu().numpy(), rv,
                                      err_msg=f"verdicts, batch {i}")
        got = port.sharded_state_to_numpy(pst)
        for name, a, b in zip(ref.ShardedConflictState._fields, got, rst):
            np.testing.assert_array_equal(a, np.asarray(b),
                                          err_msg=f"{name}, batch {i}")
        out.append(rv)
    return np.concatenate(out)


@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("S", [1, 2, 8])
def test_contained_stream_matches_reference(S, window):
    v = run_both(S, contained_stream(9, 25), 4096, window)
    assert set(v.tolist()) >= {0, 1}


@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("S", [1, 2, 8])
def test_cross_partition_stream_matches_reference(S, window):
    # phantom writes included: a txn one partition aborts keeps its
    # writes in the others, in both packages alike
    v = run_both(S, cross_stream(10, 15), B * R * 64, window)
    assert 1 in v


@pytest.mark.parametrize("S", [1, 2, 8])
def test_small_ring_wraps_and_evicts(S):
    """A ring of two slabs: eviction raises each partition's floor and
    old snapshots come back TOO_OLD."""
    v = run_both(S, contained_stream(12, 30), 2 * B * R, 16)
    assert 2 in v


@pytest.mark.parametrize("S", [1, 8])
def test_padding_batches_leave_the_rings(S):
    """A commit version below 0 marks a padding batch: its verdicts are
    computed and every partition's ring stays as it was."""
    stream = ((eb, -1 if i % 3 == 2 else v)
              for i, (eb, v) in enumerate(contained_stream(13, 18)))
    v = run_both(S, stream, 4096, 64)
    assert 1 in v


def test_partition_boundaries_match_reference():
    for S in (1, 2, 3, 8):
        np.testing.assert_array_equal(port.make_partition_boundaries(S, W),
                                      ref.make_partition_boundaries(S, W))
    split = [b"apple", b"m", b"m\x00\xff" * 8]
    np.testing.assert_array_equal(
        port.make_partition_boundaries(4, W, split),
        ref.make_partition_boundaries(4, W, split))
    with pytest.raises(ValueError):
        port.make_partition_boundaries(4, W, split[:2])
    st = port.init_sharded_state(4, 64, W, split_keys=split, device=CPU)
    got = port.sharded_state_to_numpy(st)
    bounds = ref.make_partition_boundaries(4, W, split)
    np.testing.assert_array_equal(got[4], bounds[:-1])
    np.testing.assert_array_equal(got[5], bounds[1:])


def test_state_carries_into_the_port_and_back():
    """A reference state gathered to numpy, carried into the port and
    stepped there, equals the reference stepped on."""
    S = 2
    mesh = Mesh(np.array(jax.devices()[:S]), ("resolvers",))
    rstep = ref.make_sharded_resolve_step(mesh, W)
    rst = ref.init_sharded_state(mesh, 256, W)
    batches = list(contained_stream(4, 8))
    for eb, version in batches[:4]:
        rst, _ = rstep(rst, eb.read_begin, eb.read_end, eb.write_begin,
                       eb.write_end, eb.read_snapshot, np.int64(version))
    pst = port.sharded_state_from_numpy(*[np.asarray(x) for x in rst],
                                        device=CPU)
    pstep = port.make_sharded_resolve_step(S, W, device=CPU)
    for eb, version in batches[4:]:
        args = (eb.read_begin, eb.read_end, eb.write_begin, eb.write_end,
                eb.read_snapshot)
        rst, rv = rstep(rst, *args, np.int64(version))
        pst, pv = pstep(pst, *args, version)
        np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
    for a, b in zip(port.sharded_state_to_numpy(pst), rst):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_dryrun_stream_matches_one_resolver():
    """__graft_entry__.dryrun_multichip's partition-contained generator at
    S = 8: the port's verdicts equal the port's exact C++ conflict set run
    as one resolver."""
    from foundationdb_tpu_torch.ops.batch import TxnRequest as PTxn
    from foundationdb_tpu_torch.ops.batch import encode_batch as penc
    from foundationdb_tpu_torch.ops.conflict_cpp import CppConflictSet
    S, Bd, Rd = 8, 8, 2
    step = port.make_sharded_resolve_step(S, W, device=CPU)
    st = port.init_sharded_state(S, Bd * Rd * 16, W, device=CPU)
    cpp = CppConflictSet()
    g = np.random.default_rng(7)
    version = 1000
    seen = set()
    for _ in range(12):
        txns = []
        for _ in range(Bd):
            part = int(g.integers(0, S))
            lo = bytes([(256 * part) // S, int(g.integers(0, 5))])
            txns.append(PTxn([(lo, lo + b"\x01")], [(lo, lo + b"\x01")],
                             version - int(g.integers(0, 160))))
        version += 100 + int(g.integers(0, 50))
        eb = penc(txns, Bd, Rd, W)
        st, v = step(st, eb.read_begin, eb.read_end, eb.write_begin,
                     eb.write_end, eb.read_snapshot, version)
        want = cpp.resolve(txns, version)
        assert v.tolist() == list(want)
        seen |= set(want)
    assert seen >= {0, 1}


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.make_sharded_resolve_step(2, W)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.init_sharded_state(2, 64, W)


@pytest.mark.cuda
def test_sharded_step_on_card_matches_cpu():
    """The card (K3 and K1 per partition) against the CPU plain path,
    verdicts and rings, with launches counted: 2 a partition a batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from foundationdb_tpu_torch.ops import kernels as K
    dev = torch.device("cuda")
    for S, window in ((2, 0), (8, 64)):
        steps = [port.make_sharded_resolve_step(S, W, window, device=d)
                 for d in (dev, CPU)]
        sts = [port.init_sharded_state(S, 2 * B * R, W, device=d)
               for d in (dev, CPU)]
        K.reset_launches()
        n = 0
        for eb, version in cross_stream(10, 15):
            args = (eb.read_begin, eb.read_end, eb.write_begin,
                    eb.write_end, eb.read_snapshot, version)
            out = [steps[i](sts[i], *args) for i in range(2)]
            sts = [o[0] for o in out]
            assert out[0][1].cpu().tolist() == out[1][1].tolist()
            n += 1
        for a, b in zip(*(port.sharded_state_to_numpy(s) for s in sts)):
            np.testing.assert_array_equal(a, b)
        assert K.KERNELS["hist_check"].launches == S * n
        assert K.KERNELS["commit_chain"].launches == S * n
