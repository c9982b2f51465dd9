"""TorchConflictSet (the port, on the CPU) vs JaxConflictSet and the twins.

The cases of tests/test_conflict_jax.py re-run against the port: verdicts
AND ring state (hb/he mapped back to u32, hver, floor) bit-identical to
the JAX reference on the same seeded inputs.
"""

import numpy as np
import pytest
import torch

from foundationdb_tpu.ops.batch import TxnRequest, encode_batch
from foundationdb_tpu.ops.conflict_jax import JaxConflictSet, _eb_is_point
from foundationdb_tpu.ops.conflict_np import NumpyConflictSet
from foundationdb_tpu.ops.oracle import OracleConflictSet
from foundationdb_tpu.runtime import DeterministicRandom
from foundationdb_tpu_torch.ops import batch as tbatch
from foundationdb_tpu_torch.ops.conflict_torch import (TorchConflictSet,
                                                        state_to_numpy)

W = 16
B, R = 8, 4
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel worker processes: one CPU thread each
    for torch's ops keeps these tests from starving their neighbours."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rand_key(rng, maxlen, alphabet=3):
    n = rng.random_int(1, maxlen + 1)
    return bytes(rng.random_int(0, alphabet) for _ in range(n))


def rand_range(rng, maxlen):
    a, b = rand_key(rng, maxlen), rand_key(rng, maxlen)
    if a == b:
        b = a + b"\x00"
    return (min(a, b), max(a, b))


def rand_txn(rng, snap_lo, snap_hi, maxlen):
    return TxnRequest(
        read_ranges=[rand_range(rng, maxlen)
                     for _ in range(rng.random_int(0, R + 1))],
        write_ranges=[rand_range(rng, maxlen)
                      for _ in range(rng.random_int(0, R + 1))],
        read_snapshot=rng.random_int(snap_lo, snap_hi),
    )


def port_batch(txns):
    """The same txns through the port's own encoder (its own copy)."""
    return tbatch.encode_batch(
        [tbatch.TxnRequest(t.read_ranges, t.write_ranges, t.read_snapshot)
         for t in txns], B, R, W)


def assert_same_state(kern: JaxConflictSet, port: TorchConflictSet, msg=""):
    hb, he, hver, floor = state_to_numpy(port.state)
    np.testing.assert_array_equal(np.asarray(kern.state.hb), hb, err_msg=msg)
    np.testing.assert_array_equal(np.asarray(kern.state.he), he, err_msg=msg)
    np.testing.assert_array_equal(np.asarray(kern.state.hver), hver,
                                  err_msg=msg)
    assert int(kern.state.floor) == floor, msg


@pytest.mark.parametrize("ring_inplace", [False, True])
@pytest.mark.parametrize("seed,maxlen", [(0, W), (1, W), (2, 3 * W),
                                         (3, 3 * W)])
def test_torch_jax_bit_parity(seed, maxlen, ring_inplace):
    """Verdicts AND ring state identical every batch, with ring wrap and
    set_oldest_version churn; the port's encoder gives the same lanes."""
    rng = DeterministicRandom(seed)
    capacity = B * R * 2
    kern = JaxConflictSet(capacity, W)
    port = TorchConflictSet(capacity, W, device=CPU,
                            ring_inplace=ring_inplace)
    version = 100
    for step in range(40):
        nt = rng.random_int(1, B + 1)
        txns = [rand_txn(rng, max(0, version - 50), version + 1, maxlen)
                for _ in range(nt)]
        version += rng.random_int(1, 20)
        eb, peb = encode_batch(txns, B, R, W), port_batch(txns)
        for f in ("read_begin", "read_end", "write_begin", "write_end",
                  "read_snapshot"):
            np.testing.assert_array_equal(getattr(eb, f), getattr(peb, f))
        kv = kern.resolve_encoded(eb, version)
        pv = port.resolve_encoded(peb, version)
        np.testing.assert_array_equal(kv, pv, err_msg=f"step {step}")
        assert_same_state(kern, port, f"step {step}")
        if rng.coinflip(0.2):
            oldest = version - rng.random_int(10, 60)
            kern.set_oldest_version(oldest)
            port.set_oldest_version(oldest)
            assert kern.oldest_version == port.oldest_version


def test_torch_oracle_parity_short_keys():
    """Against ground truth directly (keys <= W: the encoding is exact)."""
    rng = DeterministicRandom(77)
    port = TorchConflictSet(4096, W, device=CPU)
    oracle = OracleConflictSet()
    version = 100
    for _ in range(25):
        nt = rng.random_int(1, B + 1)
        txns = [rand_txn(rng, max(0, version - 50), version + 1, W)
                for _ in range(nt)]
        version += rng.random_int(1, 20)
        pv = port.resolve_encoded(port_batch(txns), version)[:nt].tolist()
        assert pv == oracle.resolve_batch(txns, version)


@pytest.mark.parametrize("seed,window", [(10, 8), (11, 32), (12, 64)])
def test_windowed_fast_path_parity(seed, window):
    """The window fast path with the device-predicated full-ring fallback
    against the JAX lax.cond and the full-scan numpy twin."""
    rng = DeterministicRandom(seed)
    capacity = B * R * 4
    twin = NumpyConflictSet(capacity, W)
    kern = JaxConflictSet(capacity, W, window=window)
    port = TorchConflictSet(capacity, W, device=CPU, window=window)
    version = 100
    for step in range(30):
        nt = rng.random_int(1, B + 1)
        lo = 0 if rng.coinflip(0.3) else max(0, version - 30)
        txns = [rand_txn(rng, lo, version + 1, W) for _ in range(nt)]
        version += rng.random_int(1, 20)
        eb = encode_batch(txns, B, R, W)
        tv = twin.resolve_encoded(eb, version)
        kv = kern.resolve_encoded(eb, version)
        pv = port.resolve_encoded(eb, version)
        np.testing.assert_array_equal(tv, pv, err_msg=f"step {step}")
        np.testing.assert_array_equal(kv, pv, err_msg=f"step {step}")
        assert_same_state(kern, port, f"step {step}")
    assert port.window == window


def _groups(rng, sizes, version, lo_lag=50, old=0.0):
    out = []
    for k in sizes:
        ebs, cvs = [], []
        for _ in range(k):
            nt = rng.random_int(1, B + 1)
            lo = 0 if rng.coinflip(old) else max(0, version - lo_lag)
            txns = [rand_txn(rng, lo, version + 1, W) for _ in range(nt)]
            version += rng.random_int(1, 20)
            ebs.append(encode_batch(txns, B, R, W))
            cvs.append(version)
        out.append((ebs, cvs))
    return out


@pytest.mark.parametrize("pack", [False, True])
def test_group_submit_matches_serial_and_jax(pack):
    """resolve_group_submit (hot/cold staging, bucket padding) vs serial
    submission in the port and vs the JAX group dispatch."""
    rng = DeterministicRandom(21)
    capacity = B * R * 64
    window = B * R * 4
    serial = TorchConflictSet(capacity, W, device=CPU, window=window)
    grouped = TorchConflictSet(capacity, W, device=CPU, window=window,
                               pack_verdicts=pack)
    kern = JaxConflictSet(capacity, W, window=window, pack_verdicts=pack)
    for round_, (ebs, cvs) in enumerate(
            _groups(rng, [1, 2, 4, 3, 5, 6, 8], 100)):
        sv = [serial.resolve_encoded(eb, cv) for eb, cv in zip(ebs, cvs)]
        gv = np.asarray(grouped.resolve_group_submit(ebs, cvs))
        kv = np.asarray(kern.resolve_group_submit(ebs, cvs))
        np.testing.assert_array_equal(kv, gv, err_msg=f"round {round_}")
        for i in range(len(ebs)):
            np.testing.assert_array_equal(sv[i], gv[i],
                                          err_msg=f"round {round_} batch {i}")
        assert_same_state(kern, grouped, f"round {round_}")
        for a, b in zip(state_to_numpy(serial.state),
                        state_to_numpy(grouped.state)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ring_inplace", [False, True])
def test_group_that_wraps_the_ring(ring_inplace):
    """Groups whose appends evict the whole ring: each batch must see the
    too-old floor the chained path gives it (the per-batch floors of
    resolve_many_core), so TOO_OLD verdicts match the serial chain and
    the JAX group dispatch bit for bit."""
    rng = DeterministicRandom(5)
    capacity = B * R * 8
    window = B * R * 2
    serial = TorchConflictSet(capacity, W, device=CPU, window=window)
    grouped = TorchConflictSet(capacity, W, device=CPU, window=window,
                               ring_inplace=ring_inplace)
    kern = JaxConflictSet(capacity, W, window=window)
    told = 0
    for round_, (ebs, cvs) in enumerate(
            _groups(rng, [8, 8, 3, 8, 5, 8, 8], 100, lo_lag=150, old=0.3)):
        sv = [serial.resolve_encoded(eb, cv) for eb, cv in zip(ebs, cvs)]
        gv = np.asarray(grouped.resolve_group_submit(ebs, cvs))
        kv = np.asarray(kern.resolve_group_submit(ebs, cvs))
        np.testing.assert_array_equal(kv, gv, err_msg=f"round {round_}")
        for i in range(len(ebs)):
            np.testing.assert_array_equal(sv[i], gv[i],
                                          err_msg=f"round {round_} batch {i}")
        told += int((gv == 2).sum())
        assert_same_state(kern, grouped, f"round {round_}")
    assert told > 0                     # eviction really raised floors


def test_point_equality_kernel_parity():
    """All-point groups over an all-point ring take the equality rule;
    verdicts stay bit-identical to the numpy twin's interval path and to
    the JAX set, including keys at the truncation boundary."""
    rng = DeterministicRandom(31)
    capacity = B * R * 16
    twin = NumpyConflictSet(capacity, W)
    kern = JaxConflictSet(capacity, W, window=B * R * 4)
    port = TorchConflictSet(capacity, W, device=CPU, window=B * R * 4)

    def point(k):
        return (k, k + b"\x00")

    pool = [b"p%02d" % i for i in range(10)]
    pool += [b"x" * W, b"x" * W + b"tail", b"x" * W + b"liat",
             b"x" * (W - 1), b"y" * (W + 4)]
    version = 100
    for step in range(30):
        nt = rng.random_int(1, B + 1)
        txns = []
        for _ in range(nt):
            reads = [point(pool[rng.random_int(0, len(pool))])
                     for _ in range(rng.random_int(0, R + 1))]
            writes = [point(pool[rng.random_int(0, len(pool))])
                      for _ in range(rng.random_int(0, R + 1))]
            txns.append(TxnRequest(reads, writes,
                                   rng.random_int(max(0, version - 50),
                                                  version + 1)))
        version += rng.random_int(1, 20)
        eb = encode_batch(txns, B, R, W)
        assert _eb_is_point(eb, W)
        tv = twin.resolve_encoded(eb, version)
        kv = kern.resolve_encoded(eb, version)
        pv = port.resolve_encoded(eb, version)
        np.testing.assert_array_equal(tv, pv, err_msg=f"step {step}")
        np.testing.assert_array_equal(kv, pv, err_msg=f"step {step}")
        np.testing.assert_array_equal(twin.hver, state_to_numpy(port.state)[2])
    assert port._ring_all_point     # the equality rule actually engaged


def test_range_dispatch_clears_point_ring_flag():
    port = TorchConflictSet(B * R * 8, W, device=CPU)
    pt = encode_batch([TxnRequest([(b"a", b"a\x00")], [(b"a", b"a\x00")],
                                  90)], B, R, W)
    port.resolve_encoded(pt, 100)
    assert port._ring_all_point
    rg = encode_batch([TxnRequest([(b"a", b"c")], [(b"a", b"c")], 105)],
                      B, R, W)
    assert int(port.resolve_encoded(rg, 110)[0]) == 0   # committed
    assert not port._ring_all_point
    # still correct afterwards (interval path resumes)
    v = port.resolve_encoded(encode_batch(
        [TxnRequest([(b"b", b"b\x00")], [], 105)], B, R, W), 120)
    assert int(v[0]) == 1       # read b at snap 105 vs range write at 110
    port.reset_ring(0)
    assert port._ring_all_point


def test_packed_verdicts_decode_equals_raw():
    """The bitmask readback decodes to the raw [K, B] verdicts; a clean
    group syncs only the summary word."""
    rng = DeterministicRandom(41)
    raw = TorchConflictSet(B * R * 32, W, device=CPU, window=B * R * 4)
    packed = TorchConflictSet(B * R * 32, W, device=CPU, window=B * R * 4,
                              pack_verdicts=True)
    for ebs, cvs in _groups(rng, [3, 8, 2, 5], 100, old=0.2):
        a = np.asarray(raw.resolve_group_submit(ebs, cvs))
        h = packed.resolve_group_submit(ebs, cvs)
        np.testing.assert_array_equal(a, np.asarray(h))
        K = a.shape[0]
        nw = (B + 31) // 32
        want = 4 * ((K + 31) // 32) + (4 * 2 * K * nw if a.any() else 0)
        assert h.synced_bytes == want
    clean = encode_batch([TxnRequest([(b"q", b"q\x00")], [], 5000)], B, R, W)
    h = packed.resolve_group_submit([clean], [5001])
    assert not np.asarray(h).any() and h.synced_bytes == 4


def test_jax_state_carried_into_port():
    """A JAX ring carried mid-run into the port (numpy only in between):
    both sets then resolve further batches identically."""
    rng = DeterministicRandom(55)
    capacity = B * R * 8
    window = B * R * 2
    kern = JaxConflictSet(capacity, W, window=window)
    groups = _groups(rng, [3, 5, 8, 2, 6, 8, 4], 100, lo_lag=120, old=0.2)
    for ebs, cvs in groups[:3]:
        kern.resolve_group_submit(ebs, cvs)
    port = TorchConflictSet(capacity, W, device=CPU, window=window)
    port.load_state(np.asarray(kern.state.hb), np.asarray(kern.state.he),
                    np.asarray(kern.state.hver), int(kern.state.floor))
    assert_same_state(kern, port, "carried")
    for round_, (ebs, cvs) in enumerate(groups[3:]):
        kv = np.asarray(kern.resolve_group_submit(ebs, cvs))
        pv = np.asarray(port.resolve_group_submit(ebs, cvs))
        np.testing.assert_array_equal(kv, pv, err_msg=f"round {round_}")
        assert_same_state(kern, port, f"round {round_}")


def test_default_device_is_the_card(monkeypatch):
    """No device means CUDA; without a card that raises instead of
    quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchConflictSet(64, W)
    assert TorchConflictSet(64, W, device=CPU).device == CPU
