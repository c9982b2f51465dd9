"""The endpoint dictionary and the wire path: the port vs the JAX package.

The port's native key codec, ``DictEncoder``, ``_point_end``,
``resolve_many_ids`` / ``resolve_many_fused`` and the ``cuda`` backend's
dictionary and wire branches (on ``torch.device("cpu")``, where the
kernels' plain versions run) against the JAX package's (``tpu`` kind on
the CPU) on the same seeded inputs.  Everything here is integers, so the
tolerance is 0: verdicts, ring state and dictionary contents must be
bit-identical.
"""

import asyncio
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.ops import batch as rbatch
from foundationdb_tpu.ops import conflict_jax as rcj
from foundationdb_tpu.ops import keycode as rkc
from foundationdb_tpu.ops.backends import EncodedConflictBackend as RefBackend
from foundationdb_tpu.ops.backends import \
    make_conflict_backend as ref_make_backend
from foundationdb_tpu.ops.backends import resolve_group_begin as ref_group
from foundationdb_tpu.ops.backends import \
    resolve_group_wire_begin as ref_wire_group
from foundationdb_tpu.runtime import DeterministicRandom
from foundationdb_tpu.runtime import Knobs as RefKnobs
from foundationdb_tpu_torch.bench.profile_fused import ids_group_wire_begin
from foundationdb_tpu_torch.ops import batch as tbatch
from foundationdb_tpu_torch.ops import conflict_torch as tct
from foundationdb_tpu_torch.ops import keycode as tkc
from foundationdb_tpu_torch.ops.backends import EncodedConflictBackend
from foundationdb_tpu_torch.ops.backends import make_conflict_backend
from foundationdb_tpu_torch.ops.backends import resolve_group_begin
from foundationdb_tpu_torch.ops.backends import resolve_group_wire_begin
from foundationdb_tpu_torch.ops.conflict_cpp import CppConflictSet
from foundationdb_tpu_torch.runtime import Knobs as PortKnobs

tbuild = importlib.import_module("foundationdb_tpu_torch.native.build")
CPU = torch.device("cpu")
B, R, W = 8, 4, 16
L = W // 4 + 1
MIN_SLOTS = 8 * R * B * 64          # make_conflict_backend's minimum


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel worker processes: one CPU thread each
    for torch's ops keeps these tests from starving their neighbours."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPE = dict(CONFLICT_RING_CAPACITY=4096, KEY_ENCODE_BYTES=W,
             RESOLVER_BATCH_TXNS=B, RESOLVER_RANGES_PER_TXN=R)


def ref_backend(slots=MIN_SLOTS, **kw):
    return ref_make_backend(RefKnobs().override(
        RESOLVER_CONFLICT_BACKEND="tpu", CONFLICT_DICT_SLOTS=slots,
        **SHAPE, **kw))


def port_backend(slots=MIN_SLOTS, kind="cuda", **kw):
    return make_conflict_backend(PortKnobs().override(
        RESOLVER_CONFLICT_BACKEND=kind, CONFLICT_DICT_SLOTS=slots,
        **SHAPE, **kw), device=CPU)


def rand_txn(rng, version, nr, cls=tbatch.TxnRequest):
    def rr():
        a = bytes(rng.random_int(0, 3) for _ in range(rng.random_int(1, 12)))
        return (a, a + b"\x01")
    return cls([rr() for _ in range(rng.random_int(0, nr))],
               [rr() for _ in range(rng.random_int(0, nr))],
               rng.random_int(max(0, version - 40), version + 1))


def point_txn(rng, version, cls=tbatch.TxnRequest):
    """Point ranges over keys shorter than, equal to and longer than W."""
    def pr():
        a = bytes(rng.random_int(0, 4) for _ in range(rng.random_int(1, 24)))
        return (a, a + b"\x00")
    return cls([pr() for _ in range(rng.random_int(0, R))],
               [pr() for _ in range(rng.random_int(0, R))],
               rng.random_int(max(0, version - 40), version))


def groups(seed, n_groups, group, make=rand_txn, cls=tbatch.TxnRequest,
           version=1000):
    """[(batches, versions)] of random txn batches, both packages' txns
    built from one DeterministicRandom stream."""
    rng = DeterministicRandom(seed)
    out = []
    for _ in range(n_groups):
        batches, versions = [], []
        for _ in range(group):
            n = rng.random_int(1, B + 1)
            batches.append([make(rng, version, cls=cls) if make is point_txn
                            else make(rng, version, R, cls=cls)
                            for _ in range(n)])
            version += rng.random_int(1, 15)
            versions.append(version)
        out.append((batches, versions))
    return out


def drive(be, gs, begin):
    """Run every group through ``begin(be, batches, versions)``; flat
    verdicts."""
    flat = []

    async def go():
        for batches, versions in gs:
            for vs in await begin(be, batches, versions):
                flat.extend(vs)
    asyncio.run(go())
    return flat


def ring(cs):
    """A conflict set's ring as the reference's numpy tuple."""
    if isinstance(cs, tct.TorchConflictSet):
        return tct.state_to_numpy(cs.state)
    st = cs.state
    return (np.asarray(st.hb), np.asarray(st.he), np.asarray(st.hver),
            int(st.floor))


def assert_same_ring(a, b):
    for x, y, f in zip(ring(a), ring(b), ("hb", "he", "hver", "floor")):
        assert np.array_equal(x, y), f"ring field {f} diverged"


# --------------------------------------------------------------------------
# the codec


def _keys(g, n, width):
    lens = g.integers(0, width + 9, size=n)
    lens[:3] = (width - 1, width, width + 1)
    body = g.integers(0, 256, size=(n, width + 8)).astype(np.uint8)
    body[: n // 2] %= 3                 # shared prefixes, and NULs
    return [body[i, :lens[i]].tobytes() for i in range(n)]


@pytest.mark.parametrize("width", [16, 32])
def test_codec_matches_reference_and_plain(width):
    g = np.random.default_rng(width)
    keys = _keys(g, 500, width)
    got = tkc.encode_keys(keys, width)
    assert np.array_equal(got, rkc.encode_keys(keys, width))
    assert np.array_equal(got, tkc.encode_keys_plain(keys, width))
    assert tkc.encode_keys([], width).shape == (0, width // 4 + 1)
    # the whole-batch encoder: the padded lane arrays
    rng = DeterministicRandom(width)
    txns = [rand_txn(rng, 100, R) for _ in range(B - 1)] + \
        [tbatch.TxnRequest([(k, k + b"\x00") for k in keys[:R]],
                           [(keys[3], keys[4])], 7)]
    ref_txns = [rbatch.TxnRequest(t.read_ranges, t.write_ranges,
                                  t.read_snapshot) for t in txns]
    port = tbatch.encode_batch(txns, B + 2, R, width)
    plain = tbatch.encode_batch_plain(txns, B + 2, R, width)
    ref = rbatch.encode_batch(ref_txns, B + 2, R, width)
    for f in ("read_begin", "read_end", "write_begin", "write_end",
              "read_snapshot"):
        assert np.array_equal(getattr(port, f), getattr(ref, f)), f
        assert np.array_equal(getattr(port, f), getattr(plain, f)), f
    assert port.count == ref.count == plain.count == B


def test_codec_that_does_not_build_raises_with_the_compiler_message(
        monkeypatch, tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int f( {\n")
    monkeypatch.setitem(tbuild.TARGETS, "broken", [str(bad)])
    monkeypatch.setattr(tbuild, "BUILD_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="(?s)broken.cpp.*error"):
        tbuild.build("broken")
    assert not list(tmp_path.glob("*.so*"))


# --------------------------------------------------------------------------
# the encoder


def _wires(gs, pkg):
    return [[pkg.wire_from_txns(b) for b in batches] for batches, _ in gs]


def test_dict_encoder_matches_reference():
    """Both encoders fed the same wires in the same order from empty, at
    the backend's minimum dictionary size and a key space large enough
    that slots are evicted and reused: every output byte-identical."""
    rng = DeterministicRandom(5)
    max_upd = 4 * R * B * 4

    def txn(cls, version):
        def rr(point):
            a = b"%x" % rng.random_int(0, 1 << 40)
            return (a, a + b"\x00") if point else (a, a + b"\x01")
        point = rng.coinflip(0.5)
        return cls([rr(point) for _ in range(rng.random_int(0, R + 1))],
                   [rr(point) for _ in range(rng.random_int(0, R + 1))],
                   rng.random_int(0, version))

    port = tbatch.DictEncoder(MIN_SLOTS, W, max_upd)
    ref = rbatch.DictEncoder(MIN_SLOTS, W, max_upd)
    lib_p, lib_r = port._lib, ref._lib
    total = 0
    for gi in range(280):
        k = 1 + gi % 4
        K = next(b for b in rcj.GROUP_BUCKETS if b >= k)
        batches = [[txn(tbatch.TxnRequest, 10_000 + gi)
                    for _ in range(rng.random_int(1, B + 1))]
                   for _ in range(k)]
        pw = [tbatch.wire_from_txns(b) for b in batches]
        rw = [rbatch.WireBatch(w.blob, w.offs, w.nr, w.nw, w.snapshots,
                               w.count) for w in pw]
        vers = [10_000 + 10 * gi + i for i in range(k)]
        if gi % 3 == 0:
            a = port.encode_group_wire(pw, B, R, K)
            b = ref.encode_group_wire(rw, B, R, K)
            for x, y in zip(a, b):
                assert np.array_equal(x, y)
        elif gi % 3 == 1:
            a = port.encode_group_fused(pw, B, R, K, vers)
            b = ref.encode_group_fused(rw, B, R, K, vers)
            assert np.array_equal(a[1], b[1]) and a[2:] == b[2:]
            U = next(u for u in rcj.FUSED_UPD_BUCKETS if u >= a[4])
            ta = port.pack_updates_into(a[0], a[3], K, B, U)
            tb = ref.pack_updates_into(b[0], b[3], K, B, U)
            assert ta == tb
            assert np.array_equal(a[0][:ta], b[0][:tb])
        else:
            port.begin_group()
            ref.begin_group()
            for bt in batches:
                a = port.encode(bt, B, R)
                b = ref.encode([rbatch.TxnRequest(t.read_ranges,
                                                  t.write_ranges,
                                                  t.read_snapshot)
                                for t in bt], B, R)
                for f in ("read_begin", "read_end", "write_begin",
                          "write_end", "read_snapshot"):
                    assert np.array_equal(getattr(a, f), getattr(b, f))
        assert port.n_upd == ref.n_upd
        assert np.array_equal(port.upd_slots, ref.upd_slots)
        assert np.array_equal(port.upd_lanes, ref.upd_lanes)
        assert lib_p.kc_dict_live(port._h) == lib_r.kc_dict_live(ref._h)
        total += port.n_upd
    assert total > MIN_SLOTS            # slots were evicted and reused


def test_group_encoders_reject_wires_past_the_shape():
    """The native walks write batch k at k*B*R: a wire of more than B
    txns, more than R ranges, or more wires than the group raise before
    any pointer reaches native code."""
    d = tbatch.DictEncoder(MIN_SLOTS, W, 4 * R * B * 4)
    one = tbatch.TxnRequest([(b"a", b"a\x00")], [], 1)
    fat = tbatch.wire_from_txns([tbatch.TxnRequest(
        [(b"a", b"b")] * (R + 1), [], 1)])
    cases = [[tbatch.wire_from_txns([one] * (B + 1))],      # > B txns
             [fat],                                          # > R ranges
             [tbatch.wire_from_txns([one])] * 3]             # > k_pad
    for wires in cases:
        with pytest.raises(ValueError):
            d.encode_group_wire(wires, B, R, 2)
        with pytest.raises(ValueError):
            d.encode_group_fused(wires, B, R, 2, [5] * len(wires))


def test_staging_ring_hands_out_buffers_in_turn():
    ring_ = tct.StagingRing(n=3)
    bufs = [ring_.take(10) for _ in range(4)]
    assert bufs[0].ctypes.data == bufs[3].ctypes.data
    assert len({b.ctypes.data for b in bufs[:3]}) == 3
    bufs[0][:] = np.arange(10, dtype=np.uint32) + 0xFFFFFFF0
    up = ring_.upload(bufs[0][:6], CPU)
    bufs[0][:] = 0                       # the upload holds its own copy
    assert up.dtype == torch.int32
    assert np.array_equal(up.numpy().view(np.uint32),
                          np.arange(6, dtype=np.uint32) + 0xFFFFFFF0)


# --------------------------------------------------------------------------
# the device functions


def test_point_end_matches_reference():
    g = np.random.default_rng(3)
    x = g.integers(0, 1 << 32, size=(5, 7, L), dtype=np.uint64) \
        .astype(np.uint32)
    x[..., -1] = g.integers(0, W + 2, size=(5, 7))
    x[0, :3] = 0xFFFFFFFF               # sentinel rows
    x[1, :2, -1] = 0xFFFFFFFF
    want = np.asarray(rcj._point_end(jnp.asarray(x), W))
    got = tct._point_end(torch.from_numpy(tct.map_lanes(x)), W)
    assert np.array_equal(tct.unmap_lanes(got.numpy()), want)


def _carried(seed, make, n_groups=3):
    """A reference dictionary backend after a few groups, its carried
    ring and dictionary, and a next group encoded by its own encoder."""
    ref = ref_backend()
    gs = groups(seed, n_groups + 1, 3, make, cls=rbatch.TxnRequest)
    drive(ref, gs[:n_groups], ref_group)
    cs = ref.cs
    st = (np.asarray(cs.state.hb), np.asarray(cs.state.he),
          np.asarray(cs.state.hver), int(cs.state.floor))
    return ref, st, np.asarray(cs._dct), gs[n_groups]


def _port_set(st, dct, window):
    cs = tct.TorchConflictSet(4096, W, device=CPU, window=window,
                              dict_slots=MIN_SLOTS)
    cs.load_state(*st)
    cs.load_dict(dct)
    return cs


def _compare(ref_out, port_state, port_dct, port_verdicts):
    rst, rdct, rv = ref_out
    assert np.array_equal(np.asarray(rv), port_verdicts.numpy())
    for x, y in zip((rst.hb, rst.he, rst.hver),
                    tct.state_to_numpy(port_state)[:3]):
        assert np.array_equal(np.asarray(x), y)
    assert int(rst.floor) == int(port_state.floor)
    assert np.array_equal(np.asarray(rdct), tct.dict_to_numpy(port_dct))


@pytest.mark.parametrize("compact", [False, True])
def test_resolve_many_ids_matches_reference(compact):
    make = point_txn if compact else rand_txn
    ref, st, dct, (batches, versions) = _carried(11 + compact, make)
    window = ref.cs.window
    K = 4
    enc = ref._dict.encode_group(batches, B, R, K)
    ids, snaps, _, got_compact = enc
    assert got_compact == compact
    d = ref._dict
    U = next(u for u in rcj.UPD_BUCKETS if u >= d.n_upd)
    assert d.n_upd > 0
    points = compact                # the carried ring holds points only
    pi64 = np.full(K * B + K, -1, np.int64)
    pi64[:K * B] = snaps.reshape(-1)
    pi64[K * B:K * B + len(versions)] = versions
    ref_out = rcj.resolve_many_ids(
        rcj.ConflictState(*map(jnp.asarray, st[:3]), jnp.int64(st[3])),
        jnp.asarray(dct), jnp.asarray(ids), jnp.asarray(d.upd_slots[:U]),
        jnp.asarray(d.upd_lanes[:, :U]), jnp.asarray(pi64),
        shape=(K, B, R, L), width=W, window=window, compact=compact,
        points=points)
    cs = _port_set(st, dct, window)
    cs._ensure_state(B, R)

    def t32(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
    cvs = list(versions) + [-1] * (K - len(versions))
    state, pdct, verdicts = tct.resolve_many_ids(
        cs.state, cs._dct, t32(ids), t32(d.upd_slots[:U]),
        t32(d.upd_lanes[:, :U]), torch.from_numpy(snaps.reshape(-1)), cvs,
        shape=(K, B, R, L), width=W, window=cs.window, compact=compact,
        points=points)
    _compare(ref_out, state, pdct, verdicts)


@pytest.mark.parametrize("warm", [False, True])
def test_resolve_many_fused_matches_reference(warm):
    """``warm``: the group's endpoints are all resident, U = 0 (no
    scatter); else U > 0 with padding updates to slot 0."""
    ref, st, dct, (batches, versions) = _carried(21, rand_txn)
    d = ref._dict
    wires = [rbatch.wire_from_txns(b) for b in batches]
    K = 4
    if warm:
        # make the group's endpoints resident first, so U = 0 below
        d.encode_group_wire(wires, B, R, K)
        ref.cs.apply_dict_updates(d.upd_slots, d.upd_lanes, d.n_upd)
        dct = np.asarray(ref.cs._dct)
    fused, counts, compact, off_pi, n_upd = d.encode_group_fused(
        wires, B, R, K, versions)
    U = next(u for u in rcj.FUSED_UPD_BUCKETS if u >= n_upd)
    assert (U == 0) == warm and U >= n_upd
    total = d.pack_updates_into(fused, off_pi, K, B, U)
    buf = np.array(fused[:total], copy=True)
    window = ref.cs.window
    ref_out = rcj.resolve_many_fused(
        rcj.ConflictState(*map(jnp.asarray, st[:3]), jnp.int64(st[3])),
        jnp.asarray(dct), jnp.asarray(buf), shape=(K, B, R, L), width=W,
        window=window, compact=compact, U=U)
    cs = _port_set(st, dct, window)
    cs._ensure_state(B, R)
    cvs = list(versions) + [-1] * (K - len(versions))
    state, pdct, verdicts = tct.resolve_many_fused(
        cs.state, cs._dct, torch.from_numpy(buf.view(np.int32)), cvs,
        shape=(K, B, R, L), width=W, window=cs.window, compact=compact,
        U=U)
    _compare(ref_out, state, pdct, verdicts)
    # slot 0 stays the sentinel after the padded scatter
    assert (tct.dict_to_numpy(pdct)[:, 0] == 0xFFFFFFFF).all()


def test_per_batch_id_groups_match_reference():
    """``DictEncoder.encode`` batch by batch into one group, then
    ``resolve_group_submit_dict``: the legacy per-IdBatch dispatch gives
    the reference's verdicts, ring and dictionary."""
    port = tct.TorchConflictSet(4096, W, device=CPU, window=256,
                                dict_slots=MIN_SLOTS)
    ref = rcj.JaxConflictSet(4096, W, window=256, dict_slots=MIN_SLOTS)
    pd = tbatch.DictEncoder(MIN_SLOTS, W, 4 * R * B * 8)
    rd = rbatch.DictEncoder(MIN_SLOTS, W, 4 * R * B * 8)
    for (batches, versions), (rbs, _) in zip(
            groups(6, 5, 3), groups(6, 5, 3, cls=rbatch.TxnRequest)):
        pd.begin_group()
        rd.begin_group()
        pib = [pd.encode(b, B, R) for b in batches]
        rib = [rd.encode(b, B, R) for b in rbs]
        a = port.resolve_group_submit_dict(pib, versions, pd.upd_slots,
                                           pd.upd_lanes, pd.n_upd)
        b = ref.resolve_group_submit_dict(rib, versions, rd.upd_slots,
                                          rd.upd_lanes, rd.n_upd)
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert_same_ring(port, ref)
    assert np.array_equal(port.dict_to_numpy(), np.asarray(ref._dct))


def test_fused_submit_checks_the_versions_against_the_buffer():
    be = port_backend()
    gs = groups(4, 1, 3)
    wires = [tbatch.wire_from_txns(b) for b in gs[0][0]]
    versions = gs[0][1]
    d = be._dict
    fused, _, compact, off_pi, _ = d.encode_group_fused(
        wires, B, R, 4, versions)
    total = d.pack_updates_into(fused, off_pi, 4, B, 0)
    with pytest.raises(ValueError, match="commit versions"):
        be.cs.resolve_group_submit_fused(fused[:total], (4, B, R), compact,
                                         0, [v + 1 for v in versions])
    host = fused[off_pi + 2 * 4 * B:off_pi + 2 * (4 * B + 4)].view(np.int64)
    assert list(host) == versions + [-1]
    v = be.cs.resolve_group_submit_fused(fused[:total], (4, B, R), compact,
                                         0, versions)
    assert np.asarray(v).shape == (4, B)


# --------------------------------------------------------------------------
# the backend (ported from tests/test_backends.py)


def test_dict_compressed_group_path_matches_lanes_path():
    """The dictionary path (device lane dictionary + u32 ids) gives the
    lanes path's verdicts, the numpy twin's, and the reference dictionary
    path's — verdicts, ring and dictionary — across slot reuse."""
    gs = groups(77, 12, 6)
    rgs = groups(77, 12, 6, cls=rbatch.TxnRequest)
    dct = port_backend()
    assert dct._dict is not None, "dictionary path not active"
    lanes = port_backend(slots=0)
    assert lanes._dict is None
    r_dict = drive(dct, gs, resolve_group_begin)
    assert dct.dict_dispatches == len(gs) and dct.dict_fallbacks == 0
    assert r_dict == drive(lanes, gs, resolve_group_begin)
    assert r_dict == drive(port_backend(kind="numpy"), gs,
                           resolve_group_begin)
    ref = ref_backend()
    assert r_dict == drive(ref, rgs, ref_group)
    assert_same_ring(dct.cs, ref.cs)
    assert np.array_equal(dct.cs.dict_to_numpy(), np.asarray(ref.cs._dct))


def test_dict_path_ring_state_matches_lanes_path():
    gs = groups(5, 6, 6)
    lanes, dct = port_backend(slots=0), port_backend()
    drive(lanes, gs, resolve_group_begin)
    drive(dct, gs, resolve_group_begin)
    assert_same_ring(lanes.cs, dct.cs)


def test_wire_path_matches_object_path_both_backends():
    """The serialized WireBatch form resolves bit-identically to the
    TxnRequest form on the C++ set, on the fused and the multi-upload
    ids wire paths, and on the reference's wire path (whose dictionary
    the port's must equal)."""
    gs = groups(31, 6, 5, version=500)
    wgs = [(_w, v) for _w, (_, v) in zip(_wires(gs, tbatch), gs)]
    rgs = [([rbatch.WireBatch(w.blob, w.offs, w.nr, w.nw, w.snapshots,
                              w.count) for w in ws], v) for ws, v in wgs]
    cpp_obj = []
    cpp = CppConflictSet()
    for batches, versions in gs:
        for b, v in zip(batches, versions):
            cpp_obj.extend(cpp.resolve(b, v))
    cpp_wire = drive(port_backend(kind="cpp"), wgs, resolve_group_wire_begin)
    fused = port_backend()
    ids = port_backend()
    got_fused = drive(fused, wgs, resolve_group_wire_begin)
    got_ids = drive(ids, wgs, ids_group_wire_begin)
    ref = ref_backend()
    got_ref = drive(ref, rgs, ref_wire_group)
    assert cpp_obj == cpp_wire, "cpp wire layout diverged from object path"
    assert cpp_obj == got_fused == got_ids == got_ref
    assert fused.dict_dispatches == ids.dict_dispatches == len(gs)
    for be in (fused, ids):
        assert_same_ring(be.cs, ref.cs)
        assert np.array_equal(be.cs.dict_to_numpy(), np.asarray(ref.cs._dct))


def test_point_compressed_wire_groups_match_cpp():
    """All-point groups take the compact path (begin ids only; end rows
    derived on the device) and the equality rule, bit-identical to the
    C++ set across the encode-width boundary."""
    gs = groups(3, 8, 5, point_txn, version=900)
    wgs = [(w, v) for w, (_, v) in zip(_wires(gs, tbatch), gs)]
    cpp = drive(port_backend(kind="cpp"), wgs, resolve_group_wire_begin)
    for begin in (resolve_group_wire_begin, ids_group_wire_begin):
        be = port_backend()
        got = drive(be, wgs, begin)
        assert got == cpp and len(cpp) > 50
        # every group was compact: the ring's all-point flag survives
        # only compact dispatches
        assert be.cs._ring_all_point
    enc = be._dict.encode_group_wire(
        [tbatch.wire_from_txns([tbatch.TxnRequest([(b"k", b"k\x00")], [],
                                                  900)])], B, R, 1)
    assert enc[-1] is True, "compact detection failed on a point range"


# --------------------------------------------------------------------------
# edge cases


def _overflow_backends(max_upd):
    """Port and reference dictionary backends with a small update buffer,
    so a group overflows it and falls back to the lanes path."""
    port = EncodedConflictBackend(
        tct.TorchConflictSet(4096, W, device=CPU, dict_slots=MIN_SLOTS),
        B, R, W, dict_encoder=tbatch.DictEncoder(MIN_SLOTS, W, max_upd))
    ref = RefBackend(
        rcj.JaxConflictSet(4096, W, dict_slots=MIN_SLOTS), B, R, W,
        dict_encoder=rbatch.DictEncoder(MIN_SLOTS, W, max_upd))
    return port, ref


def _keyed_groups(cls, lo, hi, write, version):
    """One group of 6 batches of 8 txns over keys lo..hi-1, each txn
    writing (or reading, snapshot 100) one range."""
    def rng_(i):
        i = lo + i % (hi - lo)
        return (b"k%04d" % i, b"k%04d\x01" % i)
    batches = [[cls([], [rng_(8 * b + t)], 100) if write
                else cls([rng_(8 * b + t)], [], 100) for t in range(8)]
               for b in range(6)]
    return batches, [version + i for i in range(6)]


def test_update_overflow_takes_the_lanes_path_and_ships_the_updates():
    """A group past the update buffer resolves on the lanes path, and its
    partial updates reach the device: the next group, whose ids point at
    them, still sees the writes (verdicts equal to the numpy twin's and
    the reference's, the dictionary equal to the reference's)."""
    port, ref = _overflow_backends(max_upd=90)
    npb = port_backend(kind="numpy")
    plan = [(0, 10, True, 1000),      # fits: the dictionary path
            (10, 58, True, 2000),     # 96 new endpoints > 90: overflow
            (10, 58, False, 3000)]    # reads of those keys: conflicts
    got, want, refv = [], [], []
    for lo, hi, write, v in plan:
        g = [_keyed_groups(tbatch.TxnRequest, lo, hi, write, v)]
        rg = [_keyed_groups(rbatch.TxnRequest, lo, hi, write, v)]
        got.append(drive(port, g, resolve_group_begin))
        want.append(drive(npb, g, resolve_group_begin))
        refv.append(drive(ref, rg, ref_group))
    assert got == want == refv
    assert set(got[2]) == {1}          # every read conflicts
    assert port.dict_fallbacks == 1 and port.dict_dispatches == 2
    assert np.array_equal(port.cs.dict_to_numpy(), np.asarray(ref.cs._dct))


def test_update_overflow_on_the_first_group_ships_the_updates():
    """The same fallback on a fresh backend, before any batch has run:
    the port allocates the dictionary for the partial updates (the JAX
    package's apply_dict_updates returns early there and drops them, so
    its next group misses these conflicts)."""
    port, _ = _overflow_backends(max_upd=90)
    npb = port_backend(kind="numpy")
    got = []
    for write, v in ((True, 1000), (False, 2000)):
        g = [_keyed_groups(tbatch.TxnRequest, 0, 48, write, v)]
        got.append(drive(port, g, resolve_group_begin))
        assert got[-1] == drive(npb, g, resolve_group_begin)
    assert port.dict_fallbacks == 1 and port.dict_dispatches == 1
    assert set(got[1]) == {1}           # every read conflicts


def test_reset_ring_keeps_the_dictionary():
    gs = groups(8, 6, 4)
    rgs = groups(8, 6, 4, cls=rbatch.TxnRequest)
    port, ref = port_backend(), ref_backend()
    drive(port, gs[:3], resolve_group_begin)
    drive(ref, rgs[:3], ref_group)
    before = port.cs.dict_to_numpy()
    assert port.reset_ring(0) and ref.reset_ring(0)
    assert np.array_equal(port.cs.dict_to_numpy(), before)
    assert (tct.state_to_numpy(port.cs.state)[2] == -1).all()
    assert drive(port, gs[3:], resolve_group_begin) == \
        drive(ref, rgs[3:], ref_group)
    assert_same_ring(port.cs, ref.cs)
    assert np.array_equal(port.cs.dict_to_numpy(), np.asarray(ref.cs._dct))


def test_slot_zero_stays_sentinel_after_padded_scatters():
    be = port_backend()
    d = be._dict
    gs = groups(9, 4, 3)
    drive(be, gs, lambda b, bs, vs: resolve_group_wire_begin(
        b, [tbatch.wire_from_txns(x) for x in bs], vs))
    # chunked out-of-band updates with padding rows, as the lanes
    # fallback ships them
    d.begin_group()
    d.encode([rand_txn(DeterministicRandom(1), 50, R) for _ in range(B)],
             B, R)
    be.cs.apply_dict_updates(d.upd_slots, d.upd_lanes, d.n_upd + 64)
    dct = be.cs.dict_to_numpy()
    assert (dct[:, 0] == 0xFFFFFFFF).all()
    assert (dct[:, 1:] != 0xFFFFFFFF).any(axis=0).sum() > 50


def test_default_knobs_take_the_dictionary_branch():
    be = make_conflict_backend(PortKnobs().override(
        RESOLVER_CONFLICT_BACKEND="cuda"), device=CPU)
    assert isinstance(be._dict, tbatch.DictEncoder)
    assert be.cs.dict_slots == PortKnobs().CONFLICT_DICT_SLOTS == 1 << 21
    rng = DeterministicRandom(2)
    batches = [[rand_txn(rng, 100, 8) for _ in range(4)] for _ in range(2)]
    got = drive(be, [(batches, [200, 201])], resolve_group_begin)
    cpp = CppConflictSet()
    assert got == [x for b, v in zip(batches, [200, 201])
                   for x in cpp.resolve(b, v)]
    assert be.dict_dispatches == 1
    assert be.cs.h2d_bytes > 0


@pytest.mark.cuda
def test_wire_paths_on_the_card_match_the_cpu():
    """On the card: the fused and ids wire paths and the dictionary
    group path give the CPU plain path's verdicts, ring and dictionary."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gs = groups(31, 6, 5, version=500)
    wgs = [(w, v) for w, (_, v) in zip(_wires(gs, tbatch), gs)]

    def backend(device):
        return make_conflict_backend(PortKnobs().override(
            RESOLVER_CONFLICT_BACKEND="cuda", CONFLICT_DICT_SLOTS=MIN_SLOTS,
            **SHAPE), device=device)

    cpu = backend(CPU)
    want = drive(cpu, wgs, resolve_group_wire_begin)
    for begin in (resolve_group_wire_begin, ids_group_wire_begin):
        card = backend(torch.device("cuda"))
        assert drive(card, wgs, begin) == want
        assert_same_ring(card.cs, cpu.cs)
        assert np.array_equal(card.cs.dict_to_numpy(),
                              cpu.cs.dict_to_numpy())
    card, cpu = backend(torch.device("cuda")), backend(CPU)
    assert drive(card, gs, resolve_group_begin) == \
        drive(cpu, gs, resolve_group_begin)
    assert_same_ring(card.cs, cpu.cs)
