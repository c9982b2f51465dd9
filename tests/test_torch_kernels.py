"""The port's hand kernels' plain versions vs the JAX reference.

On the CPU every wrapper in foundationdb_tpu_torch/ops/kernels.py runs its
plain PyTorch version; these tests hold those against the reference's
own functions with exact integer equality.  The kernels themselves are
held against the same plain versions on the card (``cuda`` marker, and
chip_smoke.py).
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.ops import conflict_jax as cj
from foundationdb_tpu.ops import keycode as ref_keycode
from foundationdb_tpu_torch.ops import conflict_torch as ct
from foundationdb_tpu_torch.ops import kernels as K

W = 16
B, R = 8, 4
L = W // 4 + 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel worker processes: one CPU thread each
    for torch's ops keeps these tests from starving their neighbours."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chain_python(packed: np.ndarray, hist, ok) -> list[int]:
    """The commit chain as plain Python ints (the definition)."""
    n, nw = packed.shape
    cw = [0] * nw
    out = []
    for i in range(n):
        hit = 0
        for w in range(nw):
            hit |= cw[w] & (int(packed[i, w]) & 0xFFFFFFFF)
        conf = bool(hist[i]) or hit != 0
        if ok[i] and not conf:
            cw[i // 32] |= 1 << (i % 32)
        out.append(int(conf))
    return out


def _snaps_for(g, n, floor=10):
    """Snapshots giving random valid / too-old flags against ``floor``:
    -1 (invalid), below the floor (too old) or above it."""
    kind = g.random(n)
    snap = np.where(kind < 0.1, -1, np.where(kind < 0.2, floor - 5,
                                             floor + 5)).astype(np.int64)
    snap[:2] = -1, floor - 5
    return snap


@pytest.mark.parametrize("nb", [8, 33, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_commit_chain_plain_matches_reference_chain(nb, seed, monkeypatch):
    """Random overlap matrices, history hits and snapshots through the
    reference's unrolled chain (_batch_verdicts, pallas=False) and the
    port's K1 wrapper (its plain version on the CPU)."""
    g = np.random.default_rng(seed)
    M = g.random((nb, nb)) < 0.15
    np.fill_diagonal(M, False)
    hist = g.random(nb) < 0.1
    snap = _snaps_for(g, nb)
    too_old, valid = snap < 10, snap >= 0
    monkeypatch.setattr(cj, "_point_intra", lambda *a: jnp.asarray(M))
    monkeypatch.setattr(K, "_point_intra", lambda *a: torch.from_numpy(M))
    dummy = np.zeros((nb, 1, L), np.uint32)
    rv, rc = cj._batch_verdicts(dummy, dummy, dummy, dummy, jnp.asarray(hist),
                                jnp.asarray(too_old), jnp.asarray(valid), nb,
                                W, pallas=False, points=True)
    td = torch.zeros((nb, 1, L), dtype=torch.int32)
    tv = torch.empty(nb, dtype=torch.int8)
    tc = torch.empty(nb, dtype=torch.bool)
    K.commit_chain(td, td, td, td, torch.from_numpy(hist.astype(np.int32)),
                   torch.from_numpy(snap), torch.tensor([10]), W, True, tv, tc)
    np.testing.assert_array_equal(np.asarray(rv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(rc), tc.numpy())
    # the conf vector itself, every txn, against the definition
    packed = ct._pack_bits32(torch.from_numpy(M))
    ok = valid & ~too_old
    flags = torch.from_numpy(np.stack([hist, ok], 1).astype(np.int32))
    conf = K._word_chain(packed, flags)
    assert conf.tolist() == _chain_python(packed.numpy(), hist, ok)


def test_pack_bits32_matches_reference_words():
    g = np.random.default_rng(5)
    M = g.random((33, 70)) < 0.5
    ref = np.asarray(cj._pack_bits32(jnp.asarray(
        np.pad(M, ((0, 0), (0, 96 - 70))))))
    got = ct._pack_bits32(torch.from_numpy(M)).numpy().view(np.uint32)
    np.testing.assert_array_equal(ref, got)


@pytest.mark.parametrize("C,S", [(256, 32), (512, 256), (1000, 24)])
def test_ring_append_plain_matches_pallas_interpret(C, S):
    """The plain K2 against the reference Pallas kernel body run by the
    Pallas interpreter, and against concatenation."""
    g = np.random.default_rng(C + S)
    buf = g.integers(0, 2**32, size=(L, C), dtype=np.uint64).astype(np.uint32)
    slab = g.integers(0, 2**32, size=(L, S), dtype=np.uint64).astype(np.uint32)
    buf[:, :3] = 0xFFFFFFFF
    ref = np.asarray(cj._ring_append_call(L, C, S, True)(
        jnp.asarray(buf), jnp.asarray(slab)))
    np.testing.assert_array_equal(ref, np.concatenate([buf[:, S:], slab], 1))
    tb = torch.from_numpy(ct.map_lanes(buf))
    out = torch.empty_like(tb)
    K.ring_append(tb, torch.from_numpy(ct.map_lanes(slab)), out)
    np.testing.assert_array_equal(ct.unmap_lanes(out.numpy()), ref)


def _key(g) -> bytes:
    """A short key over a tiny alphabet (equalities are common), or one
    longer than W sharing a W-byte prefix (the truncation rules)."""
    if g.random() < 0.25:
        tail = g.integers(0, 3, size=int(g.integers(0, 3)))
        return b"\x01" * W + bytes(tail.astype(np.uint8))
    return bytes(g.integers(0, 4, size=int(g.integers(1, 4))).astype(np.uint8))


def _encoded_ranges(g, n, points):
    """n narrow ranges [k, k+"\\x00") (points) or [k, k+"\\x01"), encoded."""
    lo = [_key(g) for _ in range(n)]
    hi = [k + (b"\x00" if points else b"\x01") for k in lo]
    return ref_keycode.encode_keys(lo, W), ref_keycode.encode_keys(hi, W)


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _seg(hb, he, hver):
    """A history segment as the port takes it: mapped [L, n] planes."""
    return tuple(_t(ct.map_lanes(hb), ct.map_lanes(he), hver))


def _one(v):
    return torch.tensor([v], dtype=torch.int64)


@pytest.mark.parametrize("points", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hist_check_plain_matches_reference(points, seed):
    """The plain K3 against _hist_check_T / _point_hist_check_T: the slab
    as the full side in one or two segments, and as the window that the
    device choice takes or leaves."""
    g = np.random.default_rng(seed)
    N = 200
    rb, re = (x.reshape(B, R, L) for x in _encoded_ranges(g, B * R, points))
    hb, he = (x.T.copy() for x in _encoded_ranges(g, N, points))
    pad = g.random((B, R)) < 0.3
    rb[pad] = 0xFFFFFFFF
    re[pad] = 0xFFFFFFFF
    hb[:, :5] = 0xFFFFFFFF
    he[:, :5] = 0xFFFFFFFF
    hver = np.sort(g.integers(-1, 100, size=N))
    snap = g.integers(94, 100, size=B)
    snap[0] = -1
    if points:
        ref = cj._point_hist_check_T(rb, hb, hver, snap, W)
    else:
        ref = cj._hist_check_T(rb, re, hb, he, hver, snap, W)
    ref = np.asarray(ref).astype(np.int32)
    assert 0 < ref.sum() < B            # the data discriminates
    trb, tre, tsn = _t(ct.map_lanes(rb), ct.map_lanes(re), snap)
    whole = _seg(hb, he, hver)
    halves = [_seg(hb[:, s], he[:, s], hver[s])
              for s in (slice(0, 77), slice(77, N))]
    empty = _seg(hb, he, np.full(N, -1, np.int64))      # never newer
    for full, window, edge, want in (
            ([whole], None, None, ref),
            (halves, None, None, ref),
            ([empty], whole, -10, ref),          # fast_ok: the window
            (halves, empty, 10**6, ref),         # a snapshot predates edge
            ([empty], whole, 10**6, 0 * ref)):
        hit = torch.zeros(B, dtype=torch.int32)
        K.hist_check(trb, tre, tsn, W, points, hit, full, window,
                     None if edge is None else _one(edge), _one(0))
        np.testing.assert_array_equal(hit.numpy(), want)


def _hot_history(g, points, C, Wn, T, lo, hi):
    """A cold ring of C slots with versions rising through [lo, hi), and
    a hot buffer [edge | cold's Wn newest | T slots, half of them
    written at a later version] laid out as resolve_many_core lays it."""
    cb, ce = (x.T.copy() for x in _encoded_ranges(g, C, points))
    cv = np.sort(g.integers(lo, hi, size=C))
    cv[:C // 8] = -1
    tb, te = (x.T.copy() for x in _encoded_ranges(g, T, points))
    tv = np.full(T, hi + 5, np.int64)
    tb[:, T // 2:] = 0xFFFFFFFF
    te[:, T // 2:] = 0xFFFFFFFF
    tv[T // 2:] = -1
    hb = np.concatenate([cb[:, C - Wn - 1:], tb], 1)
    he = np.concatenate([ce[:, C - Wn - 1:], te], 1)
    hv = np.concatenate([cv[C - Wn - 1:], tv])
    return (cb, ce, cv), (hb, he, hv)


@pytest.mark.parametrize("points", [False, True])
@pytest.mark.parametrize("old", [False, True])
def test_hist_check_select_matches_reference_cond(points, old):
    """K3's one-launch choice (plain version) against what the
    reference's lax.cond picks in resolve_many_core's scan body: the
    window hot[1+off : 1+off+W] when every snapshot is invalid, too old
    or at or above the edge hot[off], else the cold ring OR the whole hot
    buffer.  ``old`` puts one snapshot below the edge."""
    g = np.random.default_rng(17 + points + 2 * old)
    C, Wn, T, off = 96, 32, 16, 8
    cold, hot = _hot_history(g, points, C, Wn, T, 50, 100)
    rb, re = (x.reshape(B, R, L) for x in _encoded_ranges(g, B * R, points))
    # txn 3 reads one key that only a cold slot outside the window holds
    uk = ref_keycode.encode_keys([b"\x09u", b"\x09u\x00" if points
                                  else b"\x09u\x01"], W)
    s = C - Wn - 10
    cold[0][:, s], cold[1][:, s], cold[2][s] = uk[0], uk[1], 60
    rb[3], re[3] = 0xFFFFFFFF, 0xFFFFFFFF
    rb[3, 0], re[3, 0] = uk
    edge = int(hot[2][off])
    floor = 40
    snap = g.integers(edge, 106, size=B)
    snap[1] = -1                        # invalid
    snap[2] = floor - 3                 # too old
    if old:
        snap[3] = 55                    # a valid snapshot below the edge
    fast_ok = bool(np.all((snap < 0) | (snap < floor) | (snap >= edge)))
    assert fast_ok != old

    def ref_check(hb, he, hv):
        if points:
            return np.asarray(cj._point_hist_check_T(rb, hb, hv, snap, W))
        return np.asarray(cj._hist_check_T(rb, re, hb, he, hv, snap, W))

    win = slice(off + 1, off + 1 + Wn)
    if fast_ok:
        ref = ref_check(hot[0][:, win], hot[1][:, win], hot[2][win])
    else:
        ref = ref_check(*cold) | ref_check(*hot)
    ref = ref.astype(np.int32)
    tcold, thot = _seg(*cold), _seg(*hot)
    hit = torch.zeros(B, dtype=torch.int32)
    trb, tre, tsn = _t(ct.map_lanes(rb), ct.map_lanes(re), snap)
    K.hist_check(trb, tre, tsn, W, points, hit, [tcold, thot],
                 window=tuple(x[..., win] for x in thot),
                 edge=thot[2][off:off + 1], floor=_one(floor))
    np.testing.assert_array_equal(hit.numpy(), ref)
    if old:     # the window alone would miss a conflict here
        assert (ref_check(hot[0][:, win], hot[1][:, win], hot[2][win])
                != ref).any()


def test_hist_check_takes_strided_slab():
    """A window view (row stride of the whole ring) checks like a copy."""
    g = np.random.default_rng(9)
    N, Wn = 120, 40
    rb, re = (x.reshape(B, R, L) for x in _encoded_ranges(g, B * R, False))
    hb, he = (ct.map_lanes(x.T.copy()) for x in _encoded_ranges(g, N, False))
    hver = np.arange(N, dtype=np.int64)
    snap = np.full(B, N - Wn - 5, np.int64)
    a = [torch.from_numpy(x) for x in (ct.map_lanes(rb), ct.map_lanes(re))]
    thb, the = torch.from_numpy(hb), torch.from_numpy(he)
    tv, ts = torch.from_numpy(hver), torch.from_numpy(snap)
    h1 = torch.zeros(B, dtype=torch.int32)
    h2 = torch.zeros(B, dtype=torch.int32)
    K.hist_check(*a, ts, W, False, h1,
                 [(thb[:, N - Wn:], the[:, N - Wn:], tv[N - Wn:])])
    K.hist_check(*a, ts, W, False, h2,
                 [(thb[:, N - Wn:].contiguous(), the[:, N - Wn:].contiguous(),
                   tv[N - Wn:])])
    assert torch.equal(h1, h2)


def _intra_batch(g, nb, points):
    """A batch of nb txns: encoded reads and writes (some rows padding),
    history hits, and snapshots with invalid and too-old txns."""
    def rows():
        b, e = (x.reshape(nb, R, L) for x in _encoded_ranges(g, nb * R,
                                                             points))
        pad = g.random((nb, R)) < 0.3
        b[pad] = 0xFFFFFFFF
        e[pad] = 0xFFFFFFFF
        return b, e

    (rb, re), (wb, we) = rows(), rows()
    hist = (g.random(nb) < 0.1).astype(np.int32)
    return rb, re, wb, we, hist, _snaps_for(g, nb)


@pytest.mark.parametrize("points", [False, True])
@pytest.mark.parametrize("nb", [8, 33, 64])
def test_commit_chain_step_matches_reference(points, nb):
    """The whole K1 step (plain version, through the wrapper) against the
    reference's _batch_verdicts(..., pallas=False) followed by
    _slab_from_writes: verdicts, committed, the slab's lanes, and the
    versions written beside them."""
    g = np.random.default_rng(nb + 100 * points)
    rb, re, wb, we, hist, snap = _intra_batch(g, nb, points)
    too_old, valid = snap < 10, snap >= 0
    rv, rc = cj._batch_verdicts(rb, re, wb, we, jnp.asarray(hist != 0),
                                jnp.asarray(too_old), jnp.asarray(valid), nb,
                                W, pallas=False, points=points)
    sb, se = cj._slab_from_writes(wb, we, rc, nb * R, L)
    rv, rc, sb, se = (np.asarray(x) for x in (rv, rc, sb, se))
    assert {0, 1, 2} <= set(rv.tolist())          # every verdict occurs
    assert rc.any()
    t = _t(*(ct.map_lanes(x) for x in (rb, re, wb, we)), hist, snap)
    hot = torch.zeros((L, 3 + nb * R), dtype=torch.int32)
    hv = torch.zeros(3 + nb * R, dtype=torch.int64)
    tv = torch.empty(nb, dtype=torch.int8)
    tc = torch.empty(nb, dtype=torch.bool)
    K.commit_chain(*t, _one(10), W, points, tv, tc,
                   slab=(hot[:, 3:], torch.zeros_like(hot)[:, 3:], hv[3:]),
                   version_t=_one(777))
    np.testing.assert_array_equal(tv.numpy(), rv)
    np.testing.assert_array_equal(tc.numpy(), rc)
    np.testing.assert_array_equal(ct.unmap_lanes(hot[:, 3:].numpy()), sb)
    assert hv[3:].tolist() == [777] * (nb * R) and hv[:3].tolist() == [0] * 3
    v2, c2, pb, pe = K.commit_chain_plain(*t, _one(10), W, points)
    np.testing.assert_array_equal(ct.unmap_lanes(pe.numpy()), se)
    np.testing.assert_array_equal(ct.unmap_lanes(pb.numpy()), sb)


def test_lane_mapping_round_trip_keeps_order():
    g = np.random.default_rng(3)
    special = np.array([0, 1, W, W + 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE,
                        0xFFFFFFFF], np.uint32)
    x = np.concatenate([special, g.integers(0, 2**32, size=500,
                                            dtype=np.uint64).astype(np.uint32)])
    m = ct.map_lanes(x)
    assert m.dtype == np.int32
    np.testing.assert_array_equal(ct.unmap_lanes(m), x)
    a, b = x[:, None], x[None, :]
    ma, mb = m[:, None], m[None, :]
    np.testing.assert_array_equal(a < b, ma < mb)
    np.testing.assert_array_equal(a == b, ma == mb)
    # the sentinel and the truncation marker map as the kernels expect
    assert int(ct.map_lanes(np.uint32(0xFFFFFFFF))) == K.SENTINEL_MAPPED
    assert int(ct.map_lanes(np.uint32(W + 1))) == K.mapped(W + 1)
    assert int(ct.map_lanes(np.uint32(W))) == K.mapped(W)


def test_group_launches_move_pointers_like_fresh_views(monkeypatch):
    """GroupLaunches' per-batch launcher arguments (batch 0's moved k
    steps) equal those the wrappers build from batch k's own views, for
    resolve_many_core's layout.  The wrappers are made to take the CPU
    tensors for card tensors, and the launches are recorded, not run."""
    monkeypatch.setattr(K, "_same_device", lambda *ts: torch.device("cuda"))
    monkeypatch.setattr(K, "_stream", lambda t: 7)
    calls = []
    monkeypatch.setattr(K.Kernel, "launch",
                        lambda self, *a: calls.append((self.name, a)))
    g = np.random.default_rng(2)
    Kb, Wn, C = 4, 32, 256
    S = B * R
    lanes = [torch.from_numpy(g.integers(-2**31, 2**31, size=(Kb, B, R, L))
                              .astype(np.int32)) for _ in range(4)]
    snap = torch.from_numpy(g.integers(0, 100, size=(Kb, B)))
    cold = (torch.zeros((L, C), dtype=torch.int32),
            torch.zeros((L, C), dtype=torch.int32),
            torch.zeros(C, dtype=torch.int64))
    hot = (torch.zeros((L, 1 + Wn + Kb * S), dtype=torch.int32),
           torch.zeros((L, 1 + Wn + Kb * S), dtype=torch.int32),
           torch.zeros(1 + Wn + Kb * S, dtype=torch.int64))
    floors = torch.zeros(Kb, dtype=torch.int64)
    hits = torch.zeros((Kb, B), dtype=torch.int32)
    verdicts = torch.empty((Kb, B), dtype=torch.int8)
    committed = torch.empty((Kb, B), dtype=torch.bool)

    def views(k):
        off = k * S
        win, dst = slice(off + 1, off + 1 + Wn), slice(off + 1 + Wn,
                                                       off + 1 + Wn + S)
        rows = dict(rb=lanes[0][k], re=lanes[1][k], snap=snap[k], width=W,
                    points=True, hit=hits[k])
        return (dict(rows, full=(cold, hot), window=tuple(
                    x[..., win] for x in hot), edge=hot[2][off:off + 1],
                     floor=floors[k:k + 1]),
                dict(rows, wb=lanes[2][k], we=lanes[3][k],
                     floor=floors[k:k + 1], verdicts=verdicts[k],
                     committed=committed[k],
                     slab=tuple(x[..., dst] for x in hot)))

    def plain(args):
        return [[(u.hb, u.he, u.stride, u.hver, u.n) for u in a]
                if isinstance(a, ctypes.Array) else a for a in args]

    launches = K.GroupLaunches(views, Kb)
    vt = hot[2][-1:]
    for k in range(Kb):
        calls.clear()
        launches.run(k, 1000 + k, vt if k == 0 else None)
        h, c = views(k)
        want_h = K._hist_check_args(**h)
        want_c = K._commit_chain_args(**c, version=1000 + k,
                                      version_t=vt if k == 0 else None)
        assert [n for n, _ in calls] == ["hist_check", "commit_chain"]
        assert plain(calls[0][1]) == plain(want_h), k
        assert plain(calls[1][1]) == plain(want_c), k


def test_wrappers_refuse_bad_inputs():
    rows = torch.zeros((B, R, L), dtype=torch.int32)
    i32 = torch.zeros(B, dtype=torch.int32)
    snap = torch.zeros(B, dtype=torch.int64)
    out8 = torch.empty(B, dtype=torch.int8)
    outb = torch.empty(B, dtype=torch.bool)
    with pytest.raises(ValueError):     # int64 rows
        K.commit_chain(rows.long(), rows, rows, rows, i32, snap, _one(0), W,
                       True, out8, outb)
    with pytest.raises(ValueError):     # a floor that is not one int64
        K.commit_chain(rows, rows, rows, rows, i32, snap, torch.zeros(2),
                       W, True, out8, outb)
    with pytest.raises(ValueError):     # a slab of the wrong width
        K.commit_chain(rows, rows, rows, rows, i32, snap, _one(0), W, True,
                       out8, outb, slab=(torch.zeros((L, 3), dtype=torch.int32),
                                         torch.zeros((L, 3), dtype=torch.int32),
                                         None))
    buf = torch.zeros((L, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="aliases"):
        K.ring_append(buf, torch.zeros((L, 8), dtype=torch.int32), buf)
    seg = (buf, buf, torch.zeros(64, dtype=torch.int64))
    with pytest.raises(ValueError):     # an int64 hit vector
        K.hist_check(rows, rows, snap, W, False, snap, [seg])
    with pytest.raises(ValueError, match="edge and floor"):
        K.hist_check(rows, rows, snap, W, False, i32, [seg], window=seg)
    with pytest.raises(ValueError, match="one or two"):
        K.hist_check(rows, rows, snap, W, False, i32, [seg] * 3)


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card():
    """Each kernel against its plain version on CUDA tensors (the card
    only; chip_smoke.py does the same at the resolver's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    g = np.random.default_rng(11)
    for points in (False, True):
        for nb in (8, 33, 64, 100):
            rb, re, wb, we, hist, snap = _intra_batch(g, nb, points)
            t = [x.to(dev) for x in _t(*(ct.map_lanes(x)
                                         for x in (rb, re, wb, we)),
                                       hist, snap)]
            floor = _one(10).to(dev)
            hot = torch.zeros((L, 1 + nb * R), dtype=torch.int32, device=dev)
            hoe = torch.zeros_like(hot)
            hv = torch.zeros(1 + nb * R, dtype=torch.int64, device=dev)
            tv = torch.empty(nb, dtype=torch.int8, device=dev)
            tc = torch.empty(nb, dtype=torch.bool, device=dev)
            K.commit_chain(*t, floor, W, points, tv, tc,
                           slab=(hot[:, 1:], hoe[:, 1:], hv[1:]), version=55)
            v, c, sb, se = K.commit_chain_plain(*t, floor, W, points)
            assert torch.equal(tv, v) and torch.equal(tc, c)
            assert torch.equal(hot[:, 1:], sb) and torch.equal(hoe[:, 1:], se)
            assert bool((hv[1:] == 55).all()) and int(hv[0]) == 0
    buf = torch.from_numpy(g.integers(-2**31, 2**31, size=(L, 1000))
                           .astype(np.int32)).to(dev)
    slab = torch.from_numpy(g.integers(-2**31, 2**31, size=(L, 37))
                            .astype(np.int32)).to(dev)
    o1, o2 = torch.empty_like(buf), torch.empty_like(buf)
    assert torch.equal(K.ring_append(buf, slab, o1),
                       K.ring_append_plain(buf, slab, o2))
    # the resolver's layout: the slab is a view into a hot staging buffer
    # from column 1 + window, so unaligned and with an odd row stride
    hot = torch.from_numpy(g.integers(-2**31, 2**31, size=(L, 1 + 16 + 64))
                           .astype(np.int32)).to(dev)
    assert torch.equal(K.ring_append(buf, hot[:, 17:], o1),
                       K.ring_append_plain(buf, hot[:, 17:], o2))
    for points in (False, True):
        for old in (False, True):
            cold, hotn = _hot_history(g, points, 600, 256, 64, 50, 100)
            tcold, thot = (tuple(x.to(dev) for x in _seg(*s))
                           for s in (cold, hotn))
            rb, re = (torch.from_numpy(ct.map_lanes(x.reshape(B, R, L)))
                      .to(dev) for x in _encoded_ranges(g, B * R, points))
            sn = torch.from_numpy(g.integers(90, 106, size=B)).to(dev)
            if old:
                sn[3] = 55
            win = tuple(x[..., 9:9 + 256] for x in thot)
            args = (rb, re, sn, W, points)
            kw = dict(window=win, edge=thot[2][8:9],
                      floor=_one(40).to(dev))
            hit = torch.zeros(B, dtype=torch.int32, device=dev)
            K.hist_check(*args, hit, [tcold, thot], **kw)
            want = K.hist_check_select_plain(*args, [tcold, thot], **kw)
            assert torch.equal(hit, want.to(torch.int32))
            hit.zero_()
            K.hist_check(*args, hit, [tcold])
            want = K.hist_check_plain(rb, re, *tcold, sn, W, points)
            assert torch.equal(hit, want.to(torch.int32))
