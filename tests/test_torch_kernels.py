"""The port's hand kernels' plain versions vs the JAX reference.

On the CPU every wrapper in foundationdb_tpu_torch/ops/kernels.py runs its
plain PyTorch version; these tests hold those against the reference's
own functions with exact integer equality.  The kernels themselves are
held against the same plain versions on the card (``cuda`` marker, and
chip_smoke.py).
"""

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


@pytest.mark.parametrize("nb", [8, 33, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_commit_chain_plain_matches_reference_chain(nb, seed, monkeypatch):
    """Random overlap matrices and flags through the reference's unrolled
    chain (_batch_verdicts, pallas=False) and the port's _batch_verdicts,
    whose chain is kernels.commit_chain (plain on the CPU)."""
    g = np.random.default_rng(seed)
    M = g.random((nb, nb)) < 0.15
    np.fill_diagonal(M, False)
    hist = g.random(nb) < 0.1
    too_old = g.random(nb) < 0.1
    valid = g.random(nb) < 0.9
    monkeypatch.setattr(cj, "_point_intra", lambda *a: jnp.asarray(M))
    monkeypatch.setattr(ct, "_point_intra", lambda *a: torch.from_numpy(M))
    dummy = np.zeros((nb, 1, L), np.uint32)
    rv, rc = cj._batch_verdicts(dummy, dummy, dummy, dummy, jnp.asarray(hist),
                                jnp.asarray(too_old), jnp.asarray(valid), nb,
                                W, pallas=False, points=True)
    td = torch.zeros((nb, 1, L), dtype=torch.int32)
    tv, tc = ct._batch_verdicts(td, td, td, td, torch.from_numpy(hist),
                                torch.from_numpy(too_old),
                                torch.from_numpy(valid), nb, W, points=True)
    np.testing.assert_array_equal(np.asarray(rv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(rc), tc.numpy())
    # the conf vector itself, every txn, against the definition
    packed = ct._pack_bits32(torch.from_numpy(M))
    ok = valid & ~too_old
    flags = torch.from_numpy(np.stack([hist, ok], 1).astype(np.int32))
    conf = K.commit_chain(packed, flags)
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


@pytest.mark.parametrize("points", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hist_check_plain_matches_reference(points, seed):
    """The plain K3 against _hist_check_T / _point_hist_check_T, with and
    without the device predicate."""
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
    t = [torch.from_numpy(x) for x in (ct.map_lanes(rb), ct.map_lanes(re),
                                       ct.map_lanes(hb), ct.map_lanes(he),
                                       hver, snap)]
    for pred, expected, want in ((None, 1, ref), (1, 1, ref), (0, 0, ref),
                                 (1, 0, 0 * ref), (0, 1, 0 * ref)):
        hit = torch.zeros(B, dtype=torch.int32)
        p = None if pred is None else torch.tensor([pred], dtype=torch.int32)
        K.hist_check(*t, W, points, hit, p, expected)
        np.testing.assert_array_equal(hit.numpy(), want)


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
    K.hist_check(*a, thb[:, N - Wn:], the[:, N - Wn:], tv[N - Wn:], ts, W,
                 False, h1)
    K.hist_check(*a, thb[:, N - Wn:].contiguous(),
                 the[:, N - Wn:].contiguous(), tv[N - Wn:], ts, W, False, h2)
    assert torch.equal(h1, h2)


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


def test_wrappers_refuse_bad_inputs():
    with pytest.raises(ValueError):
        K.commit_chain(torch.zeros((8, 1), dtype=torch.int64),
                       torch.zeros((8, 2), dtype=torch.int32))
    with pytest.raises(ValueError):
        K.commit_chain(torch.zeros((64, 1), dtype=torch.int32),
                       torch.zeros((64, 2), dtype=torch.int32))
    buf = torch.zeros((L, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="aliases"):
        K.ring_append(buf, torch.zeros((L, 8), dtype=torch.int32), buf)
    with pytest.raises(ValueError):
        K.hist_check(torch.zeros((B, R, L), dtype=torch.int32),
                     torch.zeros((B, R, L), dtype=torch.int32),
                     buf, buf, torch.zeros(64, dtype=torch.int64),
                     torch.zeros(B, dtype=torch.int64), W, False,
                     torch.zeros(B, dtype=torch.int64))


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card():
    """Each kernel against its plain version on CUDA tensors (the card
    only; chip_smoke.py does the same at the resolver's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    g = np.random.default_rng(11)
    for nb in (8, 33, 64, 100):
        nw = (nb + 31) // 32
        p = torch.from_numpy(g.integers(-2**31, 2**31, size=(nb, nw))
                             .astype(np.int32)).to(dev)
        f = torch.from_numpy(g.integers(0, 2, size=(nb, 2))
                             .astype(np.int32)).to(dev)
        assert torch.equal(K.commit_chain(p, f), K.commit_chain_plain(p, f))
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
        rb, re = (torch.from_numpy(ct.map_lanes(x.reshape(B, R, L))).to(dev)
                  for x in _encoded_ranges(g, B * R, points))
        hb, he = (torch.from_numpy(ct.map_lanes(x.T.copy())).to(dev)
                  for x in _encoded_ranges(g, 300, points))
        hv = torch.from_numpy(np.sort(g.integers(-1, 60, size=300))).to(dev)
        sn = torch.from_numpy(g.integers(-1, 60, size=B)).to(dev)
        hit = torch.zeros(B, dtype=torch.int32, device=dev)
        K.hist_check(rb, re, hb, he, hv, sn, W, points, hit)
        want = K.hist_check_plain(rb, re, hb, he, hv, sn, W, points)
        assert torch.equal(hit, want.to(torch.int32))
