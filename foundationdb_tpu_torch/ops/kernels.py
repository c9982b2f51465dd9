"""The resolver path's hand kernels (csrc/*.cu) and their plain versions.

Three kernels, each a CUDA C++ source for ``sm_90a`` compiled with
``nvcc`` into its own shared library at first use and bound through
ctypes over a plain C launcher (no PyTorch headers, so a build takes
seconds):

- ``commit_chain``  (csrc/commit_chain.cu) — a batch's whole verdict
  step: the intra-batch overlap matrix, its bit pack, the in-order commit
  chain, the verdict codes and the batch's slab; replaces the Pallas
  ``_chain_kernel_call`` and the XLA work of ``_batch_verdicts`` /
  ``_slab_from_writes`` around it.
- ``ring_append``   (csrc/ring_append.cu) — one lane plane's shift-left
  + tail write into a spare plane; replaces the Pallas
  ``_ring_append_call``.
- ``hist_check``    (csrc/hist_check.cu) — reads vs the history, with the
  reference's window/full-ring ``lax.cond`` decided inside the launch;
  replaces the XLA-compiled ``_hist_check_T`` / ``_point_hist_check_T``.

A resolve batch of the fused loop is one ``hist_check`` launch and one
``commit_chain`` launch (``GroupLaunches``: checked once per group).
Each wrapper checks device, dtype, shape and strides, counts its
launches (``KERNELS[name].launches``), and for tensors on the CPU runs
the plain PyTorch version beside it.  For CUDA tensors it launches the
kernel or raises; it never falls back.

Lanes are int32 holding the reference's u32 key lanes XOR 0x80000000
(see ``conflict_torch.map_lanes``), so signed ``<`` is unsigned ``<``.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import time

import torch

from .batch import COMMITTED, CONFLICT, TOO_OLD

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(HERE), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

SIGN = 0x80000000
SENTINEL_MAPPED = 0x7FFFFFFF        # the u32 sentinel 0xFFFFFFFF, mapped
SMEM_MAX = 227 * 1024               # dynamic shared memory a block may opt into


def mapped(x: int) -> int:
    """One u32 lane value as the int32 the kernels compare."""
    y = x ^ SIGN
    return y - (1 << 32) if y >= 1 << 31 else y


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return "/usr/local/cuda/bin/nvcc"


_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


class Seg(ctypes.Structure):
    """One history segment as hist_check.cu's ``Seg``: lane planes hb/he
    [L, n] with a row stride, versions hver [n]."""
    _fields_ = [("hb", _P), ("he", _P), ("stride", _LL), ("hver", _P),
                ("n", _LL)]


class Kernel:
    """One hand kernel: its source, its C launcher, its launch count."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: list) -> None:
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    @property
    def lib_path(self) -> str:
        return os.path.join(BUILD_DIR, f"lib{self.name}.so")

    def build_cmd(self, out: str) -> list[str]:
        return [_nvcc(), *NVCC_FLAGS, "-o", out,
                os.path.join(CSRC, self.source)]

    def built(self) -> bool:
        out = self.lib_path
        deps = [os.path.join(CSRC, self.source)] + \
            glob.glob(os.path.join(CSRC, "*.cuh"))
        return os.path.exists(out) and os.path.getmtime(out) >= \
            max(os.path.getmtime(d) for d in deps)

    def load(self):
        if self._fn is None:
            if not self.built():
                build([self])
            fn = getattr(ctypes.CDLL(self.lib_path), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        err = self.load()(*args)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err}")
        self.launches += 1


KERNELS = {
    "commit_chain": Kernel(
        "commit_chain", "commit_chain.cu", "fdbt_commit_chain",
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
         _P, _LL, _P, _LL, _P, _P]),
    "ring_append": Kernel(
        "ring_append", "ring_append.cu", "fdbt_ring_append",
        [_P, _P, _P, _I, _LL, _LL, _LL, _P]),
    "hist_check": Kernel(
        "hist_check", "hist_check.cu", "fdbt_hist_check",
        [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.POINTER(Seg), _P, _P,
         _P, _P]),
}


def build(kernels=None) -> float:
    """Compile the given kernels (all by default), one nvcc per source,
    all started together; returns the wall seconds.  Each library is
    written under a temporary name and renamed into place."""
    kernels = list(KERNELS.values()) if kernels is None else kernels
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for k in kernels:
        tmp = f"{k.lib_path}.{os.getpid()}.tmp"
        procs.append((k, tmp, subprocess.Popen(
            k.build_cmd(tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    errors = []
    for k, tmp, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{k.source}:\n{out}")
        else:
            os.replace(tmp, k.lib_path)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, dim: int) -> None:
    if t.dtype != dtype or t.dim() != dim:
        raise ValueError(f"{name}: want {dim}-d {dtype}, got "
                         f"{t.dim()}-d {t.dtype}")


def _check_one(t: torch.Tensor, name: str) -> None:
    """A device scalar the kernels read through a pointer: one int64."""
    if t.dtype != torch.int64 or t.numel() != 1:
        raise ValueError(f"{name}: want one int64, got {t.numel()} "
                         f"{t.dtype}")


def _same_device(*ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    for t in ts[1:]:
        if t is not None and t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    return dev


MAX_ROWS = 32                       # csrc/lanes.cuh: ranges of a txn


def _check_rows(name: str, *ts: torch.Tensor) -> tuple[int, int, int]:
    """[B, R, L] int32 range rows, all of one shape, R <= MAX_ROWS."""
    for i, t in enumerate(ts):
        _check(t, f"{name}[{i}]", torch.int32, 3)
        if t.shape != ts[0].shape:
            raise ValueError(f"{name}: rows of shapes {tuple(ts[0].shape)} "
                             f"and {tuple(t.shape)}")
    if ts[0].shape[1] > MAX_ROWS:
        raise ValueError(f"{name}: {ts[0].shape[1]} ranges a txn exceed "
                         f"{MAX_ROWS}")
    return tuple(ts[0].shape)


def _contiguous(name: str, *ts: torch.Tensor) -> None:
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: rows, versions, snapshots and outputs "
                         "must be contiguous")


# --------------------------------------------------------------------------
# comparison primitives (torch ops on mapped lanes; the plain versions)


def _lex_lt(a, b):
    """Strict lex < over the trailing lane axis -> (lt, eq)."""
    L = a.shape[-1]
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    lt = torch.zeros(shape, dtype=torch.bool, device=a.device)
    eq = torch.ones_like(lt)
    for l in range(L):
        al, bl = a[..., l], b[..., l]
        lt = lt | (eq & (al < bl))
        eq = eq & (al == bl)
    return lt, eq


def _possibly_lt(a, b, width):
    lt, eq = _lex_lt(a, b)
    w1 = mapped(width + 1)
    both_trunc = (a[..., -1] == w1) & (b[..., -1] == w1)
    return lt | (eq & both_trunc)


def _overlap(ab, ae, bb, be, width):
    return _possibly_lt(ab, be, width) & _possibly_lt(bb, ae, width)


def point_pair_rule(data_eq, la, lb, width: int):
    """Point-range overlap as an equality rule on the length lanes:
    equal lengths, or one exactly ``width`` and the other the truncation
    marker ``width+1``; sentinels never conflict (the reference's
    _point_pair_rule, on mapped lanes)."""
    w, w1 = mapped(width), mapped(width + 1)
    valid = (la != SENTINEL_MAPPED) & (lb != SENTINEL_MAPPED)
    edge = ((la == w) & (lb == w1)) | ((la == w1) & (lb == w))
    return data_eq & valid & ((la == lb) | edge)


def _point_intra(read_begin, write_begin, width):
    """All-point intra-batch matrix: reads of i vs writes of j -> [B,B]."""
    B = read_begin.shape[0]
    L = read_begin.shape[-1]
    eq = torch.ones(read_begin.shape[:2] + write_begin.shape[:2],
                    dtype=torch.bool, device=read_begin.device)
    for l in range(L - 1):
        eq = eq & (read_begin[:, :, None, None, l]
                   == write_begin[None, None, :, :, l])
    m = point_pair_rule(eq, read_begin[:, :, None, None, -1],
                        write_begin[None, None, :, :, -1], width)
    eye = torch.eye(B, dtype=torch.bool, device=read_begin.device)
    return m.any(dim=3).any(dim=1) & ~eye


def _interval_intra(rb, re, wb, we, width):
    """Interval intra-batch matrix: reads of i vs writes of j -> [B,B]."""
    m = _overlap(rb[:, :, None, None, :], re[:, :, None, None, :],
                 wb[None, None, :, :, :], we[None, None, :, :, :], width)
    eye = torch.eye(rb.shape[0], dtype=torch.bool, device=rb.device)
    return m.any(dim=3).any(dim=1) & ~eye


def _low32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the int32 with the same low bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _pack_bits32(m: torch.Tensor) -> torch.Tensor:
    """[K, n] bool -> [K, ceil(n/32)] int32; bit b of word w = m[:, w*32+b]
    (the words are built in int64: torch has no uint32 shift)."""
    K, n = m.shape
    nw = (n + 31) // 32
    mp = torch.zeros((K, nw * 32), dtype=torch.int64, device=m.device)
    mp[:, :n] = m
    shifts = torch.arange(32, dtype=torch.int64, device=m.device)
    return _low32((mp.view(K, nw, 32) << shifts).sum(dim=-1))


def _slab_from_writes(write_begin, write_end, committed, S_: int, L: int):
    """[L, S_] lane slabs holding committed writes; sentinel elsewhere."""
    valid_w = write_begin[..., -1] != SENTINEL_MAPPED              # [B,R]
    ins = (committed[:, None] & valid_w).reshape(S_, 1)
    slab_b = torch.where(ins, write_begin.reshape(S_, L), SENTINEL_MAPPED)
    slab_e = torch.where(ins, write_end.reshape(S_, L), SENTINEL_MAPPED)
    return slab_b.T.contiguous(), slab_e.T.contiguous()


# --------------------------------------------------------------------------
# K1: the batch's verdict step


def _word_chain(packed: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """The unrolled word chain of the reference's _batch_verdicts
    (pallas=False), in int64 words holding the u32 bits: conf [B] int32
    from packed [B, nw] and flags [B, 2] (history hit, ok)."""
    B, nw = packed.shape
    p = packed.to(torch.int64) & 0xFFFFFFFF
    hist = flags[:, 0] != 0
    ok = flags[:, 1] != 0
    zero = torch.zeros((), dtype=torch.int64, device=packed.device)
    cw = [zero] * nw
    conf_out = []
    for i in range(B):
        hit = cw[0] & p[i, 0]
        for w in range(1, nw):
            hit = hit | (cw[w] & p[i, w])
        conf = hist[i] | (hit != 0)
        commit = ok[i] & ~conf
        wi, bi = divmod(i, 32)
        cw[wi] = cw[wi] | torch.where(commit, 1 << bi, 0)
        conf_out.append(conf)
    return torch.stack(conf_out).to(torch.int32)


def commit_chain_plain(rb, re, wb, we, hit, snap, floor, width: int,
                       points: bool):
    """The reference's steps 2-4 for one batch, composed of torch ops:
    the intra-batch matrix, its bit words, the word chain, the verdict
    codes and the slab.  Returns (verdicts [B] int8, committed [B] bool,
    slab_b [L, B*R], slab_e [L, B*R])."""
    B, R, L = rb.shape
    M = _point_intra(rb, wb, width) if points \
        else _interval_intra(rb, re, wb, we, width)
    too_old = snap < floor.reshape(())
    valid = snap >= 0
    ok = valid & ~too_old
    flags = torch.stack([hit != 0, ok], dim=1).to(torch.int32)
    conf = _word_chain(_pack_bits32(M), flags) != 0
    committed = ok & ~conf
    verdicts = torch.where(
        ~valid, COMMITTED,
        torch.where(too_old, TOO_OLD,
                    torch.where(conf, CONFLICT, COMMITTED))).to(torch.int8)
    slab_b, slab_e = _slab_from_writes(wb, we, committed, B * R, L)
    return verdicts, committed, slab_b, slab_e


def commit_chain(rb, re, wb, we, hit, snap, floor, width: int, points: bool,
                 verdicts: torch.Tensor, committed: torch.Tensor,
                 slab=None, version: int = -1,
                 version_t: torch.Tensor | None = None) -> None:
    """One batch's verdict step into ``verdicts`` [B] int8 and
    ``committed`` [B] bool, from reads/writes rb, re, wb, we [B, R, L],
    the history hits ``hit`` [B] int32, ``snap`` [B] and the too-old
    ``floor`` (one int64 on the device).  With ``slab = (slab_b, slab_e,
    slab_v)`` it also writes the batch's slab: the [L, B*R] lane planes
    (unit-stride rows sharing one row stride, e.g. hot-buffer columns)
    and, unless ``slab_v`` is None, the [B*R] versions, all equal to
    ``version_t`` (one int64 on the device) if given, else ``version``."""
    args = _commit_chain_args(rb, re, wb, we, hit, snap, floor, width,
                              points, verdicts, committed, slab, version,
                              version_t)
    if args is not None:
        KERNELS["commit_chain"].launch(*args)
        return
    B, R, L = rb.shape
    v, c, sb, se = commit_chain_plain(rb, re, wb, we, hit, snap, floor,
                                      width, points)
    verdicts.copy_(v)
    committed.copy_(c)
    if slab is not None:
        slab_b, slab_e, slab_v = slab
        slab_b.copy_(sb)
        slab_e.copy_(se)
        if slab_v is not None:
            slab_v.copy_((version_t if version_t is not None
                          else torch.tensor(version)).reshape(1)
                         .expand(B * R))


def _commit_chain_args(rb, re, wb, we, hit, snap, floor, width, points,
                       verdicts, committed, slab, version, version_t):
    """commit_chain's checks; -> the C launcher's arguments for CUDA
    tensors, None for CPU tensors."""
    B, R, L = _check_rows("rows", rb, re, wb, we)
    for t, n, dt in ((hit, "hit", torch.int32), (snap, "snap", torch.int64),
                     (verdicts, "verdicts", torch.int8),
                     (committed, "committed", torch.bool)):
        _check(t, n, dt, 1)
        if t.shape[0] != B:
            raise ValueError(f"commit_chain: {n} has {t.shape[0]} != {B}")
    _check_one(floor, "floor")
    slab_b, slab_e, slab_v = slab if slab is not None else (None,) * 3
    if slab_b is not None:
        _check(slab_b, "slab_b", torch.int32, 2)
        _check(slab_e, "slab_e", torch.int32, 2)
        if slab_b.shape != (L, B * R) or slab_e.shape != (L, B * R) \
                or slab_b.stride() != slab_e.stride() \
                or slab_b.stride(1) != 1:
            raise ValueError("commit_chain: slab planes must be [L, B*R] "
                             "with unit-stride rows of one row stride")
        if slab_v is not None:
            _check(slab_v, "slab_v", torch.int64, 1)
            if slab_v.shape[0] != B * R or slab_v.stride(0) != 1:
                raise ValueError("commit_chain: slab_v must be [B*R], "
                                 "unit-stride")
    if version_t is not None:
        _check_one(version_t, "version_t")
    if B > 1024:
        raise ValueError(f"commit_chain: B={B} exceeds one warp's 32 "
                         "committed words")
    dev = _same_device(rb, re, wb, we, hit, snap, floor, verdicts,
                       committed, slab_b, slab_e, slab_v, version_t)
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"commit_chain: unsupported device {dev}")
    _contiguous("commit_chain", rb, re, wb, we, hit, snap, verdicts,
                committed)
    nw = (B + 31) // 32
    staged = B * R * (3 * L + 2 if points else 4 * L)
    if 4 * (B * nw + 2 * B + staged + nw) + B > SMEM_MAX:
        raise ValueError(f"commit_chain: B={B}, R={R}, L={L} exceed shared "
                         "memory")
    return [rb.data_ptr(), re.data_ptr(), wb.data_ptr(), we.data_ptr(),
            hit.data_ptr(), snap.data_ptr(), floor.data_ptr(), B, R, L,
            mapped(width), mapped(width + 1), SENTINEL_MAPPED, int(points),
            verdicts.data_ptr(), committed.data_ptr(), _ptr(slab_b),
            _ptr(slab_e), 0 if slab_b is None else slab_b.stride(0),
            _ptr(slab_v), version, _ptr(version_t), _stream()]


# --------------------------------------------------------------------------
# K2: the ring append into a spare plane


def ring_append_plain(buf: torch.Tensor, slab: torch.Tensor,
                      out: torch.Tensor) -> torch.Tensor:
    C = buf.shape[1]
    S = slab.shape[1]
    out[:, :C - S] = buf[:, S:]
    out[:, C - S:] = slab
    return out


def ring_append(buf: torch.Tensor, slab: torch.Tensor,
                out: torch.Tensor) -> torch.Tensor:
    """out = [buf[:, S:] | slab] for [L, C] int32 planes; ``out`` must
    not alias ``buf`` (the shift would race across blocks)."""
    _check(buf, "buf", torch.int32, 2)
    _check(slab, "slab", torch.int32, 2)
    _check(out, "out", torch.int32, 2)
    L, C = buf.shape
    S = slab.shape[1]
    if slab.shape[0] != L or out.shape != buf.shape or not 0 < S <= C:
        raise ValueError(f"ring_append: buf {tuple(buf.shape)}, slab "
                         f"{tuple(slab.shape)}, out {tuple(out.shape)}")
    if not (buf.is_contiguous() and out.is_contiguous()
            and slab.stride(1) == 1):
        raise ValueError("ring_append: planes must be contiguous and the "
                         "slab's rows unit-stride")
    if out.data_ptr() == buf.data_ptr():
        raise ValueError("ring_append: out aliases buf")
    dev = _same_device(buf, slab, out)
    if dev.type == "cpu":
        return ring_append_plain(buf, slab, out)
    if dev.type != "cuda":
        raise ValueError(f"ring_append: unsupported device {dev}")
    KERNELS["ring_append"].launch(buf.data_ptr(), slab.data_ptr(),
                                  out.data_ptr(), L, C, S, slab.stride(0),
                                  _stream())
    return out


# --------------------------------------------------------------------------
# K3: the history check


def _plt_T(a, bT, w1):
    """possibly_lt of rows a [B,R,L] vs columns bT [L,N] -> [B,R,N]."""
    L = a.shape[-1]
    lt = torch.zeros(a.shape[:-1] + (bT.shape[-1],), dtype=torch.bool,
                     device=a.device)
    eq = torch.ones_like(lt)
    for l in range(L):
        al = a[..., l:l + 1]
        bl = bT[l][None, None, :]
        lt = lt | (eq & (al < bl))
        eq = eq & (al == bl)
    both = (a[..., -1:] == w1) & (bT[-1][None, None, :] == w1)
    return lt | (eq & both)


def _plt_T_rev(aT, b, w1):
    """possibly_lt of columns aT [L,N] vs rows b [B,R,L] -> [B,R,N]."""
    L = b.shape[-1]
    lt = torch.zeros(b.shape[:-1] + (aT.shape[-1],), dtype=torch.bool,
                     device=b.device)
    eq = torch.ones_like(lt)
    for l in range(L):
        al = aT[l][None, None, :]
        bl = b[..., l:l + 1]
        lt = lt | (eq & (al < bl))
        eq = eq & (al == bl)
    both = (aT[-1][None, None, :] == w1) & (b[..., -1:] == w1)
    return lt | (eq & both)


_PLAIN_CHUNK = 8192     # history slots per step of the plain check


def hist_check_plain(rb, re, hb, he, hver, snap, width: int,
                     points: bool) -> torch.Tensor:
    """conflict [B] bool: the reference's _hist_check_T (or
    _point_hist_check_T) over one segment, taken in chunks of slots so
    the [B, R, N] intermediates stay small."""
    B = rb.shape[0]
    w1 = mapped(width + 1)
    out = torch.zeros(B, dtype=torch.bool, device=rb.device)
    N = hver.shape[0]
    for s in range(0, N, _PLAIN_CHUNK):
        hbT, heT = hb[:, s:s + _PLAIN_CHUNK], he[:, s:s + _PLAIN_CHUNK]
        hv = hver[s:s + _PLAIN_CHUNK]
        if points:
            L = rb.shape[-1]
            eq = torch.ones(rb.shape[:-1] + (hbT.shape[-1],),
                            dtype=torch.bool, device=rb.device)
            for l in range(L - 1):
                eq = eq & (rb[..., l:l + 1] == hbT[l][None, None, :])
            hit = point_pair_rule(eq, rb[..., -1:], hbT[-1][None, None, :],
                                  width)
        else:
            hit = _plt_T(rb, heT, w1) & _plt_T_rev(hbT, re, w1)
        newer = hv[None, None, :] > snap[:, None, None]
        out |= (hit & newer).any(dim=2).any(dim=1)
    return out


def fast_path_ok(snap, edge, floor) -> torch.Tensor:
    """The reference's ``fast_ok``: every snapshot is invalid, too old,
    or at or above the version just outside the window -> bool []."""
    return ((snap < 0) | (snap < floor.reshape(()))
            | (snap >= edge.reshape(()))).all()


def hist_check_select_plain(rb, re, snap, width: int, points: bool, full,
                            window=None, edge=None,
                            floor=None) -> torch.Tensor:
    """conflict [B] bool: what the reference's lax.cond picks — the
    window segment when ``window`` is given and ``fast_path_ok`` holds,
    else every segment of ``full`` — checked by hist_check_plain."""
    side = [window] if window is not None \
        and bool(fast_path_ok(snap, edge, floor)) else list(full)
    out = torch.zeros(rb.shape[0], dtype=torch.bool, device=rb.device)
    for hb, he, hver in side:
        out |= hist_check_plain(rb, re, hb, he, hver, snap, width, points)
    return out


def hist_check(rb, re, snap, width: int, points: bool, hit: torch.Tensor,
               full, window=None, edge: torch.Tensor | None = None,
               floor: torch.Tensor | None = None) -> torch.Tensor:
    """hit [B] int32 (0 or 1, zeroed by the caller) gets a 1 for every
    txn whose reads rb/re [B, R, L] conflict with the history newer than
    its snapshot ``snap`` [B].  The history is ``full``, one or two
    segments (hb, he, hver) with hb/he [L, n] (unit-stride rows of one
    row stride) and hver [n]; with ``window`` (one more segment) and the
    device scalars ``edge`` and ``floor`` the reference's window/full
    choice is made inside the launch (``fast_path_ok``)."""
    args = _hist_check_args(rb, re, snap, width, points, hit, full, window,
                            edge, floor)
    if args is not None:
        KERNELS["hist_check"].launch(*args)
        return hit
    hit |= hist_check_select_plain(rb, re, snap, width, points, full,
                                   window, edge, floor).to(torch.int32)
    return hit


def _hist_check_args(rb, re, snap, width, points, hit, full, window, edge,
                     floor):
    """hist_check's checks; -> the C launcher's arguments for CUDA
    tensors, None for CPU tensors."""
    B, R, L = _check_rows("reads", rb, re)
    _check(snap, "snap", torch.int64, 1)
    _check(hit, "hit", torch.int32, 1)
    if snap.shape != (B,) or hit.shape != (B,):
        raise ValueError("hist_check: snap and hit must be [B]")
    segs = list(full)
    if not 1 <= len(segs) <= 2:
        raise ValueError("hist_check: full takes one or two segments")
    if window is not None:
        if edge is None or floor is None:
            raise ValueError("hist_check: a window needs edge and floor")
        _check_one(edge, "edge")
        _check_one(floor, "floor")
    for hb, he, hver in segs + ([window] if window is not None else []):
        _check(hb, "hb", torch.int32, 2)
        _check(he, "he", torch.int32, 2)
        _check(hver, "hver", torch.int64, 1)
        n = hver.shape[0]
        if hb.shape != (L, n) or he.shape != (L, n):
            raise ValueError("hist_check: segment shapes do not match")
        if hb.stride() != he.stride() or hb.stride(1) != 1 \
                or hver.stride(0) != 1:
            raise ValueError("hist_check: segment rows must be unit-stride "
                             "and share one row stride")
    dev = _same_device(rb, re, snap, hit, *(t for s in segs for t in s),
                       *(window or ()), edge, floor)
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"hist_check: unsupported device {dev}")
    _contiguous("hist_check", rb, re, snap, hit)
    staged = 8 * R * L + L * 128            # 8 txns' rows, a tile's lanes
    if 4 * staged * (1 if points else 2) > SMEM_MAX:
        raise ValueError(f"hist_check: B={B}, R={R}, L={L} exceed shared "
                         "memory")
    arr = (Seg * 3)()
    for i, s in ((0, window), (1, segs[0]),
                 (2, segs[1] if len(segs) > 1 else None)):
        if s is not None:
            hb, he, hver = s
            arr[i] = Seg(hb.data_ptr(), he.data_ptr(), hb.stride(0),
                         hver.data_ptr(), hver.shape[0])
    return [rb.data_ptr(), re.data_ptr(), snap.data_ptr(), B, R, L,
            mapped(width), mapped(width + 1), SENTINEL_MAPPED, int(points),
            arr, _ptr(edge), _ptr(floor), hit.data_ptr(), _stream()]


# --------------------------------------------------------------------------
# the two launches of each batch of a fused group


class GroupLaunches:
    """K3 then K1 for each batch k of a fused group.  ``views(k)`` gives
    batch k's keyword arguments of ``hist_check`` and of ``commit_chain``
    (without the version), as tensor views at a fixed stride from batch
    to batch.  On the card the wrappers check and build batches 0 and 1
    once, and batch k's arguments are batch 0's with every pointer moved
    k times the step between them: a batch costs two C calls, not two
    wrapper calls over a dozen fresh views.  On the CPU each batch runs
    the wrappers (the plain versions)."""

    def __init__(self, views, K: int) -> None:
        self.views = views
        h0, c0 = views(0)
        self.h = _hist_check_args(**h0)
        if self.h is None:
            return
        self.c = _commit_chain_args(**c0, version=-1, version_t=None)
        if K > 1:
            h1, c1 = views(1)
            self.dh = _steps(self.h, _hist_check_args(**h1))
            self.dc = _steps(self.c, _commit_chain_args(**c1, version=-1,
                                                         version_t=None))

    def run(self, k: int, version: int,
            version_t: torch.Tensor | None) -> None:
        if self.h is None:
            h, c = self.views(k)
            hist_check(**h)
            commit_chain(**c, version=version, version_t=version_t)
            return
        h, c = self.h, list(self.c)
        if k:
            h, c = _moved(h, self.dh, k), _moved(c, self.dc, k)
        c[-3], c[-2] = version, _ptr(version_t)
        KERNELS["hist_check"].launch(*h)
        KERNELS["commit_chain"].launch(*c)


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _steps(a0: list, a1: list) -> list:
    """Per-argument step from batch 0's launcher arguments to batch 1's:
    an int difference, a Seg array's field differences, or None."""
    out = []
    for x, y in zip(a0, a1):
        if isinstance(x, ctypes.Array):
            out.append([[getattr(v, f) - getattr(u, f) if u.n else 0
                         for f, _ in Seg._fields_] for u, v in zip(x, y)])
        elif isinstance(x, int):
            out.append(y - x)
        else:
            out.append(None)
    return out


def _moved(a0: list, steps: list, k: int) -> list:
    out = []
    for x, d in zip(a0, steps):
        if isinstance(x, ctypes.Array):
            arr = (Seg * len(x))()
            for i, (u, du) in enumerate(zip(x, d)):
                arr[i] = Seg(*(getattr(u, f) + k * dv if u.n else
                               getattr(u, f)
                               for (f, _), dv in zip(Seg._fields_, du)))
            out.append(arr)
        else:
            out.append(x + k * d if d else x)
    return out
