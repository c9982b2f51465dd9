"""The resolver path's hand kernels (csrc/*.cu) and their plain versions.

Three kernels, each a CUDA C++ source for ``sm_90a`` compiled with
``nvcc`` into its own shared library at first use and bound through
ctypes over a plain C launcher (no PyTorch headers, so a build takes
seconds):

- ``commit_chain``  (csrc/commit_chain.cu) — the in-order commit chain;
  replaces the Pallas ``_chain_kernel_call``.
- ``ring_append``   (csrc/ring_append.cu) — one lane plane's shift-left
  + tail write into a spare plane; replaces the Pallas
  ``_ring_append_call``.
- ``hist_check``    (csrc/hist_check.cu) — reads vs a history slab, with
  a device predicate that lets both sides of the window/full-ring choice
  be launched without a host sync; replaces the XLA-compiled
  ``_hist_check_T`` / ``_point_hist_check_T``.

Each wrapper checks device, dtype, shape and contiguity, counts its
launches (``KERNELS[name].launches``), and for a tensor on the CPU runs
the plain PyTorch version beside it.  For a CUDA tensor it launches the
kernel or raises; it never falls back.

Lanes are int32 holding the reference's u32 key lanes XOR 0x80000000
(see ``conflict_torch.map_lanes``), so signed ``<`` is unsigned ``<``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(HERE), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

SIGN = 0x80000000
SENTINEL_MAPPED = 0x7FFFFFFF        # the u32 sentinel 0xFFFFFFFF, mapped


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
        return os.path.exists(out) and os.path.getmtime(out) >= \
            os.path.getmtime(os.path.join(CSRC, self.source))

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
        [_P, _P, _P, _I, _I, _P]),
    "ring_append": Kernel(
        "ring_append", "ring_append.cu", "fdbt_ring_append",
        [_P, _P, _P, _I, _LL, _LL, _LL, _P]),
    "hist_check": Kernel(
        "hist_check", "hist_check.cu", "fdbt_hist_check",
        [_P, _P, _P, _P, _LL, _P, _LL, _P, _I, _I, _I, _I, _I, _I, _I, _P,
         _I, _P, _P]),
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


def _same_device(*ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    for t in ts[1:]:
        if t is not None and t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    return dev


# --------------------------------------------------------------------------
# K1: the in-order commit chain


def commit_chain_plain(packed: torch.Tensor,
                       flags: torch.Tensor) -> torch.Tensor:
    """The unrolled word chain of the reference's _batch_verdicts
    (pallas=False), in int64 words holding the u32 bits."""
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


def commit_chain(packed: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """conf [B] int32 from packed [B, nw] and flags [B, 2] int32."""
    _check(packed, "packed", torch.int32, 2)
    _check(flags, "flags", torch.int32, 2)
    B, nw = packed.shape
    if nw != (B + 31) // 32 or flags.shape != (B, 2):
        raise ValueError(f"packed {tuple(packed.shape)} / flags "
                         f"{tuple(flags.shape)} do not match B={B}")
    dev = _same_device(packed, flags)
    if dev.type == "cpu":
        return commit_chain_plain(packed, flags)
    if dev.type != "cuda":
        raise ValueError(f"commit_chain: unsupported device {dev}")
    if nw > 32 or 4 * (B * nw + 2 * B) > 48 * 1024:
        raise ValueError(f"commit_chain: B={B} too large for one warp")
    packed = packed.contiguous()
    flags = flags.contiguous()
    out = torch.empty(B, dtype=torch.int32, device=dev)
    KERNELS["commit_chain"].launch(packed.data_ptr(), flags.data_ptr(),
                                   out.data_ptr(), B, nw, _stream())
    return out


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


def point_pair_rule(data_eq, la, lb, width: int):
    """Point-range overlap as an equality rule on the length lanes:
    equal lengths, or one exactly ``width`` and the other the truncation
    marker ``width+1``; sentinels never conflict (the reference's
    _point_pair_rule, on mapped lanes)."""
    w, w1 = mapped(width), mapped(width + 1)
    valid = (la != SENTINEL_MAPPED) & (lb != SENTINEL_MAPPED)
    edge = ((la == w) & (lb == w1)) | ((la == w1) & (lb == w))
    return data_eq & valid & ((la == lb) | edge)


_PLAIN_CHUNK = 8192     # history slots per step of the plain check


def hist_check_plain(rb, re, hb, he, hver, snap, width: int,
                     points: bool) -> torch.Tensor:
    """conflict [B] bool: the reference's _hist_check_T (or
    _point_hist_check_T), taken over the slab in chunks of slots so the
    [B, R, N] intermediates stay small."""
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


def hist_check(rb, re, hb, he, hver, snap, width: int, points: bool,
               hit: torch.Tensor, pred: torch.Tensor | None = None,
               expected: int = 1) -> torch.Tensor:
    """hit [B] int32 |= the history check of reads rb/re [B,R,L] against
    the slab hb/he [L,N] (rows may be strided), hver [N], snap [B].  With
    ``pred`` (an int32 device scalar) the check runs only where
    ``pred == expected``, decided on the device."""
    for t, n, dt, d in ((rb, "rb", torch.int32, 3), (re, "re", torch.int32, 3),
                        (hb, "hb", torch.int32, 2), (he, "he", torch.int32, 2),
                        (hver, "hver", torch.int64, 1),
                        (snap, "snap", torch.int64, 1),
                        (hit, "hit", torch.int32, 1)):
        _check(t, n, dt, d)
    B, R, L = rb.shape
    N = hver.shape[0]
    if re.shape != rb.shape or hb.shape != (L, N) or he.shape != (L, N) \
            or snap.shape != (B,) or hit.shape != (B,):
        raise ValueError("hist_check: shapes do not match")
    if hb.stride() != he.stride() or hb.stride(1) != 1:
        raise ValueError("hist_check: slab rows must be unit-stride and "
                         "share one row stride")
    if pred is not None and (pred.dtype != torch.int32 or pred.numel() != 1):
        raise ValueError("hist_check: pred must be one int32")
    dev = _same_device(rb, re, hb, he, hver, snap, hit, pred)
    if dev.type == "cpu":
        if pred is not None and int(pred) != expected:
            return hit
        hit |= hist_check_plain(rb, re, hb, he, hver, snap, width,
                                points).to(torch.int32)
        return hit
    if dev.type != "cuda":
        raise ValueError(f"hist_check: unsupported device {dev}")
    if not (rb.is_contiguous() and re.is_contiguous() and hver.is_contiguous()
            and snap.is_contiguous() and hit.is_contiguous()):
        raise ValueError("hist_check: reads, versions and hit must be "
                         "contiguous")
    smem = 4 * ((1 if points else 2) * (L * 128 + 8 * R * L))
    if smem > 48 * 1024:
        raise ValueError(f"hist_check: L={L}, R={R} exceed shared memory")
    KERNELS["hist_check"].launch(
        rb.data_ptr(), re.data_ptr(), hb.data_ptr(), he.data_ptr(),
        hb.stride(0), hver.data_ptr(), N, snap.data_ptr(), B, R, L,
        mapped(width), mapped(width + 1), SENTINEL_MAPPED, int(points),
        None if pred is None else pred.data_ptr(), expected,
        hit.data_ptr(), _stream())
    return hit
