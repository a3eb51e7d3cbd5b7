"""ctypes bindings for the native host-side data pipeline (ingest.cpp).

Compiled lazily with g++ on first use and cached next to the source. All
entry points have pure-numpy fallbacks in `rankfm_tpu.utils.data`, so the
package works without a toolchain; with it, ingestion of 10^8-row logs runs
at sort speed instead of pandas speed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "ingest.cpp")

_lock = threading.Lock()
_lib = None
_tried = False


# -ffp-contract=off: left to itself the compiler fuses a*b+c into one
# multiply-add wherever the target has the instruction, and where it does
# depends on the target; the oracle's sequential float trajectory, and
# with it its ML-1M hit rate (0.8402 built for AVX-512, 0.8321 for AVX2),
# then moved with the host. Without contraction every x86-64 target gives
# the same result.
_CXXFLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC",
             "-std=c++17")


def _compile_and_load(src, stem):
    """Compile ``src`` (if needed) and CDLL it.

    The binary path is keyed on a content hash of the source and the
    flags: a fresh checkout (where mtimes are meaningless) always rebuilds
    for ITS source and ITS machine — binaries are never shipped (they are
    built -march=native). g++ writes to a temp file that is atomically
    renamed into place, so concurrent builders (pytest-xdist workers, a
    test plus a probe script) never CDLL a partially-written ELF."""
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(_CXXFLAGS).encode())
    path = os.path.join(_HERE, f"{stem}-{h.hexdigest()[:16]}.so")
    if not os.path.exists(path):
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            subprocess.run(["g++", *_CXXFLAGS, "-o", tmp, src],
                           check=True, capture_output=True)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ctypes.CDLL(path)


def get_lib():
    """Load (building if necessary) the native library; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = _compile_and_load(_SRC, "_ingest")
            lib.rfm_unique_sorted.restype = ctypes.c_int64
            lib.rfm_unique_sorted.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
            lib.rfm_map_ids.restype = None
            lib.rfm_map_ids.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
            lib.rfm_build_csr.restype = ctypes.c_int64
            lib.rfm_build_csr.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p]
            lib.rfm_hash_pairs.restype = ctypes.c_uint64
            lib.rfm_hash_pairs.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
            lib.rfm_ingest.restype = ctypes.c_int64
            lib.rfm_ingest.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,   # u_raw, i_raw, n
                ctypes.c_void_p, ctypes.c_int64,                    # uids, nu
                ctypes.c_void_p, ctypes.c_int64,                    # iids, ni
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,   # prev csr
                ctypes.c_void_p, ctypes.c_void_p,                   # pairs, keep
                ctypes.c_void_p, ctypes.c_void_p,                   # offsets, items
                ctypes.c_void_p]                                    # n_kept
            _lib = lib
        except Exception:
            _lib = None
    return _lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def unique_sorted(ids):
    """native sorted-unique for int64 id columns; None if native unavailable"""
    lib = get_lib()
    if lib is None:
        return None
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    out = np.empty_like(ids)
    m = lib.rfm_unique_sorted(_ptr(ids), len(ids), _ptr(out))
    return out[:m].copy()


def map_ids(raw, sorted_unique):
    """native id -> dense index mapping (-1 for unknown); None if unavailable"""
    lib = get_lib()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw, dtype=np.int64)
    su = np.ascontiguousarray(sorted_unique, dtype=np.int64)
    out = np.empty(len(raw), dtype=np.int32)
    lib.rfm_map_ids(_ptr(raw), len(raw), _ptr(su), len(su), _ptr(out))
    return out


def hash_pairs(u_raw, i_raw):
    """64-bit content hash of the raw id columns; None if native unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    u_raw = np.ascontiguousarray(u_raw, dtype=np.int64)
    i_raw = np.ascontiguousarray(i_raw, dtype=np.int64)
    return int(lib.rfm_hash_pairs(_ptr(u_raw), _ptr(i_raw), len(u_raw)))


def ingest(u_raw, i_raw, uids, iids, prev_csr=None):
    """One-pass map+filter+CSR(+union) ingest; None if native unavailable.

    Returns ``(pairs int32 [kept,2], keep bool [n], offsets int32 [nu+1],
    flat_items int32 [nnz])``.
    """
    lib = get_lib()
    if lib is None:
        return None
    u_raw = np.ascontiguousarray(u_raw, dtype=np.int64)
    i_raw = np.ascontiguousarray(i_raw, dtype=np.int64)
    uids = np.ascontiguousarray(uids, dtype=np.int64)
    iids = np.ascontiguousarray(iids, dtype=np.int64)
    n, nu = len(u_raw), len(uids)
    pairs = np.empty((max(n, 1), 2), dtype=np.int32)
    keep = np.empty(max(n, 1), dtype=np.uint8)
    offsets = np.empty(nu + 1, dtype=np.int32)
    if prev_csr is not None:
        prev_off = np.ascontiguousarray(prev_csr[0], dtype=np.int32)
        prev_items = np.ascontiguousarray(prev_csr[1], dtype=np.int32)
        prev_nnz = len(prev_items)
        po, pi = _ptr(prev_off), _ptr(prev_items)
    else:
        prev_nnz = 0
        po = pi = None
    items = np.empty(max(n + prev_nnz, 1), dtype=np.int32)
    n_kept = np.zeros(1, dtype=np.int64)
    nnz = lib.rfm_ingest(_ptr(u_raw), _ptr(i_raw), n,
                         _ptr(uids), nu, _ptr(iids), len(iids),
                         po, pi, prev_nnz,
                         _ptr(pairs), _ptr(keep), _ptr(offsets), _ptr(items),
                         _ptr(n_kept))
    kept = int(n_kept[0])
    return (pairs[:kept].copy(), keep[:n].astype(bool), offsets,
            items[:nnz].copy())


_oracle_lock = threading.Lock()
_oracle_lib = None
_oracle_tried = False


def get_oracle():
    """Load (building if necessary) the sequential reference-semantics SGD
    oracle (oracle.cpp); None if no toolchain. Test/validation infrastructure
    — the training path never calls this."""
    global _oracle_lib, _oracle_tried
    if _oracle_lib is not None or _oracle_tried:
        return _oracle_lib
    with _oracle_lock:
        if _oracle_lib is not None or _oracle_tried:
            return _oracle_lib
        _oracle_tried = True
        try:
            _oracle_lib = bind_oracle(_compile_and_load(ORACLE_SRC,
                                                        "_oracle"))
        except Exception:
            _oracle_lib = None
    return _oracle_lib


ORACLE_SRC = os.path.join(_HERE, "oracle.cpp")


def bind_oracle(lib):
    """Declare the oracle's C signature on a loaded ``lib``; returns it."""
    lib.rfm_oracle_fit.restype = ctypes.c_int32
    lib.rfm_oracle_fit.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int64]
        + [ctypes.c_void_p] * 10
        + [ctypes.c_int32] * 5
        + [ctypes.c_float, ctypes.c_float, ctypes.c_float,
           ctypes.c_int32, ctypes.c_float,
           ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64]
        + [ctypes.c_void_p])
    return lib


def oracle_fit(interactions, sample_weight, offsets, items, x_uf, x_if,
               weights, alpha, beta, learning_rate, learning_schedule,
               learning_exponent, max_samples, epochs, seed):
    """Run the sequential reference-semantics SGD oracle.

    ``weights`` is the {w_i,w_if,v_u,v_i,v_uf,v_if} dict of INITIAL numpy
    arrays (not mutated). Returns ``(weights_out, ll_per_epoch)`` or None if
    the native oracle is unavailable.
    """
    lib = get_oracle()
    if lib is None:
        return None
    inter = np.ascontiguousarray(interactions, dtype=np.int32)
    sw = np.ascontiguousarray(sample_weight, dtype=np.float32)
    off = np.ascontiguousarray(offsets, dtype=np.int32)
    itm = np.ascontiguousarray(items, dtype=np.int32)
    xu = np.ascontiguousarray(x_uf, dtype=np.float32)
    xi = np.ascontiguousarray(x_if, dtype=np.float32)
    w = {k: np.array(weights[k], dtype=np.float32, order="C")
         for k in ("w_i", "w_if", "v_u", "v_i", "v_uf", "v_if")}
    U, F = w["v_u"].shape
    I = w["v_i"].shape[0]
    P, Q = xu.shape[1], xi.shape[1]
    ll = np.zeros(epochs, dtype=np.float32)
    rc = lib.rfm_oracle_fit(
        _ptr(inter), _ptr(sw), len(inter), _ptr(off), _ptr(itm),
        _ptr(xu), _ptr(xi),
        _ptr(w["w_i"]), _ptr(w["w_if"]), _ptr(w["v_u"]), _ptr(w["v_i"]),
        _ptr(w["v_uf"]), _ptr(w["v_if"]),
        U, I, P, Q, F,
        alpha, beta, learning_rate,
        1 if learning_schedule == "invscaling" else 0, learning_exponent,
        max_samples, epochs, seed, _ptr(ll))
    assert rc == 0, "oracle: weights went non-finite"
    return w, ll


def build_csr(users, items, num_users):
    """native CSR user-history build; None if unavailable"""
    lib = get_lib()
    if lib is None:
        return None
    users = np.ascontiguousarray(users, dtype=np.int32)
    items = np.ascontiguousarray(items, dtype=np.int32)
    offsets = np.empty(num_users + 1, dtype=np.int32)
    flat = np.empty(max(len(items), 1), dtype=np.int32)
    nnz = lib.rfm_build_csr(_ptr(users), _ptr(items), len(users),
                            num_users, _ptr(offsets), _ptr(flat))
    return offsets, flat[:nnz].copy()
