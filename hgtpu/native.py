"""ctypes bindings for the native runtime (native/libhgtpu_native.so).

The library is built from native/*.cpp (`make -C native`) the first time
a process needs it; a failed build raises.  The pure-numpy fallbacks
cover a library that exists but cannot be loaded.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
LIB_NAME = "libhgtpu_native.so"

_LIB = None


def library_path(native_dir: str = NATIVE_DIR) -> str:
    """Path of the native library in `native_dir`, built there with
    `make` when it is absent.  The check and the build hold an exclusive
    lock on `<native_dir>/.build.lock`, so concurrent processes (test
    workers) build once and never load a half-written file."""
    import fcntl
    import subprocess

    path = os.path.join(native_dir, LIB_NAME)
    with open(os.path.join(native_dir, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(path):
            r = subprocess.run(["make", "-C", native_dir],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError("native build failed (make -C %s):\n%s%s"
                                   % (native_dir, r.stdout, r.stderr))
    return path


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    try:
        lib = ctypes.CDLL(library_path())
    except OSError:
        _LIB = False
        return False
    lib.hgtpu_build_sa.restype = ctypes.c_int64
    lib.hgtpu_build_sa.argtypes = [
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32)]
    lib.hgtpu_bwt_from_sa.restype = None
    lib.hgtpu_bwt_from_sa.argtypes = [
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int8)]
    lib.hgtpu_scan_fastx.restype = ctypes.c_int64
    lib.hgtpu_scan_fastx.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64]
    _LIB = lib
    return lib


def have_native() -> bool:
    return bool(_load())


def build_suffix_array(codes: np.ndarray) -> np.ndarray:
    """SA over int8 base codes; includes the appended sentinel position.
    Native SA-IS when available, numpy sort fallback otherwise."""
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    n = len(codes)
    lib = _load()
    if lib:
        sa = np.empty(n + 1, dtype=np.int32)
        lib.hgtpu_build_sa(
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), n,
            sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return sa
    # fallback: O(n log^2 n) prefix-doubling
    s = np.concatenate([codes.astype(np.int32) + 1, [0]])
    n1 = len(s)
    sa = np.argsort(s, kind="stable").astype(np.int32)
    rank = np.empty(n1, np.int64)
    rank[sa] = np.arange(n1)
    k = 1
    while k < n1:
        key2 = np.where(np.arange(n1) + k < n1,
                        rank[np.minimum(np.arange(n1) + k, n1 - 1)] + 1, 0)
        order = np.lexsort((key2, rank))
        new_rank = np.empty(n1, np.int64)
        prev = (rank[order[1:]] != rank[order[:-1]]) | \
               (key2[order[1:]] != key2[order[:-1]])
        new_rank[order] = np.concatenate([[0], np.cumsum(prev)])
        rank = new_rank
        sa = order.astype(np.int32)
        if rank.max() == n1 - 1:
            break
        k *= 2
    return sa


def bwt_from_sa(codes: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """BWT over codes 0..4 with 5 as the sentinel symbol."""
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    lib = _load()
    if lib:
        bwt = np.empty(len(sa), dtype=np.int8)
        lib.hgtpu_bwt_from_sa(
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            np.ascontiguousarray(sa, np.int32).ctypes.data_as(
                ctypes.POINTER(ctypes.c_int32)),
            len(sa), bwt.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
        return bwt
    prev = sa - 1
    bwt = np.where(sa == 0, 5, codes[np.maximum(prev, 0)]).astype(np.int8)
    return bwt


def scan_fastx(text: bytes):
    """[(name, seq)] using the native scanner when available."""
    lib = _load()
    if not lib:
        return None
    max_recs = max(16, text.count(b"\n") // 2 + 1)
    offsets = np.empty(max_recs * 4, dtype=np.int64)
    n = lib.hgtpu_scan_fastx(
        text, len(text),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), max_recs)
    out = []
    is_fasta = text[:1] == b">"
    for i in range(n):
        no, nl, so, sl = offsets[i * 4:i * 4 + 4]
        name = text[no:no + nl].decode()
        if is_fasta:
            seq = text[so:].split(b">", 1)[0].replace(b"\n", b"")[:sl]
        else:
            seq = text[so:so + sl]
        out.append((name, seq.decode()))
    return out
