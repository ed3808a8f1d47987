"""ctypes bindings for the native C++ host helpers (csrc/host/*.cpp): the
anchor seeder/chainer, the poset-consistency decoder and the MEA DP.

Counterpart of cpecan_tpu/align/native.py. The shared library is built on
demand with g++ into the checkout's ``build/cpecan_tpu_torch/`` (the
file name carries a hash of the sources, so edited sources build anew).
If the toolchain or the sources are unavailable the callers fall back to
the numpy implementations — identical semantics, so the numpy paths
double as the parity oracle.

Set CPECAN_TPU_NATIVE=0 to force the numpy path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCES = tuple(_PKG / "csrc" / "host" / f
                for f in ("anchors.cpp", "posetfilter.cpp", "mea.cpp"))
BUILD_DIR = _PKG.parent / "build" / "cpecan_tpu_torch"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_lib_failed = False


def _build_and_load():
    if not all(s.exists() for s in SOURCES):
        return None
    digest = hashlib.sha256(b"".join(s.read_bytes() for s in SOURCES)
                            + " ".join(_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libcpecan_host_{digest}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        subprocess.run(["g++", *_FLAGS, "-o", str(tmp), *map(str, SOURCES)],
                       check=True, capture_output=True)
        os.replace(tmp, lib)  # atomic: concurrent builds race harmlessly
    cdll = ctypes.CDLL(str(lib))
    cdll.cpecan_anchor_chain.restype = ctypes.c_int64
    cdll.cpecan_anchor_chain.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
    ]
    cdll.cpecan_anchors_free.restype = None
    cdll.cpecan_anchors_free.argtypes = [ctypes.POINTER(ctypes.c_int64)]
    cdll.cpecan_filter_pairs_ordered.restype = ctypes.c_int64
    cdll.cpecan_filter_pairs_ordered.argtypes = [
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_double,
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
    ]
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    cdll.cpecan_mea.restype = ctypes.c_int64
    cdll.cpecan_mea.argtypes = [
        i64p, i64p, i64p, ctypes.c_int64,
        i64p, ctypes.c_int64, i64p, ctypes.c_int64, ctypes.c_double,
        i64p, ctypes.POINTER(ctypes.c_double),
    ]
    return cdll


def available() -> bool:
    """True when the native library can be (lazily) built and loaded."""
    global _lib, _lib_failed
    if os.environ.get("CPECAN_TPU_NATIVE", "1") == "0":
        return False
    if _lib is not None:
        return True
    if _lib_failed:
        return False
    with _lock:
        if _lib is None and not _lib_failed:
            try:
                _lib = _build_and_load()
            except Exception:
                _lib = None
            if _lib is None:
                _lib_failed = True
    return _lib is not None


def chained_runs(seq_x: str, seq_y: str, k: int, max_occ: int,
                 respect_mask: bool) -> np.ndarray:
    """Chained match runs (n, 3) of (x, y, len) via the C++ seeder/chainer."""
    if not available():
        raise RuntimeError("native anchors library unavailable")
    bx = seq_x.encode("latin-1")
    by = seq_y.encode("latin-1")
    out = ctypes.POINTER(ctypes.c_int64)()
    n = _lib.cpecan_anchor_chain(
        bx, len(bx), by, len(by), k, max_occ, 1 if respect_mask else 0,
        ctypes.byref(out))
    if n < 0:
        raise MemoryError("cpecan_anchor_chain allocation failure")
    if n == 0:
        return np.empty((0, 3), dtype=np.int64)
    try:
        runs = np.ctypeslib.as_array(out, shape=(int(n), 3)).copy()
    finally:
        _lib.cpecan_anchors_free(out)
    return runs


def mea_decode(probs, xs, ys, cum_gap_x, cum_gap_y, lx: int, ly: int,
               gap_gamma: float):
    """MEA DP over a sparse posterior pair list (native/mea.cpp); returns
    (chosen indices ascending, score). Bit-compatible with the numpy
    fallback in ops/mea.py."""
    if not available():
        raise RuntimeError("native library unavailable")
    n = len(probs)
    chosen = np.empty(max(n, 1), np.int64)
    score = ctypes.c_double()
    count = _lib.cpecan_mea(
        np.ascontiguousarray(probs, np.int64),
        np.ascontiguousarray(xs, np.int64),
        np.ascontiguousarray(ys, np.int64), n,
        np.ascontiguousarray(cum_gap_x, np.int64), lx,
        np.ascontiguousarray(cum_gap_y, np.int64), ly,
        float(gap_gamma), chosen, ctypes.byref(score))
    return chosen[:count], float(score.value)


def filter_pairs_ordered(pairs, match_gamma: float) -> np.ndarray:
    """Keep-mask over a posterior pair array for the 2-sequence
    poset-consistency decode (native/posetfilter.cpp); bit-compatible with
    the Python progressive-MSA path in msa/aligner.py."""
    if not available():
        raise RuntimeError("native library unavailable")
    n = len(pairs)
    keep = np.zeros(n, np.uint8)
    if n:
        _lib.cpecan_filter_pairs_ordered(
            np.ascontiguousarray(pairs["prob"], np.int64),
            np.ascontiguousarray(pairs["x"], np.int64),
            np.ascontiguousarray(pairs["y"], np.int64),
            n, float(match_gamma), keep)
    return keep.astype(bool)
