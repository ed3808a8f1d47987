"""ctypes bindings for the native C++ host helpers (csrc/host/*.cpp): the
anchor seeder/chainer, the poset-consistency decoder, the MEA DP, the
progressive MSA merge, the band builder and the alignment anchors of the
expectation tasks.

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
                for f in ("anchors.cpp", "posetfilter.cpp", "mea.cpp",
                          "progressive.cpp", "band.cpp", "tasks.cpp"))
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
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    cdll.cpecan_progressive_msa.restype = ctypes.c_int64
    cdll.cpecan_progressive_msa.argtypes = [
        ctypes.c_int64, i64p,
        ctypes.c_int64, i64p, i64p, f64p,
        ctypes.c_int64, i64p, i64p,
        ctypes.c_double, i64p,
    ]
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    cdll.cpecan_build_bands.restype = ctypes.c_int64
    cdll.cpecan_build_bands.argtypes = [
        ctypes.c_int64, i64p, ctypes.c_int64, i64p, i64p, i64p,
        ctypes.c_int64, ctypes.c_int64, i64p, i32p, i32p, i64p,
    ]
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    cdll.cpecan_alignment_anchors.restype = ctypes.c_int64
    cdll.cpecan_alignment_anchors.argtypes = [
        ctypes.c_int64, i64p, u8p, i64p, u8p, i64p, u8p, i64p,
        ctypes.c_int64, ctypes.c_int64, i64p, i64p, i64p,
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


def progressive_msa(seq_lengths, edge_a, edge_b, edge_w, order_x, order_y,
                    match_gamma: float) -> np.ndarray:
    """Run the whole progressive column-merge loop natively; returns the
    union-find root per position id (see csrc/host/progressive.cpp)."""
    if not available():
        raise RuntimeError("native library unavailable")
    lengths = np.ascontiguousarray(seq_lengths, np.int64)
    ea = np.ascontiguousarray(edge_a, np.int64)
    eb = np.ascontiguousarray(edge_b, np.int64)
    ew = np.ascontiguousarray(edge_w, np.float64)
    ox = np.ascontiguousarray(order_x, np.int64)
    oy = np.ascontiguousarray(order_y, np.int64)
    parent = np.empty(int(lengths.sum()), np.int64)
    rc = _lib.cpecan_progressive_msa(
        len(lengths), lengths, len(ea), ea, eb, ew, len(ox), ox, oy,
        float(match_gamma), parent)
    if rc != 0:
        raise RuntimeError(f"cpecan_progressive_msa failed rc={rc}")
    return parent


def build_bands(anchors, ncols: int, anchor_starts, lx, ly,
                expansion: int | None, band_starts):
    """Every pair's band in one call (csrc/host/band.cpp): (offsets,
    widths, frame_widths), or None where construct_band would reject a
    pair's anchors (its caller then runs construct_band to raise).
    anchors: int64 rows of ``ncols`` (x, y[, expansion]) columns, pair i's
    at [anchor_starts[i], anchor_starts[i+1]); expansion None takes each
    anchor's from column 2; pair i's diagonals at band_starts[i]."""
    if not available():
        raise RuntimeError("native library unavailable")
    n = len(lx)
    offsets = np.empty(int(band_starts[-1]), np.int32)
    widths = np.empty(int(band_starts[-1]), np.int32)
    frame = np.empty(n, np.int64)
    rc = _lib.cpecan_build_bands(
        n, anchors, ncols, anchor_starts, lx, ly, int(expansion is None),
        0 if expansion is None else int(expansion), band_starts, offsets,
        widths, frame)
    return None if rc else (offsets, widths, frame)


def alignment_anchors(op_starts, codes, lens, sx, x_starts, sy, y_starts,
                      trim: int, expansion: int):
    """Every alignment's matched anchors in one call (csrc/host/tasks.cpp):
    (anchors, counts, max_gaps), the (N, 3) int64 rows of alignment i the
    counts[i] after those of the alignments before it, and the largest
    gap area around its anchors; or None where an alignment's ops do not
    end at its (lx, ly). Alignment i owns ops [op_starts[i],
    op_starts[i+1]) of the uint8 ``codes`` and int64 ``lens``, and bases
    [x_starts[i], x_starts[i+1]) of the upper-cased uint8 ``sx`` (y
    likewise); ``trim`` >= 0."""
    if not available():
        raise RuntimeError("native library unavailable")
    n = len(x_starts) - 1
    rows = int(np.minimum(np.diff(x_starts), np.diff(y_starts)).sum())
    anchors = np.empty((rows, 3), np.int64)
    counts = np.empty(n, np.int64)
    max_gaps = np.empty(n, np.int64)
    rc = _lib.cpecan_alignment_anchors(
        n, op_starts, codes, lens, sx, x_starts, sy, y_starts, int(trim),
        int(expansion), anchors, counts, max_gaps)
    return None if rc else (anchors[: int(counts.sum())], counts, max_gaps)
