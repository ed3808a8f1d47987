"""Build and load the hand-written CUDA kernels (csrc/wavefront.cu).

The source is compiled with nvcc for sm_90a into a shared library with a
plain C interface, at first use, under ``build/cpecan_tpu_torch/`` in the
checkout; the file name carries a hash of the source and flags, so an
edited source builds anew. The library is loaded with ctypes. Nothing
here runs at import time: this module imports on machines without a
CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "wavefront.cu"
BUILD_DIR = _PKG.parent / "build" / "cpecan_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {  # (S, pointers..., B, R, W, k0, stream)
    "cpecan_wavefront_fwd": [_I] + [_P] * 17 + [_I] * 4 + [_P],
    "cpecan_wavefront_bwd": [_I] + [_P] * 29 + [_I] * 4 + [_P],
    "cpecan_wavefront_exp": [_I] + [_P] * 39 + [_I] * 4 + [_P],
    # the wide variants: bwd and exp take one more pointer, the scratch
    "cpecan_wavefront_fwd_wide": [_I] + [_P] * 17 + [_I] * 4 + [_P],
    "cpecan_wavefront_bwd_wide": [_I] + [_P] * 30 + [_I] * 4 + [_P],
    "cpecan_wavefront_exp_wide": [_I] + [_P] * 40 + [_I] * 4 + [_P],
    "cpecan_wavefront_bwd_plan": [_I, _I, _I, _P],  # (S, W, aligned, int[4] out)
    "cpecan_wavefront_exp_plan": [_I, _I, _I, _P],
}


def kernel_structures() -> dict:
    """The transition structures compiled into the kernels, read from the
    source's ``CPECAN_NZ<S>`` X-macro lists: {S: ((class, from, to), ...)}
    in the order the kernels sum them. The source is the one record of
    which transitions the kernels compute."""
    text = SOURCE.read_text()
    out = {}
    for m in re.finditer(r"#define CPECAN_NZ(\d+)\(X\)((?:.*\\\n)*.*)", text):
        out[int(m.group(1))] = tuple(
            tuple(int(v) for v in t)
            for t in re.findall(r"X\((\d+), (\d+), (\d+)\)", m.group(2)))
    return out


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else ""
    if not cand or not os.path.exists(cand):
        raise RuntimeError(
            "nvcc not found (looked on PATH and under CUDA_HOME); the "
            "CUDA kernels cannot be built")
    return cand


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libcpecan_wavefront_{digest}.so"


def build() -> tuple[Path, str]:
    """Compile the kernels if this source has no library yet. Returns the
    library's path and nvcc's diagnostics (per-kernel registers, shared
    memory and spills from -Xptxas -v; empty when nothing was built).
    Raises with nvcc's output when the build fails."""
    path = library_path()
    if path.exists():
        return path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    diagnostics = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{diagnostics}")
    os.replace(tmp, path)  # atomic: concurrent builds race harmlessly
    return path, diagnostics


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()[0]))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.cpecan_cuda_error_string.argtypes = [ctypes.c_int]
            lib.cpecan_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def error_string(err: int) -> str:
    return load().cpecan_cuda_error_string(err).decode()
