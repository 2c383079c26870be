"""The native GGUF codecs of the port: csrc/quantops.cpp (a copy of the JAX
package's native/quantops.cpp) built with the host C++ compiler and bound
with ctypes. The port of llamatpu/gguf/native.py.

The library builds into `build/native/` at the repository root (listed in
.gitignore) at first use; the file name carries a hash of the source, the
compiler and the flags, so a changed source rebuilds. A missing compiler or
a failed build raises: the codecs never degrade quietly. LLAMATPU_NO_NATIVE=1
(read at each call) selects the numpy codecs of gguf/quants.py, as in the
JAX package: every entry point then returns None.

Entry points (the JAX package's): `dequant` (Q8_0, Q4_0, Q4_K, Q5_K, Q6_K
blocks to f32), `quantize_q8_0` (the ggml Q8_0 encode), `depack` (Q8_0 /
Q4_0 blocks to int8 values and f32 scales). Each returns what the numpy
codec returns, bit for bit (tests/test_torch_native.py). `calls` counts
the native calls made, so a run can show that a load went through them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "quantops.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fopenmp", "-fPIC", "-shared", "-ffp-contract=off")

_lib = None
_lock = threading.Lock()
calls = 0  # native entry-point calls made by this process


def _compiler() -> str:
    for name in ("g++", "c++", "clang++"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError("no C++ compiler (g++, c++ or clang++ on PATH): the port's native "
                       "GGUF codecs are built from llamatpu_torch/csrc/quantops.cpp at first "
                       "use; LLAMATPU_NO_NATIVE=1 selects the numpy codecs")


def _target(cxx: str) -> Path:
    h = hashlib.sha256(" ".join((cxx, *CXX_FLAGS)).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libquantops-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is not built yet; returns its path. Raises
    on a missing compiler or a failed build."""
    cxx = _compiler()
    target = _target(cxx)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native codec build failed (rc {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
    return target


def _load():
    """The bound library, or None while LLAMATPU_NO_NATIVE=1."""
    global _lib
    if os.environ.get("LLAMATPU_NO_NATIVE") == "1":
        return None
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            u8 = ctypes.POINTER(ctypes.c_uint8)
            i8 = ctypes.POINTER(ctypes.c_int8)
            f32 = ctypes.POINTER(ctypes.c_float)
            i64 = ctypes.c_int64
            for name, argtypes in (
                    ("dequant_q8_0", (u8, i64, f32)),
                    ("dequant_q4_0", (u8, i64, f32)),
                    ("dequant_q4_k", (u8, i64, f32)),
                    ("dequant_q5_k", (u8, i64, f32)),
                    ("dequant_q6_k", (u8, i64, f32)),
                    ("quantize_q8_0", (f32, i64, u8)),
                    ("depack_q8_0", (u8, i64, i8, f32)),
                    ("depack_q4_0", (u8, i64, i8, f32))):
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = None
            _lib = lib
    return _lib


def available() -> bool:
    """True where the native codecs serve the calls (built here if needed);
    False while LLAMATPU_NO_NATIVE=1."""
    return _load() is not None


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _count() -> None:
    global calls
    calls += 1


def dequant(kind: str, raw: np.ndarray, n_blocks: int, block_elems: int) -> np.ndarray | None:
    """f32 [n_blocks * block_elems] of `kind` blocks (q8_0, q4_0, q4_k, q5_k, q6_k)."""
    lib = _load()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    out = np.empty(n_blocks * block_elems, np.float32)
    getattr(lib, f"dequant_{kind}")(_ptr(raw, ctypes.c_uint8), n_blocks,
                                    _ptr(out, ctypes.c_float))
    _count()
    return out


def quantize_q8_0(values: np.ndarray) -> np.ndarray | None:
    """Raw Q8_0 blocks (uint8 [n / 32 * 34]) of f32 values, the ggml encode."""
    lib = _load()
    if lib is None:
        return None
    values = np.ascontiguousarray(values, dtype=np.float32)
    nb = values.size // 32
    out = np.empty(nb * 34, np.uint8)
    lib.quantize_q8_0(_ptr(values, ctypes.c_float), nb, _ptr(out, ctypes.c_uint8))
    _count()
    return out


def depack(kind: str, raw: np.ndarray, n_blocks: int) -> tuple[np.ndarray, np.ndarray] | None:
    """(int8 values [n_blocks, 32], f32 scales [n_blocks]) of q8_0 / q4_0 blocks."""
    lib = _load()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    qs = np.empty((n_blocks, 32), np.int8)
    scales = np.empty(n_blocks, np.float32)
    getattr(lib, f"depack_{kind}")(_ptr(raw, ctypes.c_uint8), n_blocks,
                                   _ptr(qs, ctypes.c_int8), _ptr(scales, ctypes.c_float))
    _count()
    return qs, scales
