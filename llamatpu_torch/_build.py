"""Build the port's CUDA kernels and bind them with ctypes.

Each `csrc/<name>.cu` compiles with `nvcc -gencode arch=compute_90a,code=sm_90a
-O3 -shared -Xcompiler -fPIC` into its own shared library under
`build/kernels/` at the repository root (listed in .gitignore), at first use.
The file name carries a hash of the sources and flags, so a changed source
rebuilds. The libraries have a plain C interface: no PyTorch headers, so a
build takes seconds. `build()` starts one nvcc per source, all at once.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no nvcc. A missing nvcc or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = ("quant_matmul", "layer_fused", "gemm", "block_matmul", "attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of every exported function, by library
_SIGNATURES = {
    "quant_matmul": {
        "lt_rowq_gemv": (_P, _I, _P, _P, _I, _I, _I, _I, _P),
    },
    "layer_fused": {
        "lt_qkv_norm": (_P, _I, _P, _F, _P, _P, _P, _I, _I, _I, _I, _P),
        "lt_attn_tail": (_P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                         _P, _P, _F, _F, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _P, _I, _I, _I, _P),
    },
    "gemm": {
        "lt_rowq_gemm": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    },
    "block_matmul": {
        "lt_block_matmul": (_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    },
    "attention": {
        "lt_decode_attention": (_P, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I, _F,
                                _P, _P, _P, _I, _P),
    },
}

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels are built from llamatpu_torch/csrc at first use")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES, verbose: bool = False) -> dict[str, str]:
    """Compile the named sources that are not built yet, in parallel.
    Returns {name: compiler output} for what was compiled (with verbose=True
    the output includes ptxas' register and spill report). Raises on a
    failed build."""
    pending = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        pending[name] = (proc, tmp, target)
    logs = {}
    failed = []
    for name, (proc, tmp, target) in pending.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (rc {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library `name`, building it first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    lib = ctypes.CDLL(str(_target(name)))
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    lib.lt_error_string.argtypes = [ctypes.c_int]
    lib.lt_error_string.restype = ctypes.c_char_p
    _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = lib.lt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} at launch ({msg})")


def stream() -> int:
    """The current PyTorch CUDA stream, as the kernels' launch stream."""
    return torch.cuda.current_stream().cuda_stream


def dtype_code(t: torch.Tensor) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"kernel takes f32 or bf16, got {t.dtype}") from None


def require(cond: bool, what: str) -> None:
    """Wrapper argument check (device, dtype, shape, contiguity, alignment)."""
    if not cond:
        raise ValueError(what)
