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
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = ("quant_matmul", "layer_fused", "ffn_fused", "gemm", "block_matmul", "attention",
           "moe_grouped", "probes", "int8_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# argtypes of every exported function, by library
_SIGNATURES = {
    "quant_matmul": {
        "lt_rowq_gemv": (_P, _I, _P, _P, _P, *(_I,) * 9, _P),
    },
    "layer_fused": {
        "lt_qkv_norm": (_P, _I, _P, _F, _P, _P, _P, _P, _P, *(_I,) * 8, _P),
        "lt_attn_tail": (_P, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _F, _I, _I,
                         _P, _P, _F, _F, *(_P,) * 12, *(_I,) * 15, _P),
        "lt_tail": (_P, _I, _P, _P, _F, _F, *(_P,) * 11, *(_I,) * 17, _P),
        "lt_tail_kt": (_P, _I, _P, _P, _F, _F, *(_P,) * 11, *(_I,) * 18, _P),
    },
    "ffn_fused": {
        "lt_ffn_fused": (_P, _I, *(_P,) * 7, *(_I,) * 11, _P),
    },
    "gemm": {
        "lt_rowq_gemm": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    },
    "block_matmul": {
        "lt_block_matmul": (_P, _I, _P, _P, _P, _P, *(_I,) * 9, _P),
    },
    "attention": {
        "lt_dense_attention": (_P, _I, _P, _I, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                               _P, _I, _I, _P),
        "lt_paged_attention": (_P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                               _P, _I, _I, _P),
        "lt_stripe_attention": (_P, _I, _P, _I, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                _F, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    },
    "moe_grouped": {
        "lt_grouped_matmul": (_I, _P, _I, _P, _I, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                              _I, _P),
    },
    "probes": {
        "lt_probe_gemv": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
        "lt_probe_int8dot": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
        "lt_probe_stream": (_P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P, _P, _P, _I, _P),
    },
    "int8_matmul": {
        "lt_int8_dot": (_P, _I, _P, _P, _P, _P, _P, _L, _L, _P, _I, _I, _I, _I, _P),
    },
}

_libs: dict[str, ctypes.CDLL] = {}
# the serving scheduler launches kernels from its own thread, so the first
# build and load of a library may race another thread's
_load_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels are built from llamatpu_torch/csrc at first use")
    return path


# sources a library includes besides the headers: layer_fused.cu runs
# attention.cu's cluster body in K3
INCLUDES = {"layer_fused": ("attention",)}


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (sorted(CSRC.glob("*.cuh")) + [CSRC / f"{n}.cu" for n in INCLUDES.get(name, ())]
                + [CSRC / f"{name}.cu"]):
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
    """The built library `name`, building it first if needed (thread-safe)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _load_lock:
        if name not in _libs:
            _libs[name] = _load_unlocked(name)
        return _libs[name]


def _load_unlocked(name: str) -> ctypes.CDLL:
    build([name])
    lib = ctypes.CDLL(str(_target(name)))
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    lib.lt_error_string.argtypes = [ctypes.c_int]
    lib.lt_error_string.restype = ctypes.c_char_p
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
