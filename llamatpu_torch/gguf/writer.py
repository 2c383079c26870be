"""Minimal GGUF v3 writer (the port's copy of llamatpu/gguf/writer.py).

chip_smoke.py writes its full-width checkpoint with it, and the tests write
tiny ones. Tensor data goes to the file one tensor at a time, so a
checkpoint of a few GB is never assembled in memory.
"""
from __future__ import annotations

import struct
from typing import Any

import numpy as np

from llamatpu_torch.gguf.ggml_type import GGMLType
from llamatpu_torch.gguf.reader import GGUF_MAGIC, GGUFValueType


def _value_type_of(v: Any):
    if isinstance(v, bool):
        return GGUFValueType.BOOL
    if isinstance(v, int):
        return GGUFValueType.INT64 if (v > 0x7FFFFFFF or v < -0x80000000) else GGUFValueType.INT32
    if isinstance(v, float):
        return GGUFValueType.FLOAT32
    if isinstance(v, str):
        return GGUFValueType.STRING
    raise TypeError(f"unsupported metadata value {v!r}")


_FMT = {
    GGUFValueType.UINT8: "<B", GGUFValueType.INT8: "<b", GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h", GGUFValueType.UINT32: "<I", GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f", GGUFValueType.UINT64: "<Q", GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}

_NP_ELEM_TYPE = {
    np.dtype(np.int32): GGUFValueType.INT32,
    np.dtype(np.uint32): GGUFValueType.UINT32,
    np.dtype(np.int64): GGUFValueType.INT64,
    np.dtype(np.float32): GGUFValueType.FLOAT32,
}


class GGUFWriter:
    def __init__(self, alignment: int = 32):
        self.alignment = alignment
        self._kv: list[tuple[str, Any]] = []
        self._tensors: list[tuple[str, tuple[int, ...], GGMLType, Any]] = []

    def add(self, key: str, value: Any) -> None:
        self._kv.append((key, value))

    def add_tensor(self, name: str, array: np.ndarray, ggml_type: GGMLType | None = None) -> None:
        """Add a tensor. `array` is numpy-shaped (outermost dim first); if `ggml_type`
        is a quant format the float array is encoded with the matching codec."""
        from llamatpu_torch.gguf import quants

        if ggml_type is None:
            ggml_type = {np.dtype(np.float32): GGMLType.F32, np.dtype(np.float16): GGMLType.F16}[array.dtype]
        if ggml_type == GGMLType.F32:
            data = np.ascontiguousarray(array, dtype="<f4")
        elif ggml_type == GGMLType.F16:
            data = np.ascontiguousarray(array, dtype="<f2")
        elif ggml_type == GGMLType.Q8_0:
            data = quants.quantize_q8_0(array.reshape(-1))
        elif ggml_type == GGMLType.Q4_0:
            data = quants.quantize_q4_0(array.reshape(-1))
        else:
            raise NotImplementedError(f"writer: {ggml_type!r}")
        self._tensors.append((name, tuple(array.shape), ggml_type, data))

    def add_tensor_raw(self, name: str, shape: tuple[int, ...], ggml_type: GGMLType,
                       raw) -> None:
        """Add pre-encoded block bytes (bytes or a uint8 array)."""
        n = 1
        for d in shape:
            n *= d
        raw = np.frombuffer(raw, np.uint8) if isinstance(raw, (bytes, bytearray)) \
            else np.ascontiguousarray(raw).view(np.uint8).reshape(-1)
        assert raw.size == ggml_type.byte_size_for(n)
        self._tensors.append((name, tuple(shape), ggml_type, raw))

    def _write_str(self, out: bytearray, s: str) -> None:
        b = s.encode("utf-8")
        out += struct.pack("<Q", len(b)) + b

    def _write_value(self, out: bytearray, v: Any) -> None:
        if isinstance(v, (list, tuple, np.ndarray)):
            out += struct.pack("<I", GGUFValueType.ARRAY)
            if isinstance(v, np.ndarray) and v.dtype in _NP_ELEM_TYPE:
                et = _NP_ELEM_TYPE[v.dtype]
                out += struct.pack("<IQ", et, len(v))
                out += v.astype(v.dtype.newbyteorder("<")).tobytes()
                return
            items = list(v)
            if items and isinstance(items[0], str):
                out += struct.pack("<IQ", GGUFValueType.STRING, len(items))
                for s in items:
                    self._write_str(out, s)
            elif items and isinstance(items[0], (int, np.integer)):
                out += struct.pack("<IQ", GGUFValueType.INT32, len(items))
                for x in items:
                    out += struct.pack("<i", int(x))
            elif items and isinstance(items[0], (float, np.floating)):
                out += struct.pack("<IQ", GGUFValueType.FLOAT32, len(items))
                for x in items:
                    out += struct.pack("<f", float(x))
            else:
                out += struct.pack("<IQ", GGUFValueType.INT32, 0)
            return
        vt = _value_type_of(v)
        out += struct.pack("<I", vt)
        if vt == GGUFValueType.STRING:
            self._write_str(out, v)
        elif vt == GGUFValueType.BOOL:
            out += struct.pack("<B", 1 if v else 0)
        else:
            out += struct.pack(_FMT[vt], v)

    def write(self, path: str) -> None:
        if self.alignment & (self.alignment - 1) or self.alignment <= 0:
            raise ValueError(f"alignment {self.alignment} is not a power of two")
        if self.alignment != 32 and not any(k == "general.alignment"
                                            for k, _ in self._kv):
            # readers assume 32 unless the file says otherwise
            self._kv.append(("general.alignment", int(self.alignment)))
        out = bytearray()
        out += struct.pack("<IIQQ", GGUF_MAGIC, 3, len(self._tensors), len(self._kv))
        for k, v in self._kv:
            self._write_str(out, k)
            self._write_value(out, v)
        # tensor infos with running aligned offsets
        offset = 0
        for name, shape, ggml_type, data in self._tensors:
            self._write_str(out, name)
            ne = tuple(reversed(shape))
            out += struct.pack("<I", len(ne))
            for d in ne:
                out += struct.pack("<Q", d)
            out += struct.pack("<IQ", int(ggml_type), offset)
            offset += (data.nbytes + self.alignment - 1) // self.alignment * self.alignment
        out += b"\0" * ((-len(out)) % self.alignment)
        with open(path, "wb") as f:
            f.write(out)
            for _, _, _, data in self._tensors:
                f.write(memoryview(np.ascontiguousarray(data)).cast("B"))
                f.write(b"\0" * ((-data.nbytes) % self.alignment))
