"""GGUF v2/v3 file reader: header, metadata KV (all value types incl. nested
arrays), tensor infos, alignment, and zero-copy mmap'd tensor data views.

The port's copy of llamatpu/gguf/reader.py: magic "GGUF", version in {2, 3},
u64 tensor/kv counts, typed KV values, tensor infos (name, dims in ggml
order, ggml type, relative offset), `general.alignment` (default 32), the
tensor data section aligned to it. One read-only mmap with numpy views; the
loader depacks blocks into int8/f32 arrays (gguf/quants.py).
"""
from __future__ import annotations

import mmap
import os
import struct
from dataclasses import dataclass
from typing import Any, BinaryIO

import numpy as np

from llamatpu_torch.gguf.ggml_type import GGMLType

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian


class GGUFValueType:
    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


_SCALAR_FMT = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}


@dataclass(frozen=True)
class GGUFTensorInfo:
    name: str
    shape: tuple[int, ...]  # numpy order (outermost first) = reversed ggml ne[]
    ggml_type: GGMLType
    offset: int  # absolute file offset of this tensor's data

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def n_bytes(self) -> int:
        return self.ggml_type.byte_size_for(self.n_elements)


class _Cursor:
    def __init__(self, buf: memoryview):
        self.buf = buf
        self.pos = 0

    def _need(self, n: int, what: str) -> None:
        # every read is bounds-checked so a truncated/corrupt file fails with
        # a diagnosable error instead of struct.error or a short string slice
        if n < 0 or self.pos + n > len(self.buf):
            raise ValueError(
                f"truncated GGUF: need {n} bytes for {what} at offset "
                f"{self.pos}, file has {len(self.buf)}")

    def read(self, fmt: str, what: str = "value"):
        size = struct.calcsize(fmt)
        self._need(size, what)
        (val,) = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += size
        return val

    def read_string(self) -> str:
        n = self.read("<Q", "string length")
        self._need(n, "string")
        s = bytes(self.buf[self.pos : self.pos + n]).decode("utf-8", errors="replace")
        self.pos += n
        return s

    def read_value(self, vtype: int) -> Any:
        if vtype == GGUFValueType.STRING:
            return self.read_string()
        if vtype == GGUFValueType.BOOL:
            return self.read("<B", "bool") != 0
        if vtype == GGUFValueType.ARRAY:
            etype = self.read("<I", "array element type")
            count = self.read("<Q", "array count")
            if etype in _SCALAR_FMT:
                fmt = _SCALAR_FMT[etype]
                size = struct.calcsize(fmt)
                self._need(size * count, "array data")
                arr = np.frombuffer(self.buf, dtype=np.dtype(fmt[1]).newbyteorder("<"),
                                    count=count, offset=self.pos)
                self.pos += size * count
                return arr
            if etype not in (GGUFValueType.STRING, GGUFValueType.BOOL,
                             GGUFValueType.ARRAY):
                raise ValueError(f"unknown GGUF array element type {etype}")
            return [self.read_value(etype) for _ in range(count)]
        fmt = _SCALAR_FMT.get(vtype)
        if fmt is None:
            raise ValueError(f"unknown GGUF value type {vtype}")
        return self.read(fmt)


class GGUFReader:
    """Parses a GGUF file and exposes metadata + zero-copy tensor views."""

    def __init__(self, path: str | os.PathLike):
        self.path = str(path)
        self._file: BinaryIO = open(self.path, "rb")
        self._mmap = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        self._buf = memoryview(self._mmap)
        self.metadata: dict[str, Any] = {}
        self.tensor_infos: dict[str, GGUFTensorInfo] = {}
        self._parse()

    def _parse(self) -> None:
        cur = _Cursor(self._buf)
        magic = cur.read("<I", "magic")
        if magic != GGUF_MAGIC:
            raise ValueError(f"{self.path}: not a GGUF file (magic {magic:#x})")
        version = cur.read("<I", "version")
        if version not in (2, 3):
            # a big-endian GGUF stores the same magic bytes but byte-swapped
            # integers everywhere: detect it via the version field
            if int.from_bytes(struct.pack("<I", version), "big") in (2, 3):
                raise ValueError(
                    f"{self.path}: big-endian GGUF files are not supported")
            raise ValueError(f"unsupported GGUF version {version}")
        self.version = version
        tensor_count = cur.read("<Q", "tensor count")
        kv_count = cur.read("<Q", "kv count")
        for _ in range(kv_count):
            key = cur.read_string()
            vtype = cur.read("<I", f"type of {key!r}")
            self.metadata[key] = cur.read_value(vtype)
        # convenience key for the vocab-size fallback of config_from_metadata
        if "tokenizer.ggml.tokens" in self.metadata:
            self.metadata.setdefault(
                "tokenizer.ggml.tokens.length", len(self.metadata["tokenizer.ggml.tokens"])
            )

        infos = []
        for _ in range(tensor_count):
            name = cur.read_string()
            n_dims = cur.read("<I", f"dims of {name!r}")
            if n_dims > 4:
                raise ValueError(
                    f"tensor {name!r}: {n_dims} dims (ggml max is 4)")
            ne = [cur.read("<Q", f"dim of {name!r}") for _ in range(n_dims)]
            type_id = cur.read("<I", f"type of {name!r}")
            try:
                ggml_type = GGMLType(type_id)
            except ValueError:
                raise ValueError(
                    f"tensor {name!r}: unknown ggml type id {type_id}") from None
            rel_offset = cur.read("<Q", f"offset of {name!r}")
            infos.append((name, tuple(reversed(ne)), ggml_type, rel_offset))

        self.alignment = int(self.metadata.get("general.alignment", 32))
        if self.alignment <= 0 or self.alignment & (self.alignment - 1):
            raise ValueError(
                f"general.alignment {self.alignment} is not a power of two")
        data_start = (cur.pos + self.alignment - 1) // self.alignment * self.alignment
        self.data_start = data_start
        file_size = len(self._buf)
        for name, shape, ggml_type, rel in infos:
            if name in self.tensor_infos:
                raise ValueError(f"duplicate tensor name {name!r}")
            info = GGUFTensorInfo(name, shape, ggml_type, data_start + rel)
            if rel % self.alignment:
                raise ValueError(
                    f"tensor {name!r}: offset {rel} not {self.alignment}-aligned")
            if info.offset + info.n_bytes > file_size:
                raise ValueError(
                    f"tensor {name!r}: data [{info.offset}, "
                    f"{info.offset + info.n_bytes}) exceeds file size {file_size}")
            self.tensor_infos[name] = info

    # -- tensor access -----------------------------------------------------

    def tensor_raw(self, name: str) -> np.ndarray:
        """Raw block bytes of a tensor as a zero-copy uint8 view into the mmap."""
        info = self.tensor_infos[name]
        return np.frombuffer(self._buf, dtype=np.uint8, count=info.n_bytes, offset=info.offset)

    def tensor_f32(self, name: str) -> np.ndarray:
        """Fully dequantized float32 copy shaped like the tensor."""
        from llamatpu_torch.gguf import quants

        info = self.tensor_infos[name]
        return quants.dequantize(info.ggml_type, self.tensor_raw(name),
                                 info.n_elements).reshape(info.shape)

    def close(self) -> None:
        self._buf.release()
        try:
            self._mmap.close()
        except BufferError:
            # numpy views from tensor_raw() may still be alive; the mmap is
            # unmapped when the last view is garbage-collected
            pass
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
