"""GGML tensor dtypes (quant formats) with block size / byte size tables.

The port's copy of llamatpu/gguf/ggml_type.py. Supported = F32, F16, BF16,
Q8_0, Q4_0, Q4_K, Q5_K, Q6_K; every other id is a named marker so GGUF files
mentioning them parse but loading raises.
"""
from __future__ import annotations

import enum

QK_K = 256  # super-block size for K-quants


class GGMLType(enum.IntEnum):
    """GGML type ids as stored in GGUF tensor infos."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    IQ2_XXS = 16
    IQ2_XS = 17
    IQ3_XXS = 18
    IQ1_S = 19
    IQ4_NL = 20
    IQ3_S = 21
    IQ2_S = 22
    IQ4_XS = 23
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    IQ1_M = 29
    BF16 = 30

    @property
    def block_size(self) -> int:
        return _BLOCK_SIZE[self]

    @property
    def type_size(self) -> int:
        """Bytes per block."""
        return _TYPE_SIZE[self]

    @property
    def supported(self) -> bool:
        return self in _TYPE_SIZE

    def byte_size_for(self, n_elements: int) -> int:
        ts, bs = self.type_size, self.block_size
        assert n_elements % bs == 0, f"{n_elements} not a multiple of block size {bs}"
        return n_elements // bs * ts

    @property
    def is_quantized(self) -> bool:
        return self not in (GGMLType.F32, GGMLType.F16, GGMLType.BF16)


_BLOCK_SIZE = {
    GGMLType.F32: 1,
    GGMLType.F16: 1,
    GGMLType.BF16: 1,
    GGMLType.Q4_0: 32,
    GGMLType.Q8_0: 32,
    GGMLType.Q4_K: QK_K,
    GGMLType.Q5_K: QK_K,
    GGMLType.Q6_K: QK_K,
    GGMLType.I8: 1,
    GGMLType.I16: 1,
    GGMLType.I32: 1,
    GGMLType.I64: 1,
    GGMLType.F64: 1,
}

_TYPE_SIZE = {
    GGMLType.F32: 4,
    GGMLType.F16: 2,
    GGMLType.BF16: 2,
    GGMLType.Q4_0: 2 + 16,          # f16 scale + 32 nibbles
    GGMLType.Q8_0: 2 + 32,          # f16 scale + 32 int8
    GGMLType.Q4_K: 2 + 2 + 12 + QK_K // 2,        # d, dmin, 6-bit scales, nibbles
    GGMLType.Q5_K: 2 + 2 + 12 + QK_K // 8 + QK_K // 2,  # + high bits
    GGMLType.Q6_K: QK_K // 2 + QK_K // 4 + QK_K // 16 + 2,  # ql, qh, scales, d
    GGMLType.I8: 1,
    GGMLType.I16: 2,
    GGMLType.I32: 4,
    GGMLType.I64: 8,
    GGMLType.F64: 8,
}
