"""Offline GGUF requantization (the port of llamatpu/gguf/convert.py): rewrite
a checkpoint with its matmul weights re-encoded as Q8_0, the persistent form
of the load-time requantization (llama.cpp `quantize`'s role). Metadata passes
through unchanged; a tensor with two or more axes, block-aligned rows
(a multiple of 32) and a non-F32 encoding becomes Q8_0, every other tensor
(norms, biases, F32 weights) is written as F32. The output is byte-identical
to the JAX package's for the same input.
"""
from __future__ import annotations

import numpy as np

from llamatpu_torch.gguf.ggml_type import GGMLType
from llamatpu_torch.gguf.reader import GGUFReader
from llamatpu_torch.gguf.writer import GGUFWriter


def requantize_gguf(src_path: str, dst_path: str, target: str = "q8_0") -> dict:
    """Returns a summary {tensors, requantized, bytes_in, bytes_out}."""
    if target != "q8_0":
        raise ValueError(f"requantize_gguf: target {target!r} (only q8_0)")
    stats = {"tensors": 0, "requantized": 0, "bytes_in": 0, "bytes_out": 0}
    with GGUFReader(src_path) as r:
        w = GGUFWriter(alignment=r.alignment)
        for key, val in r.metadata.items():
            if key == "tokenizer.ggml.tokens.length":  # synthesized by the reader
                continue
            w.add(key, val)
        for name, info in r.tensor_infos.items():
            stats["tensors"] += 1
            stats["bytes_in"] += info.n_bytes
            data = r.tensor_f32(name)
            if data.ndim >= 2 and data.shape[-1] % 32 == 0 and info.ggml_type != GGMLType.F32:
                w.add_tensor(name, data, GGMLType.Q8_0)
                stats["requantized"] += 1
                stats["bytes_out"] += GGMLType.Q8_0.byte_size_for(info.n_elements)
            else:
                w.add_tensor(name, data.astype(np.float32), GGMLType.F32)
                stats["bytes_out"] += info.n_elements * 4
        w.write(dst_path)
    return stats
