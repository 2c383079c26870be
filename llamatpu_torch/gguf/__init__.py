"""GGUF checkpoints: the port's own reader, writer and block-quant codecs."""
from llamatpu_torch.gguf.ggml_type import GGMLType
from llamatpu_torch.gguf.reader import GGUFReader, GGUFTensorInfo
from llamatpu_torch.gguf.writer import GGUFWriter
from llamatpu_torch.gguf import quants

__all__ = ["GGMLType", "GGUFReader", "GGUFTensorInfo", "GGUFWriter", "quants"]
