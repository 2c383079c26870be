"""Tokenizers of the port: the Llama 3 byte-level BPE, its vocabulary and the
streaming UTF-8 decoder (copies of llamatpu/tokenizer/*, no `regex`)."""
from llamatpu_torch.tokenizer.bpe import BPETokenizer
from llamatpu_torch.tokenizer.builders import build_tokenizer
from llamatpu_torch.tokenizer.stream import StreamDecoder
from llamatpu_torch.tokenizer.vocabulary import Vocabulary

__all__ = ["BPETokenizer", "StreamDecoder", "Vocabulary", "build_tokenizer"]
