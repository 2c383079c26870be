"""Tokenizers of the port: the byte-level BPE (Llama 3, Qwen, Granite,
Tekken pretokenizers), the SentencePiece BPE of Mistral and Phi-3, their
vocabulary and the streaming UTF-8 decoder (copies of llamatpu/tokenizer/*,
no `regex`)."""
from llamatpu_torch.tokenizer.bpe import BPETokenizer
from llamatpu_torch.tokenizer.builders import build_tokenizer
from llamatpu_torch.tokenizer.spm import SPMTokenizer
from llamatpu_torch.tokenizer.stream import StreamDecoder
from llamatpu_torch.tokenizer.vocabulary import Vocabulary

__all__ = ["BPETokenizer", "SPMTokenizer", "StreamDecoder", "Vocabulary", "build_tokenizer"]
