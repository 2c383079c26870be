"""Tokenizer construction from GGUF metadata: the Llama 3 branch of
llamatpu/tokenizer/builders.py.

GGML token types mark the specials (every type but NORMAL and BYTE); a vocab
without types falls back to Llama 3's rule that ids >= 128000 are special.
The other families' tokenizers (SPM for Mistral/Phi-3, the Qwen/Granite/
Tekken BPE variants) belong to the family-deltas slice of the port.
"""
from __future__ import annotations

from llamatpu_torch.models.config import Family
from llamatpu_torch.tokenizer.bpe import BPETokenizer
from llamatpu_torch.tokenizer.vocabulary import Vocabulary


def _specials_from_types(vocab: Vocabulary) -> dict[str, int]:
    if vocab.token_types is None:
        return {}
    out = {}
    for i, t in enumerate(vocab.token_types):
        if int(t) not in (Vocabulary.NORMAL, Vocabulary.BYTE):
            out[vocab.tokens[i]] = i
    return out


def build_tokenizer(family: Family, md: dict) -> BPETokenizer:
    if family != Family.LLAMA_3:
        raise NotImplementedError(
            f"{family.name} tokenizer: family-deltas slice of the port")
    vocab = Vocabulary.from_metadata(md)
    specials = _specials_from_types(vocab)
    merges = [str(m) for m in md.get("tokenizer.ggml.merges", [])]
    if not specials and len(vocab) > 128000:
        specials = {vocab.tokens[i]: i for i in range(128000, len(vocab))}
    tok = BPETokenizer(vocab, merges, specials)
    tok.bos_id = int(md.get("tokenizer.ggml.bos_token_id", -1))
    tok.eos_id = int(md.get("tokenizer.ggml.eos_token_id", -1))
    tok.family = family
    return tok
