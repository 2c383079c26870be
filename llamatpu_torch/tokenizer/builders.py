"""Tokenizer construction from GGUF metadata: the port's copy of
llamatpu/tokenizer/builders.py, for all nine families.

GGML token types mark the specials (every type but NORMAL and BYTE). Mistral
and Phi-3 take the SentencePiece BPE with byte fallback (tokenizer/spm.py);
a vocab without types falls back to ids >= 32000 (Phi-3) plus <s>, </s>
and <unk> found by name. The others take the byte-level BPE with their
family's pretokenizer: Qwen2, Qwen2-MoE, Qwen3 and the DeepSeek-R1 distills
Qwen's, Granite `dbrx` (from tokenizer.ggml.pre) or else `refact` (the Llama
3 pattern), Devstral Tekken (the Llama 3 pattern), Llama 3 its own; a vocab
without types falls back to Llama 3's rule that ids >= 128000 are special.
Qwen3 and the DeepSeek distills take <think> and </think> out of the
specials, so reasoning renders as text (the chat format still finds them
by `vocab.index_of`).
"""
from __future__ import annotations

from llamatpu_torch.models.config import Family
from llamatpu_torch.tokenizer.bpe import (BPETokenizer, granite_dbrx_pieces, llama3_pieces,
                                          qwen_pieces)
from llamatpu_torch.tokenizer.spm import SPMTokenizer
from llamatpu_torch.tokenizer.vocabulary import Vocabulary

_QWEN_PRE = (Family.QWEN_2, Family.QWEN_2_MOE, Family.QWEN_3, Family.DEEPSEEK_R1_DISTILL_QWEN)
_THINKING = (Family.QWEN_3, Family.DEEPSEEK_R1_DISTILL_QWEN)


def _specials_from_types(vocab: Vocabulary) -> dict[str, int]:
    if vocab.token_types is None:
        return {}
    out = {}
    for i, t in enumerate(vocab.token_types):
        if int(t) not in (Vocabulary.NORMAL, Vocabulary.BYTE):
            out[vocab.tokens[i]] = i
    return out


def _pretokenizer(family: Family, md: dict):
    if family in _QWEN_PRE:
        return qwen_pieces
    if family == Family.GRANITE and md.get("tokenizer.ggml.pre", "refact") == "dbrx":
        return granite_dbrx_pieces
    return llama3_pieces  # Llama 3, Granite's refact, Devstral's Tekken


def build_tokenizer(family: Family, md: dict) -> BPETokenizer | SPMTokenizer:
    vocab = Vocabulary.from_metadata(md)
    specials = _specials_from_types(vocab)
    if family in (Family.MISTRAL, Family.PHI_3):
        if not specials:
            if family == Family.PHI_3:
                specials = {vocab.tokens[i]: i for i in range(32000, len(vocab))}
            for name in ("<s>", "</s>", "<unk>"):
                i = vocab.index_of(name)
                if i is not None:
                    specials.setdefault(name, i)
        tok = SPMTokenizer(vocab, specials)
    else:
        merges = [str(m) for m in md.get("tokenizer.ggml.merges", [])]
        if not specials and len(vocab) > 128000:
            specials = {vocab.tokens[i]: i for i in range(128000, len(vocab))}
        if family in _THINKING:
            specials.pop("<think>", None)
            specials.pop("</think>", None)
        tok = BPETokenizer(vocab, merges, specials, pretokenize=_pretokenizer(family, md))
    tok.bos_id = int(md.get("tokenizer.ggml.bos_token_id", -1))
    tok.eos_id = int(md.get("tokenizer.ggml.eos_token_id", -1))
    tok.family = family
    return tok
