"""Tokenizer construction from GGUF metadata: the Llama 3, Qwen2 /
Qwen2-MoE and Phi-3 branches of llamatpu/tokenizer/builders.py.

GGML token types mark the specials (every type but NORMAL and BYTE); a vocab
without types falls back to Llama 3's rule that ids >= 128000 are special,
or for Phi-3 to ids >= 32000 plus <s>, </s> and <unk> by name. Qwen2 and
Qwen2-MoE split with the Qwen pretokenizer; Phi-3 takes the SentencePiece
BPE with byte fallback (tokenizer/spm.py). The other families' tokenizers
(Mistral's SPM, Qwen3's and the DeepSeek distills' think tokens, the
Granite/Tekken BPE variants) belong to the family-deltas slice of the port.
"""
from __future__ import annotations

from llamatpu_torch.models.config import Family
from llamatpu_torch.tokenizer.bpe import BPETokenizer, llama3_pieces, qwen_pieces
from llamatpu_torch.tokenizer.spm import SPMTokenizer
from llamatpu_torch.tokenizer.vocabulary import Vocabulary


def _specials_from_types(vocab: Vocabulary) -> dict[str, int]:
    if vocab.token_types is None:
        return {}
    out = {}
    for i, t in enumerate(vocab.token_types):
        if int(t) not in (Vocabulary.NORMAL, Vocabulary.BYTE):
            out[vocab.tokens[i]] = i
    return out


_PIECES = {Family.LLAMA_3: llama3_pieces, Family.QWEN_2: qwen_pieces,
           Family.QWEN_2_MOE: qwen_pieces}


def build_tokenizer(family: Family, md: dict) -> BPETokenizer | SPMTokenizer:
    if family not in _PIECES and family != Family.PHI_3:
        raise NotImplementedError(
            f"{family.name} tokenizer: family-deltas slice of the port")
    vocab = Vocabulary.from_metadata(md)
    specials = _specials_from_types(vocab)
    if family == Family.PHI_3:
        if not specials:
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
        tok = BPETokenizer(vocab, merges, specials, pretokenize=_PIECES[family])
    tok.bos_id = int(md.get("tokenizer.ggml.bos_token_id", -1))
    tok.eos_id = int(md.get("tokenizer.ggml.eos_token_id", -1))
    tok.family = family
    return tok
