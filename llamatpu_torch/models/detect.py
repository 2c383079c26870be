"""Model family detection from GGUF metadata.

The port's copy of llamatpu/models/detect.py (metadata logic only): the
architecture key "qwen2moe" is authoritative; then general.name substrings;
then metadata-key fallbacks. The general.name heuristic is cross-checked
against structural evidence (architecture + tokenizer model/pre), so a
renamed Mistral/DeepSeek GGUF detects correctly, and a conflicting rename
warns instead of silently picking the wrong tokenizer and chat format.
"""
from __future__ import annotations

import logging

from llamatpu_torch.models.config import Family

log = logging.getLogger(__name__)


def _structural_family(metadata: dict) -> Family | None:
    """Family implied by architecture + tokenizer + rope keys alone
    (ignores general.name, which is free-form and often rewritten)."""
    arch = metadata.get("general.architecture")
    tok_model = metadata.get("tokenizer.ggml.model")       # "gpt2" | "llama"
    tok_pre = str(metadata.get("tokenizer.ggml.pre", "")).lower()
    if arch == "qwen2moe":
        return Family.QWEN_2_MOE
    if arch == "qwen3":
        return Family.QWEN_3
    if arch == "phi3":
        return Family.PHI_3
    if arch == "granite" or "granite.block_count" in metadata:
        return Family.GRANITE
    if arch == "qwen2":
        # DeepSeek-R1 distills keep arch qwen2 but ship their own pretokenizer
        if "deepseek" in tok_pre:
            return Family.DEEPSEEK_R1_DISTILL_QWEN
        return Family.QWEN_2
    if arch == "llama":
        if tok_model == "llama":
            return Family.MISTRAL      # SPM tokenizer => Mistral lineage
        # Tekken BPE => Devstral-2 lineage. NOTE: YaRN rope scaling is
        # deliberately NOT a Devstral signal — any long-context Llama-3
        # GGUF can carry llama.rope.scaling.type == "yarn".
        if "tekken" in tok_pre:
            return Family.DEVSTRAL_2
        return Family.LLAMA_3
    return None


def _name_family(metadata: dict) -> Family | None:
    """The general.name substring heuristic."""
    name = (metadata.get("general.name") or "").lower()
    basename = metadata.get("general.basename") or ""
    if "DeepSeek-R1-Distill-Qwen" in str(basename) or "deepseek r1 distill" in name:
        return Family.DEEPSEEK_R1_DISTILL_QWEN
    if not name:
        return None
    if "granite" in name:
        return Family.GRANITE
    if "devstral" in name:
        return Family.DEVSTRAL_2
    if "mistral" in name:
        return Family.MISTRAL
    if "llama" in name:
        return Family.LLAMA_3
    if "qwen2" in name:
        return Family.QWEN_2
    if "qwen3" in name:
        return Family.QWEN_3
    if "phi3" in name or "phi-3" in name:
        return Family.PHI_3
    return None


def detect_family(metadata: dict) -> Family:
    structural = _structural_family(metadata)
    named = _name_family(metadata)
    if structural is not None and named is not None and structural != named:
        # A Mistral named "...-llama-compatible", a Llama named "mistral-ish":
        # the tensors and tokenizer do not lie; the filename does. One special
        # case trusts the name: DeepSeek distills and Devstral are refinements
        # of their structural base (qwen2 / llama+tekken) that structural
        # evidence may not separate from it.
        refinements = {
            Family.QWEN_2: {Family.DEEPSEEK_R1_DISTILL_QWEN},
            Family.LLAMA_3: {Family.DEVSTRAL_2},
            Family.MISTRAL: {Family.DEVSTRAL_2},
        }
        if named in refinements.get(structural, ()):
            return named
        # The inverse direction: the structural family is a strict refinement
        # of the named base (e.g. a qwen2moe checkpoint named
        # "Qwen1.5-MoE-A2.7B" matches the "qwen2" name substring). The result
        # is right; don't emit the rename-proofing warning.
        base_of = {
            Family.QWEN_2_MOE: {Family.QWEN_2},
            Family.DEEPSEEK_R1_DISTILL_QWEN: {Family.QWEN_2},
        }
        if named in base_of.get(structural, ()):
            return structural
        # Devstral's structural signal (Tekken pretokenizer) is shared with
        # other Mistral-lineage models (e.g. Mistral-Small 3) — when the name
        # claims the base family, trust it: Devstral is the refinement, not
        # the base.
        if structural == Family.DEVSTRAL_2 and named in (
                Family.MISTRAL, Family.LLAMA_3):
            return named
        log.warning(
            "general.name %r suggests %s but architecture/tokenizer metadata "
            "says %s — trusting the structure (rename-proof detection)",
            metadata.get("general.name"), named.name, structural.name)
        return structural
    if named is not None:
        return named
    if structural is not None:
        return structural
    arch = metadata.get("general.architecture")
    raise ValueError(
        f"cannot detect model family (architecture={arch!r}, "
        f"name={metadata.get('general.name')!r})")
