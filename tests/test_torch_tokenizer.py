"""The port's Llama 3 tokenizer, streaming decoder and chat format against the
JAX package's: the hand-written pretokenizer against the `regex` pattern, and
token ids, decoded text and chat-prompt ids equal on every probe text."""
import random

import pytest
import regex
from tiny_models import build_tiny_gguf

from llamatpu.format.chat_format import Message as JMessage
from llamatpu.gguf import GGMLType
from llamatpu.models.loader import load_model as j_load
from llamatpu.tokenizer.adversarial import ADVERSARIAL_TEXTS
from llamatpu.tokenizer.bpe import LLAMA3_PATTERN
from llamatpu.tokenizer.stream import StreamDecoder as JStreamDecoder
from llamatpu_torch.bench.validate import PROBE_TEXTS
from llamatpu_torch.format import Message, Role, build_chat_format
from llamatpu_torch.models.config import Family
from llamatpu_torch.models.loader import load_model
from llamatpu_torch.tokenizer import StreamDecoder, build_tokenizer
from llamatpu_torch.tokenizer.bpe import llama3_pieces

EXTRA = ["", " ", "\n\n\n", "x  ", "x  y", " \t\n \t", "?!\n\n\rx", "a \r\n\r\n b",
         "'S 'LL 'ſ 're", "<|begin_of_text|>hi<|eot_id|>", "tok12 3 <|eot_id|x"]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = tmp_path_factory.mktemp("tok") / "llama.gguf"
    build_tiny_gguf(path, family="llama", quant=GGMLType.F32, seed=0, with_tokenizer=True)
    return load_model(str(path)), j_load(str(path), device_put=False)


def test_pretokenizer_matches_regex_pattern():
    """llama3_pieces == regex.findall(LLAMA3_PATTERN) on the probes and on
    random strings over letters, digits, marks, CJK, emoji, whitespace kinds
    and apostrophes (including the case-folded 'ſ')."""
    pat = regex.compile(LLAMA3_PATTERN)
    rng = random.Random(0)
    alphabet = list(" \t\r\n\x0b\x1c  　'abSTLDſ12345١٢.,!?-_日本é́👩‍🏽")
    texts = PROBE_TEXTS + EXTRA + ["".join(rng.choice(alphabet) for _ in range(rng.randint(1, 24)))
                                   for _ in range(3000)]
    for t in texts:
        assert llama3_pieces(t) == pat.findall(t), repr(t)


@pytest.mark.parametrize("text", PROBE_TEXTS + EXTRA)
def test_token_ids_and_decode_match_jax(models, text):
    tok, jtok = models[0].tokenizer, models[1].tokenizer
    for allowed in ("none", "all"):
        ids = tok.encode(text, allowed_special=allowed)
        assert ids == jtok.encode(text, allowed_special=allowed)
        assert tok.decode(ids) == jtok.decode(ids)
    assert tok.decode(tok.encode(text)) == text


def test_chat_prompt_ids_match_jax(models):
    fmt, jfmt = models[0].chat_format, models[1].chat_format
    for system in (None, "You are terse."):
        for text in ("Why is the sky blue?", "  padded\n", ADVERSARIAL_TEXTS[1]):
            assert fmt.build_prompt([Message(Role.USER, text)], system_prompt=system) == \
                jfmt.build_prompt([JMessage("user", text)], system_prompt=system)
    assert fmt.stop_tokens() == jfmt.stop_tokens()
    assert fmt.begin_of_text() == jfmt.begin_of_text()
    assert (fmt.default_temperature(), fmt.default_top_p()) == (0.3, 0.95) == \
        (jfmt.default_temperature(), jfmt.default_top_p())
    assert fmt.encode_message(Message(Role.ASSISTANT, "ok")) == \
        jfmt.encode_message(JMessage("assistant", "ok"))


def test_stream_decoder_holds_back_partial_utf8(models):
    """Token by token, the port's StreamDecoder releases the same text as the
    JAX package's, holding incomplete UTF-8 sequences until they complete."""
    tok = models[0].tokenizer
    for text in ADVERSARIAL_TEXTS:
        ids = tok.encode(text)
        sd, jsd = StreamDecoder(tok), JStreamDecoder(models[1].tokenizer)
        got = [sd.push(t) for t in ids] + [sd.flush()]
        assert got == [jsd.push(t) for t in ids] + [jsd.flush()]
        assert "".join(got) == text
        assert all("�" not in g for g in got)


def test_other_families_raise_naming_the_slice(models):
    md = models[0].metadata
    with pytest.raises(NotImplementedError, match="family-deltas"):
        build_tokenizer(Family.MISTRAL, md)
    with pytest.raises(NotImplementedError, match="family-deltas"):
        build_chat_format(Family.QWEN_3, models[0].tokenizer)
