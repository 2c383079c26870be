"""The five families of slice 22 (DeepSeek-R1-distill-Qwen, Qwen3, Mistral,
Devstral 2, Granite) in the port on the CPU against the JAX package:
`validate` reproduces the ten committed goldens; each family's tokenizer on
the adversarial corpus, Granite's `dbrx` pretokenizer against `regex`; the
chat formats' token lists (dialogs, Mistral's tool and fill-in-the-middle
tokens, Qwen3 with thinking on and off, DeepSeek's primer) and the served
prompts; YaRN tables at Devstral's geometry; the Qwen3 forward (q/k norm,
q width != dim) and its Engine, BatchEngine and speculative windows; `run`
on each tiny GGUF. No kernel launch is counted on the CPU."""
import json
import pathlib
import random

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import regex
import torch
from tiny_models import build_tiny_gguf

import llamatpu.ops.layer_fused as jlf
from llamatpu.format.chat_format import Message as JMessage
from llamatpu.format.tool_parser import ToolCall as JToolCall
from llamatpu.gguf import GGMLType
from llamatpu.gguf import quants as jq
from llamatpu.models import loader as jloader
from llamatpu.models import transformer as jtr
from llamatpu.models.config import Family as JFamily
from llamatpu.models.synthetic import PRESETS as J_PRESETS
from llamatpu.models.synthetic import build_synthetic_model as j_build
from llamatpu.models.weights import serving_weights as j_serving
from llamatpu.ops.rope import precompute_rope_tables as j_rope_tables
from llamatpu.runtime.batch_engine import BatchEngine as JBatchEngine
from llamatpu.runtime.engine import Engine as JEngine
from llamatpu.server import service as jservice
from llamatpu.tokenizer import build_tokenizer as j_build_tokenizer
from llamatpu.tokenizer.adversarial import ADVERSARIAL_TEXTS
from llamatpu.tokenizer.bpe import GRANITE_DBRX_PATTERN
from llamatpu_torch import cli
from llamatpu_torch.bench.validate import PROBE_TEXTS
from llamatpu_torch.format import Message, build_chat_format
from llamatpu_torch.format.tool_parser import ToolCall
from llamatpu_torch.gguf import quants
from llamatpu_torch.gguf.ggml_type import GGMLType as TGGMLType
from llamatpu_torch.models import transformer as ttr
from llamatpu_torch.models.config import Family, ModelConfig
from llamatpu_torch.models.loader import config_from_metadata, load_model
from llamatpu_torch.models.synthetic import PRESETS
from llamatpu_torch.models.synthetic import build_synthetic_model as t_build
from llamatpu_torch.models.weights import from_numpy_weights, fuse_layer_weights
from llamatpu_torch.ops import attention, layer_fused, quant_matmul
from llamatpu_torch.ops.rope import precompute_rope_tables
from llamatpu_torch.runtime import session
from llamatpu_torch.runtime.batch_engine import BatchEngine
from llamatpu_torch.runtime.engine import Engine
from llamatpu_torch.server import service
from llamatpu_torch.tokenizer import build_tokenizer
from llamatpu_torch.tokenizer.bpe import granite_dbrx_pieces

GOLDEN = pathlib.Path(__file__).resolve().parents[1] / "fixtures" / "golden"
FAMILIES = ("deepseek", "qwen3", "mistral", "devstral", "granite")
FAMILY = {"deepseek": "DEEPSEEK_R1_DISTILL_QWEN", "qwen3": "QWEN_3", "mistral": "MISTRAL",
          "devstral": "DEVSTRAL_2", "granite": "GRANITE"}
# Qwen3-0.6B shrunk: q width 512 != dim 256, head 128, GQA 2
QWEN3 = dict(dim=256, hidden_dim=512, n_heads=4, n_kv_heads=2, head_dim=128, vocab_size=300)
WRAPPERS = (quant_matmul.block_matmul, quant_matmul.rowq_gemv, layer_fused.qkv_norm_fused_rowq,
            layer_fused.layer_attn_tail_fused_rowq, layer_fused.layer_tail_fused_rowq,
            attention.decode_attention_fused_write)
DIALOG = [("system", "You are terse."), ("user", "Why is the sky blue?"),
          ("assistant", "  Rayleigh scattering.\n"), ("user", ADVERSARIAL_TEXTS[1])]
MISTRAL_TOOL_TOKENS = ["[INST]", "[/INST]", "[TOOL_CALLS]", "[AVAILABLE_TOOLS]",
                       "[/AVAILABLE_TOOLS]", "[TOOL_RESULTS]", "[/TOOL_RESULTS]", "[PREFIX]",
                       "[SUFFIX]", "[MIDDLE]"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small torch ops on one intra-op thread: the test workers and the JAX
    compiler share the CPU cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    d = tmp_path_factory.mktemp("families")
    out = {}
    for fam in FAMILIES:
        for name, q in (("q8_0", GGMLType.Q8_0), ("q4_0", GGMLType.Q4_0)):
            out[f"{fam}_{name}"] = d / f"{fam}_{name}.gguf"
            build_tiny_gguf(out[f"{fam}_{name}"], family=fam, quant=q, seed=0,
                            with_tokenizer=True)
    return out


@pytest.fixture(scope="module")
def models(ggufs):
    """(port, JAX) models of each family's Q8_0 GGUF, tokenizer and format
    loaded."""
    return {fam: (load_model(str(ggufs[f"{fam}_q8_0"]), param_dtype=torch.float32),
                  jloader.load_model(str(ggufs[f"{fam}_q8_0"]), param_dtype=jnp.float32,
                                     device_put=False))
            for fam in FAMILIES}


# ------------------------------------------------------------ goldens
@pytest.mark.parametrize("quant", ["q8_0", "q4_0"])
@pytest.mark.parametrize("fam", FAMILIES)
def test_validate_reproduces_the_jax_goldens(ggufs, fam, quant, capsys):
    """fixtures/golden/<family>_<quant>.json hold the JAX CLI's f32 `validate`
    results: the port reproduces the greedy ids exactly and the quick ppl
    within 1%."""
    name = f"{fam}_{quant}"
    rc = cli.main(["validate", "-m", str(ggufs[name]), "--dtype", "f32", "--device", "cpu",
                   "--golden", str(GOLDEN / f"{name}.json")])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "[PASS] golden-tokens" in out and "[PASS] golden-ppl" in out
    assert f"family={FAMILY[fam]}" in out


# ------------------------------------------------------------ tokenizers
def _same_tokenizer(tok, jtok, texts):
    for text in texts:
        for allowed in ("none", "all"):
            ids = tok.encode(text, allowed_special=allowed)
            assert ids == jtok.encode(text, allowed_special=allowed), repr(text)
            assert tok.decode(ids) == jtok.decode(ids)
    assert tok.special_tokens == jtok.special_tokens
    assert (tok.bos_id, tok.eos_id) == (jtok.bos_id, jtok.eos_id)
    n = len(tok.vocabulary)
    assert [tok.is_special(i) for i in range(n)] == [jtok.is_special(i) for i in range(n)]
    assert [tok.decode_token_bytes(i) for i in range(n)] == \
        [jtok.decode_token_bytes(i) for i in range(n)]


@pytest.mark.parametrize("fam", FAMILIES)
def test_tokenizer_matches_jax(models, fam):
    """Ids and decoded text on the adversarial corpus and the probes, with
    and without specials; the special sets, BOS / EOS and every token's
    bytes. Qwen3 and DeepSeek render <think> / </think> as text, yet the
    vocabulary still finds them."""
    tm, jm = models[fam]
    specials = list(tm.tokenizer.special_tokens)
    texts = ADVERSARIAL_TEXTS + PROBE_TEXTS + ["".join(specials) + " x<think>\ny</think>"]
    _same_tokenizer(tm.tokenizer, jm.tokenizer, texts)
    if fam in ("qwen3", "deepseek"):
        voc = tm.tokenizer.vocabulary
        assert "<think>" not in tm.tokenizer.special_tokens
        assert voc.index_of("<think>") is not None and voc.index_of("</think>") is not None


def test_granite_dbrx_tokenizer_matches_jax(models):
    """tokenizer.ggml.pre = "dbrx" selects Granite's dbrx pretokenizer in
    both packages (numbers of 1-3 digits, contractions in ASCII case)."""
    md = dict(models["granite"][0].metadata, **{"tokenizer.ggml.pre": "dbrx"})
    tok, jtok = build_tokenizer(Family.GRANITE, md), j_build_tokenizer(JFamily.GRANITE, md)
    assert tok.pretokenize is granite_dbrx_pieces
    _same_tokenizer(tok, jtok, ADVERSARIAL_TEXTS + ["'S 'LL 'ſ 1234567 x12y"])


def test_granite_dbrx_pieces_match_regex_pattern():
    """granite_dbrx_pieces == regex.findall(GRANITE_DBRX_PATTERN) on the
    probes, the adversarial corpus and 3000 random strings."""
    pat = regex.compile(GRANITE_DBRX_PATTERN)
    rng = random.Random(2)
    alphabet = list(" \t\r\n\x0b\x1c  　'abSTLDſ12345١٢.,!?-_日本é́👩‍🏽")
    texts = PROBE_TEXTS + ADVERSARIAL_TEXTS + [
        "".join(rng.choice(alphabet) for _ in range(rng.randint(1, 24))) for _ in range(3000)]
    for t in texts:
        assert granite_dbrx_pieces(t) == pat.findall(t), repr(t)
    assert granite_dbrx_pieces("'S 'ſ 12345") == ["'S", " '", "ſ", " ", "123", "45"]


# ------------------------------------------------------------ chat formats
@pytest.mark.parametrize("fam", FAMILIES)
def test_chat_format_tokens_match_jax(models, fam):
    """A dialog with and without its system turn, the bare assistant header,
    Qwen3's thinking control on and off and DeepSeek's <think> primer, the
    stop tokens, begin-of-text policy, sampling defaults and capabilities."""
    tm, jm = models[fam]
    fmt, jfmt = tm.chat_format, jm.chat_format
    assert type(fmt).__name__ == type(jfmt).__name__
    msgs = [Message(r, c) for r, c in DIALOG[1:]]
    jmsgs = [JMessage(r, c) for r, c in DIALOG[1:]]
    for system in (None, DIALOG[0][1]):
        for header in (True, False):
            got = fmt.build_prompt(msgs, append_assistant_header=header, system_prompt=system)
            assert got == jfmt.build_prompt(jmsgs, append_assistant_header=header,
                                            system_prompt=system)
    for role in ("user", "assistant", "system"):
        assert fmt.encode_header(Message(role, "")) == jfmt.encode_header(JMessage(role, ""))
    for on in (True, False):
        assert fmt.encode_thinking_control(on) == jfmt.encode_thinking_control(on)
    for attr in ("add_begin_of_text", "add_system_prompt", "include_reasoning"):
        assert getattr(fmt, attr) == getattr(jfmt, attr)
    assert fmt.begin_of_text() == jfmt.begin_of_text()
    assert fmt.stop_tokens() == jfmt.stop_tokens()
    assert (fmt.default_temperature(), fmt.default_top_p()) == \
        (jfmt.default_temperature(), jfmt.default_top_p())
    assert fmt.supports_thinking() == jfmt.supports_thinking() == (fam == "qwen3")
    assert fmt.supports_tool_calling() == jfmt.supports_tool_calling()
    if fam == "qwen3":
        off = fmt.encode_thinking_control(False)
        voc = tm.tokenizer.vocabulary
        assert off[0] == voc.index_of("<think>") and voc.index_of("</think>") in off
        assert fmt.encode_thinking_control(True) == []
    if fam == "deepseek":
        prompt = fmt.build_prompt(msgs, system_prompt=DIALOG[0][1])
        primer = tm.tokenizer.encode("<think>\n", allowed_special="all")
        assert prompt[-len(primer):] == primer
        assert tm.tokenizer.decode(primer) == "<think>\n"
        assert tm.tokenizer.special_tokens["<｜User｜>"] in prompt


def _mistral_with_tool_tokens(md):
    """The tiny Mistral vocab plus the control tokens of a real Mistral
    tokenizer ([INST], [TOOL_CALLS], [AVAILABLE_TOOLS], ...)."""
    md = dict(md)
    n = len(MISTRAL_TOOL_TOKENS)
    md["tokenizer.ggml.tokens"] = list(md["tokenizer.ggml.tokens"]) + MISTRAL_TOOL_TOKENS
    md["tokenizer.ggml.scores"] = np.concatenate([np.asarray(md["tokenizer.ggml.scores"]),
                                                  np.zeros(n, np.float32)])
    md["tokenizer.ggml.token_type"] = np.concatenate(
        [np.asarray(md["tokenizer.ggml.token_type"]), np.full(n, 3, np.int32)])
    return md


@pytest.mark.parametrize("fam", ["mistral", "devstral"])
def test_mistral_tools_and_fim_match_jax(models, fam):
    """Mistral's [AVAILABLE_TOOLS] block, [TOOL_CALLS] assistant turn,
    [TOOL_RESULTS] turn and fill-in-the-middle, on a vocab with the control
    tokens (Mistral's SPM) and without them (Devstral's tiny Tekken vocab:
    <unk> stands in, tools unsupported); a [TOOL_CALLS] answer parses as in
    the JAX package."""
    tm, jm = models[fam]
    if fam == "mistral":
        md = _mistral_with_tool_tokens(tm.metadata)
        fmt = build_chat_format(Family.MISTRAL, build_tokenizer(Family.MISTRAL, md))
        from llamatpu.format import build_chat_format as j_build_chat_format

        jfmt = j_build_chat_format(JFamily.MISTRAL, j_build_tokenizer(JFamily.MISTRAL, md))
        assert fmt.supports_tool_calling()
        assert fmt.encode_header(Message("user", ""))[0] == fmt.tokenizer.special_tokens["[INST]"]
    else:
        fmt, jfmt = tm.chat_format, jm.chat_format
        assert not fmt.supports_tool_calling()
    assert fmt.supports_tool_calling() == jfmt.supports_tool_calling()
    tools = json.dumps([{"type": "function", "function": {"name": "get_weather"}}])
    assert fmt.encode_available_tools(tools) == jfmt.encode_available_tools(tools)
    calls = [ToolCall("get_weather", '{"city": "Paris"}', "c0"), ToolCall("t", "{}", "c1")]
    jcalls = [JToolCall("get_weather", '{"city": "Paris"}', "c0"), JToolCall("t", "{}", "c1")]
    assert fmt.encode_tool_call_assistant_turn(calls) == \
        jfmt.encode_tool_call_assistant_turn(jcalls)
    assert fmt.encode_tool_result_turn("c0", "get_weather", '{"t": 21}') == \
        jfmt.encode_tool_result_turn("c0", "get_weather", '{"t": 21}')
    assert fmt.encode_fill_in_the_middle("def f(x):\n", "\n    return y") == \
        jfmt.encode_fill_in_the_middle("def f(x):\n", "\n    return y")
    for text in ('[TOOL_CALLS][{"name": "get_weather", "arguments": {"city": "Oslo"}}]',
                 '[{"name": "a", "arguments": {}}, {"name": "b", "arguments": {"x": 1}}]',
                 '{"name": "get_weather", "arguments": {"city": "Oslo"}}'):
        got = [(c.name, c.arguments_json) for c in fmt.extract_all_tool_calls(text)]
        assert got == [(c.name, c.arguments_json) for c in jfmt.extract_all_tool_calls(text)]
    assert got == [("get_weather", '{"city": "Oslo"}')]


@pytest.mark.parametrize("fam", FAMILIES)
def test_served_prompts_match_the_jax_service(models, fam):
    """The server's prompt ids for a chat request (system turn, a tool
    request where the family takes tools) equal the JAX service's: the
    DeepSeek primer, Qwen3's ChatML, Mistral's and Granite's turns."""
    tm, jm = models[fam]
    msgs = [{"role": r, "content": c} for r, c in DIALOG]
    tools = json.dumps([{"type": "function", "function": {"name": "f", "parameters": {}}}])
    for tools_json in (None, tools):
        req = service.Request(messages=msgs, tools_json=tools_json)
        jreq = jservice.Request(messages=msgs, tools_json=tools_json)
        assert service.encode_request(tm, req) == jservice.encode_request(jm, jreq)
        assert service.stop_tokens_for(tm, req) == jservice.stop_tokens_for(jm, jreq)


# ------------------------------------------------------------ YaRN
def test_yarn_tables_match_jax_at_devstral_geometry(models):
    """Devstral's YaRN tables: the tiny golden's metadata, and the
    devstral-small-2 preset's geometry (head 128, theta 1e9) under a YaRN
    factor of 16 over an original context of 4096 (with the tiny GGUF's
    beta 32 / 1 and log multiplier 1), at a 16384-row table."""
    tm, jm = models["devstral"]
    assert tm.cfg.rope_scaling == "yarn" and tm.cfg.rope_scale_factor == 2.0
    assert config_from_metadata(Family.DEVSTRAL_2, tm.metadata) == tm.cfg
    for got, want in zip(precompute_rope_tables(tm.cfg), j_rope_tables(jm.cfg)):
        assert np.array_equal(got, want)
    yarn = dict(context_length=16384, rope_scaling="yarn", rope_scale_factor=16.0,
                rope_original_context=4096, yarn_beta_fast=32.0, yarn_beta_slow=1.0,
                yarn_log_multiplier=1.0)
    kw = dict(PRESETS["devstral-small-2"], **yarn)
    jkw = dict(J_PRESETS["devstral-small-2"], **yarn)
    from llamatpu.models.config import ModelConfig as JModelConfig

    for got, want in zip(precompute_rope_tables(ModelConfig(**kw)),
                         j_rope_tables(JModelConfig(**jkw))):
        assert got.shape == (16384, 64) and np.array_equal(got, want)


# ------------------------------------------------------------ Qwen3 forward
def _qwen3(quant="q8_0", seed=5):
    """The shrunk Qwen3 preset in both packages, with the same random q/k
    norm weights (the presets draw ones)."""
    kw = dict(n_layers=2, dtype="f32", seed=seed, context_length=256, overrides=QWEN3,
              quant=quant)
    tm, jm = t_build("qwen3-0.6b", **kw), j_build("qwen3-0.6b", **kw)
    rng = np.random.default_rng(seed)
    for key in ("q_norm", "k_norm"):
        w = (1.0 + 0.3 * rng.normal(size=(2, QWEN3["head_dim"]))).astype(np.float32)
        tm.weights["layers"][key] = w
        jm.weights["layers"][key] = w.copy()
    assert tm.cfg.qk_norm and tm.cfg.q_dim == 512 != tm.cfg.dim
    return tm, jm


@pytest.mark.parametrize("rowq,t", [(False, 128), (True, 32)])
def test_qwen3_forward_prefill_and_decode_match_jax(rowq, t):
    """A prefill, then two decode steps, on the JAX package's own served
    weights (the q/k norm stacked as the port's load does): logits and
    cache against forward_tokens(impl="pallas"), f32, rtol = atol = 5e-4.
    Q8_0 weights: a 128-row prefill and decode through K5 and K6. q8_row: a
    32-row prefill (K1) and decode through K2, the q/k norm and K3. The
    q8_row prefill from 128 rows (K4) is held by the two tests after the
    next one."""
    tm, jm = _qwen3()
    cfg = tm.cfg
    jw = j_serving(jm.cfg, jm.weights, rowq=rowq)
    tw = fuse_layer_weights(cfg, from_numpy_weights(jax.device_get(jw)))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, t))
    cache = ttr.init_cache(cfg, 1, torch.float32, device="cpu")
    jcache = jtr.init_cache(jm.cfg, 1, jnp.float32)
    logits, cache = ttr.forward_tokens(cfg, tw, torch.from_numpy(toks), cache, 0)
    jlogits, jcache = jtr.forward_tokens(jm.cfg, jw, jnp.asarray(toks, jnp.int32), jcache, 0,
                                         impl="pallas")
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(cache.kv.numpy(), np.asarray(jcache.kv), rtol=5e-4, atol=5e-4)
    for pos, tok in ((t, 17), (t + 1, 3)):
        logits2, cache = ttr.forward_tokens(cfg, tw, torch.tensor([[tok]]), cache, pos,
                                            last_logit_only=True)
        jlogits2, jcache = jtr.forward_tokens(jm.cfg, jw, jnp.asarray([[tok]], jnp.int32), jcache,
                                              pos, impl="pallas", last_logit_only=True)
        np.testing.assert_allclose(logits2.numpy(), np.asarray(jlogits2), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(cache.kv.numpy(), np.asarray(jcache.kv), rtol=5e-4, atol=5e-4)


def test_qwen3_qk_norm_is_per_head_rmsnorm():
    """The load stacks q_norm and k_norm into qk_norm [L, H + KV, hd]; the
    joint norm of the q and k heads with it equals rmsnorm of q with q_norm
    and of k with k_norm apart."""
    tm, _ = _qwen3()
    lw = fuse_layer_weights(tm.cfg, tm.weights)["layers"]
    assert "q_norm" not in lw and "k_norm" not in lw and lw["qk_norm"].shape == (2, 6, 128)
    qn, kn = (torch.as_tensor(tm.weights["layers"][k]) for k in ("q_norm", "k_norm"))
    x = torch.randn(1, 3, 6, 128)
    joint = ttr.rmsnorm(x, torch.as_tensor(lw["qk_norm"][1]), 1e-6)
    torch.testing.assert_close(joint[:, :, :4], ttr.rmsnorm(x[:, :, :4], qn[1], 1e-6),
                               rtol=0, atol=0)
    torch.testing.assert_close(joint[:, :, 4:], ttr.rmsnorm(x[:, :, 4:], kn[1], 1e-6),
                               rtol=0, atol=0)


def _k4_inputs(monkeypatch):
    """Record, in call order, every activation the q8_row prefill quantizes
    to int8 for K4, and its int8 rows, in the port ([(x, xi8)]) and in the
    JAX package (through a debug callback: its layers run inside a scan)."""
    import llamatpu.ops.int8_prefill as jip

    from llamatpu_torch.ops import matmul as tmatmul

    port, ref = [], []
    tq, jq8 = tmatmul.quantize_activation_rows, jip.quantize_activation_rows

    def t_rec(x2):
        xi8, ax = tq(x2)
        port.append((x2.float().numpy().copy(), xi8.numpy().copy()))
        return xi8, ax

    def j_rec(x2):
        xi8, ax = jq8(x2)
        jax.debug.callback(lambda a, b: ref.append((np.asarray(a, np.float32), np.asarray(b))),
                           x2, xi8, ordered=True)
        return xi8, ax

    monkeypatch.setattr(tmatmul, "quantize_activation_rows", t_rec)
    monkeypatch.setattr(jip, "quantize_activation_rows", j_rec)
    return port, ref


def test_qwen3_q8_row_128_rows_differ_from_jax_only_at_int8_ties(monkeypatch):
    """Why the 128-row q8_row prefill is not held at 5e-4 in logits: K4
    quantizes each projection's input rows to int8, and the port's f32
    inputs differ from the JAX package's by a few ulps where the two sum in
    another order (here the attention output). An input whose value lies
    within that of a half int8 step rounds to the next step on one side
    (with this seed: layer 0's wo input, row 66, at 0.49999794 of a step in
    the port and past 0.5 in JAX), and the random weights carry the step
    into the next layer's cache rows and every later row's logits. Held
    here: every K4 input up to and including the first that rounds apart
    agrees within 2e-6, its int8 rows differ only at values within 1e-4 of
    a half step, and the layer-0 wqkv rows are the same int8 values."""
    tm, jm = _qwen3()
    cfg = tm.cfg
    jw = j_serving(jm.cfg, jm.weights, rowq=True)
    tw = fuse_layer_weights(cfg, from_numpy_weights(jax.device_get(jw)))
    port, ref = _k4_inputs(monkeypatch)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 128))
    ttr.forward_tokens(cfg, tw, torch.from_numpy(toks), ttr.init_cache(cfg, 1, torch.float32,
                                                                         device="cpu"), 0)
    jax.block_until_ready(jtr.forward_tokens(jm.cfg, jw, jnp.asarray(toks, jnp.int32),
                                             jtr.init_cache(jm.cfg, 1, jnp.float32), 0,
                                             impl="pallas"))
    jax.effects_barrier()
    assert len(port) == len(ref) == 4 * cfg.n_layers + 1  # wqkv, wo, w13, w2 a layer; head
    assert np.array_equal(port[0][1], ref[0][1])
    for (x, q), (jx, jq_) in zip(port, ref):
        np.testing.assert_allclose(x, jx, rtol=0, atol=2e-6)
        apart = q != jq_
        if apart.any():
            s = np.abs(x * 127.0 / np.abs(x).max(axis=-1, keepdims=True))[apart]
            assert np.abs(s - np.floor(s) - 0.5).max() < 1e-4, s
            assert np.abs(q.astype(int) - jq_.astype(int)).max() == 1
            break


def test_qwen3_q8_row_prefill_chunk_of_128_matches_jax(monkeypatch):
    """The q8_row prefill through K4 (two chunks of 128, the second padded),
    then decode windows: the greedy ids of Engine equal the JAX Engine's
    (impl="pallas"); 16 K4 calls (2 chunks x 2 layers x 4 projections)."""
    from llamatpu_torch.ops import matmul as tmatmul

    tm, jm = _qwen3()
    calls = []
    real = tmatmul.rowq_gemm

    def count(qs, s, xi8, ax):
        calls.append(xi8.shape[0])
        return real(qs, s, xi8, ax)

    prompt = [(7 * i + 3) % 300 for i in range(130)]
    kw = dict(cache_len=256, prefill_chunk=128, decode_window=4, rowq=True)
    je = JEngine(jm, impl="pallas", cache_dtype=jnp.float32, aot_compile=False, **kw)
    te = Engine(tm, cache_dtype=torch.float32, device="cpu", **kw)
    monkeypatch.setattr(tmatmul, "rowq_gemm", count)
    assert te.generate(prompt, 10).tokens == je.generate(prompt, 10).tokens
    assert calls == [128] * 16


PROMPTS = [[(7 * i + 3) % 300 for i in range(n)] for n in (5, 21, 40)]
REPETITIVE = [7, 8, 9, 7, 8, 9, 7, 8, 9, 7, 8]


@pytest.mark.parametrize("rowq", [True, False])
def test_qwen3_engine_windows_match_jax(rowq):
    """Prefill chunks of 16 (the last padded), decode windows of 4: the
    greedy ids of Engine equal the JAX Engine's (impl="pallas"), q8_row (K2
    + K3) and Q8_0 (K5 + K6)."""
    tm, jm = _qwen3()
    kw = dict(cache_len=128, prefill_chunk=16, decode_window=4, rowq=rowq)
    je = JEngine(jm, impl="pallas", cache_dtype=jnp.float32, aot_compile=False, **kw)
    te = Engine(tm, cache_dtype=torch.float32, device="cpu", **kw)
    assert te.generate(PROMPTS[2], 10).tokens == je.generate(PROMPTS[2], 10).tokens
    assert all(f.launches == 0 for f in WRAPPERS)


def test_qwen3_batch_engine_windows_match_jax():
    """Three prompts on four lanes (one parked), q8_row: the token lists of
    BatchEngine equal the JAX BatchEngine's."""
    tm, jm = _qwen3()
    kw = dict(batch_size=4, cache_len=128, prefill_chunk=16, decode_window=4, rowq=True)
    je = JBatchEngine(jm, impl="pallas", cache_dtype=jnp.float32, **kw)
    te = BatchEngine(tm, cache_dtype=torch.float32, device="cpu", **kw)
    assert te.generate_batch(PROMPTS, 8) == je.generate_batch(PROMPTS, 8)


@pytest.mark.parametrize("prompt", [PROMPTS[1], REPETITIVE])
def test_qwen3_spec_decode_window_matches_jax(prompt):
    """Prompt-lookup speculative decoding (K = 3) through the verify forward
    at T = 4: the greedy ids equal the JAX Engine's."""
    tm, jm = _qwen3()
    kw = dict(cache_len=128, prefill_chunk=16, decode_window=6, rowq=True, spec_decode=3)
    je = JEngine(jm, impl="pallas", cache_dtype=jnp.float32, aot_compile=False, **kw)
    te = Engine(tm, cache_dtype=torch.float32, device="cpu", **kw)
    assert te.generate(prompt, 24).tokens == je.generate(prompt, 24).tokens


# ------------------------------------------------------------ run
@pytest.mark.parametrize("fam", FAMILIES)
def test_run_streams_text(ggufs, fam, capsys, monkeypatch):
    """`run --device cpu` on each tiny GGUF exits 0 and streams text;
    DeepSeek's answer opens with its <think> primer; --no-thinking reaches
    the session as enable_thinking=False."""
    seen = []
    real = session.run_instruct_once

    def spy(*a, **k):
        seen.append(k["enable_thinking"])
        return real(*a, **k)

    monkeypatch.setattr(session, "run_instruct_once", spy)
    for extra in ([], ["--no-thinking"]):
        rc = cli.main(["run", "-m", str(ggufs[f"{fam}_q8_0"]), "-p", "hello", "--device", "cpu",
                       "-n", "48", "--seed", "3", "--metrics-format", "none"] + extra)
        out = capsys.readouterr().out
        assert rc == 0 and len(out.strip()) > 0
        if fam == "deepseek":
            assert out.startswith("<think>\n")
    assert seen == [True, False]


# ------------------------------------------------------------ the card paths' choices
@pytest.mark.parametrize("preset", ["qwen3-0.6b", "granite-3.2-2b"])
def test_decode_takes_k3_where_the_jax_fit_does(preset):
    """chip_smoke's Qwen3-0.6B path (and Granite-3.2-2b's geometry) at one
    lane, a 1024-row cache (1152 physical) in bf16: the port's fit of K3
    equals the JAX package's `_fit_attn_tail`, and both take it."""
    p = PRESETS[preset]
    d, f, kvh, hd = p["dim"], p["hidden_dim"], p["n_kv_heads"], p["head_dim"]
    hdim, g = p["n_heads"] * hd, p["n_heads"] // kvh
    s_len = ttr.physical_cache_len(1024, 512)
    assert s_len == 1152
    args = (1, d, hdim, 2 * f, f, kvh, g, 2 * hd, s_len, 2, 2)
    assert layer_fused._fit_attn_tail(*args) == jlf._fit_attn_tail(*args) is not None
    assert layer_fused.attn_tail_fits(d, hdim, f, kvh, g, hd, s_len, 2, 2)


@pytest.mark.parametrize("fam", ["llama", "mistral", "devstral", "qwen2", "deepseek", "qwen3",
                                 "phi3", "granite"])
def test_chip_smoke_writes_the_tiny_ggufs_byte_for_byte(tmp_path, fam):
    """chip_smoke.tiny_family_gguf (the port's writer, no JAX package) gives
    tests/tiny_models.py's file for each dense family, Q8_0 and Q4_0."""
    for q, jq in ((TGGMLType.Q8_0, GGMLType.Q8_0), (TGGMLType.Q4_0, GGMLType.Q4_0)):
        build_tiny_gguf(tmp_path / "a.gguf", family=fam, quant=jq, seed=0, with_tokenizer=True)
        chip_smoke.tiny_family_gguf(tmp_path / "b.gguf", fam, q)
        assert (tmp_path / "a.gguf").read_bytes() == (tmp_path / "b.gguf").read_bytes()


def test_chip_smoke_kquant_superblocks_decode_finite():
    """chip_smoke's seeded raw K-quant superblocks (the Q4_K_M-style GGUF's
    tensors): finite weights of a checkpoint's spread in both packages'
    decoders."""
    rng = np.random.default_rng(0)
    for t in (TGGMLType.Q4_K, TGGMLType.Q5_K, TGGMLType.Q6_K):
        raw = chip_smoke.kquant_raw(rng, t, (64, 1024))
        v = quants.dequantize(t, raw, 64 * 1024)
        assert np.array_equal(v, jq.dequantize(GGMLType[t.name], raw, 64 * 1024))
        assert np.isfinite(v).all() and 0.001 < v.std() < 0.05 and np.abs(v).max() < 0.2
