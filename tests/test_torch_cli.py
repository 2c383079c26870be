"""The port's command line on the CPU: `validate` reproduces the JAX
package's committed goldens, `run` streams text, the card is the default
device, flags of later slices raise, and no kernel launch is counted on the
CPU."""
import io
import pathlib

import pytest
import torch
from tiny_models import build_tiny_gguf

from llamatpu.gguf import GGMLType
from llamatpu_torch import cli
from llamatpu_torch.ops import attention, gemm, layer_fused, quant_matmul

GOLDEN = pathlib.Path(__file__).resolve().parents[1] / "fixtures" / "golden"
WRAPPERS = (quant_matmul.rowq_gemv, quant_matmul.block_matmul, quant_matmul.packed4_matmul,
            gemm.rowq_gemm, layer_fused.qkv_norm_fused_rowq,
            layer_fused.layer_attn_tail_fused_rowq, layer_fused.layer_tail_fused_rowq,
            attention.decode_attention_fused_write, attention.decode_attention_paged)


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    out = {}
    for name, q in (("llama_q8_0", GGMLType.Q8_0), ("llama_q4_0", GGMLType.Q4_0)):
        out[name] = d / f"{name}.gguf"
        build_tiny_gguf(out[name], family="llama", quant=q, seed=0, with_tokenizer=True)
    return out


@pytest.mark.parametrize("name,extra", [("llama_q8_0", []), ("llama_q4_0", []),
                                        ("llama_q4_0", ["--pack4"])])
def test_validate_reproduces_the_jax_goldens(ggufs, name, extra, capsys):
    """fixtures/golden/llama_q{8,4}_0.json hold the JAX CLI's f32 `validate`
    results (greedy ids and quick ppl): the port reproduces the ids exactly
    and the ppl within 1%, through K5 (and K7 with --pack4) and K6."""
    rc = cli.main(["validate", "-m", str(ggufs[name]), "--dtype", "f32", "--device", "cpu",
                   "--golden", str(GOLDEN / f"{name}.json")] + extra)
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "[PASS] golden-tokens" in out and "[PASS] golden-ppl" in out


def test_run_streams_text_on_cpu(ggufs, capsys):
    """`run --device cpu` at the family's default sampling (temperature 0.3,
    top-p 0.95) streams text and exits 0; the same seed gives the same text,
    --no-stream prints nothing; no kernel launch is counted on the CPU."""
    for w in WRAPPERS:
        w.launches = 0
    argv = ["run", "-m", str(ggufs["llama_q8_0"]), "-p", "hello world", "--device", "cpu",
            "-n", "40", "--seed", "3", "--metrics-format", "json"]
    assert cli.main(argv) == 0
    first = capsys.readouterr()
    assert first.out.strip() and '"decode_tokens"' in first.err
    assert cli.main(argv) == 0
    assert capsys.readouterr().out == first.out
    assert cli.main(argv + ["--no-stream", "--metrics-format", "none"]) == 0
    assert capsys.readouterr().out == ""
    assert cli.main(argv[:-2] + ["--echo", "--temperature", "0", "--system-prompt", "Be brief.",
                                 "-n", "64", "--metrics-format", "none"]) == 0
    assert capsys.readouterr().out.strip()
    assert all(w.launches == 0 for w in WRAPPERS)


def test_rowq_flag_routes_to_the_q8_row_path(ggufs, capsys):
    """--rowq serves a Q8_0 GGUF as q8_row (slice 1's kernels); Q4_0 tensors
    stay block quants."""
    from llamatpu_torch.models.loader import load_model
    from llamatpu_torch.runtime.engine import Engine

    assert cli.main(["run", "-m", str(ggufs["llama_q8_0"]), "-p", "hi", "--device", "cpu",
                     "--rowq", "-n", "40", "--temperature", "0",
                     "--metrics-format", "none"]) == 0
    assert capsys.readouterr().out.strip()
    for name, kind in (("llama_q8_0", "q8_row"), ("llama_q4_0", "q4_0")):
        e = Engine(load_model(str(ggufs[name])), rowq=True, device="cpu")
        assert e.weights["layers"]["wqkv"].kind == e.weights["wcls"].kind == kind


def test_interactive_chat_continues_the_cache(ggufs, monkeypatch, capsys):
    """`run -i` reads turns until /exit; a ChatSession's second turn continues
    the KV cache: its greedy reply equals a fresh engine's on the whole
    conversation fed as one prompt."""
    from llamatpu_torch.format import Message, Role
    from llamatpu_torch.models.loader import load_model
    from llamatpu_torch.runtime.engine import Engine
    from llamatpu_torch.runtime.session import ChatSession

    lines = iter(["hello", "", "/exit"])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(lines))
    assert cli.main(["run", "-m", str(ggufs["llama_q4_0"]), "-i", "--device", "cpu", "-n", "64",
                     "--pack4", "--temperature", "0", "--metrics-format", "none"]) == 0
    assert capsys.readouterr().out.strip()

    model = load_model(str(ggufs["llama_q4_0"]), pack4=True, param_dtype=torch.float32)
    kw = dict(cache_len=64, prefill_chunk=32, decode_window=4, cache_dtype=torch.float32,
              device="cpu")
    session = ChatSession(model, Engine(model, **kw))
    results = []
    generate = session.engine.generate
    session.engine.generate = lambda *a, **k: results.append(generate(*a, **k)) or results[-1]
    fmt = model.chat_format
    turns = []
    for text in ("hi", "and?"):
        turns.append(list(session._pending) + fmt.encode_message(Message(Role.USER, text))
                     + fmt.encode_header(Message(Role.ASSISTANT, "")))
        session.send(text, 4)
    g1, g2 = results[0].tokens, results[1].tokens
    # the last token of turn 1 was never fed back: turn 2 starts with it
    full = turns[0] + g1[:-1] + turns[1]
    assert turns[1][0] == g1[-1] and session.pos == len(full) + len(g2) - 1
    assert Engine(model, **kw).generate(full, 4).tokens == g2


def test_run_defaults_to_the_card(ggufs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["run", "-m", str(ggufs["llama_q8_0"]), "-p", "hi"])
    assert cli.main(["run", "-m", str(ggufs["llama_q8_0"])]) == 2  # no --prompt


@pytest.mark.parametrize("argv,slice_name", [
    (["--tp", "2"], "parallelism"), (["--dp", "2"], "parallelism"),
    (["--sp", "2"], "parallelism"), (["--ep"], "MoE"), (["--pipeline", "2"], "parallelism")])
def test_flags_of_later_slices_raise(ggufs, argv, slice_name):
    with pytest.raises(NotImplementedError, match=slice_name):
        cli.main(["run", "-m", str(ggufs["llama_q8_0"]), "-p", "hi", "--device", "cpu"] + argv)


def test_spec_decode_reaches_the_run_engine(ggufs, monkeypatch):
    """--spec-decode (since slice 21) is no later slice's flag: `run` builds
    its Engine with spec_decode=K (0 without the flag)."""
    from llamatpu_torch.runtime import engine

    made = []

    class Spy(engine.Engine):
        def __init__(self, *a, **kw):
            made.append(kw.get("spec_decode"))
            super().__init__(*a, **kw)

    monkeypatch.setattr(engine, "Engine", Spy)
    argv = ["run", "-m", str(ggufs["llama_q8_0"]), "-p", "hi", "--device", "cpu", "-n", "24",
            "--metrics-format", "none", "--no-stream"]
    assert cli.main(argv + ["--spec-decode", "4"]) == 0 and cli.main(argv) == 0
    assert made == [4, 0]


@pytest.mark.parametrize("command", ["serve"])
def test_commands_of_later_slices_raise(command):
    """`serve` runs since slice 3, and its flags of later slices raise (here
    tensor parallelism)."""
    with pytest.raises(NotImplementedError, match="slice of the port"):
        cli.main([command, "-m", "x.gguf", "--tp", "2"])


def test_metrics_file_appends_json_lines(ggufs, tmp_path, capsys):
    import json

    mf = tmp_path / "m.jsonl"
    for _ in range(2):
        assert cli.main(["run", "-m", str(ggufs["llama_q8_0"]), "-p", "hi", "--device", "cpu",
                         "-n", "36", "--metrics-format", "none", "--metrics-file",
                         str(mf)]) == 0
    rows = [json.loads(line) for line in io.StringIO(mf.read_text())]
    assert len(rows) == 2 and all(r["prefill_tokens"] > 0 for r in rows)
    capsys.readouterr()
