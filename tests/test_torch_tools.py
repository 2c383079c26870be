"""Slice 6's measuring tools on the CPU against the JAX package: `render` of
the llama-bench results byte for byte, `convert` byte for byte, `ppl` (the
same scored tokens, ppl within rtol 1e-4), `bench`'s row set, and `run
--profile-dir`'s trace. On the CPU no kernel launch is counted."""
import contextlib
import io
import json

import pytest
import torch
from tiny_models import build_tiny_gguf

from llamatpu import cli as jcli
from llamatpu.bench import llama_bench as jbench
from llamatpu.gguf import GGMLType
from llamatpu_torch import cli
from llamatpu_torch.bench import llama_bench
from llamatpu_torch.ops import gemm, layer_fused, quant_matmul
from llamatpu_torch.utils import profiling

TEXT = ("The quick brown fox jumps over the lazy dog. A journey of a thousand miles "
        "begins with a single step. ") * 3


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
    d = tmp_path_factory.mktemp("tools")
    out = {}
    for name, q in (("q8_0", GGMLType.Q8_0), ("q4_0", GGMLType.Q4_0), ("f32", GGMLType.F32),
                    ("f16", GGMLType.F16)):
        out[name] = d / f"llama_{name}.gguf"
        build_tiny_gguf(out[name], family="llama", quant=q, seed=0, with_tokenizer=True)
    return out


def _stdout(fn, *a) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*a)
    return rc, buf.getvalue()


def _results(cls):
    return [cls("pp512", 512, 0.123456789, 0.00123456), cls("tg128@d4096", 128, 1.5, 0.0),
            cls("pg512+128", 640, 2.25, 0.125), cls("tg128@b8", 1024, 0.0, 0.0)]


@pytest.mark.parametrize("fmt", ["md", "csv", "json", "jsonl", "sql"])
def test_render_is_byte_equal_to_jax(fmt):
    got = llama_bench.render(_results(llama_bench.BenchResult), fmt, "Llama Tiny", "q8_0")
    want = jbench.render(_results(jbench.BenchResult), fmt, "Llama Tiny", "q8_0")
    assert got.encode() == want.encode()


@pytest.mark.parametrize("quant", ["q8_0", "q4_0", "f32", "f16"])
def test_convert_is_byte_identical_to_jax(ggufs, tmp_path, quant):
    ours, theirs = tmp_path / "port.gguf", tmp_path / "jax.gguf"
    rc, out = _stdout(cli.main, ["convert", "-m", str(ggufs[quant]), "-o", str(ours)])
    jrc, jout = _stdout(jcli.main, ["convert", "-m", str(ggufs[quant]), "-o", str(theirs)])
    assert rc == jrc == 0 and json.loads(out) == json.loads(jout)
    assert ours.read_bytes() == theirs.read_bytes()
    assert json.loads(out)["requantized"] > 0 or quant == "f32"


def test_converted_checkpoint_runs_validate(ggufs, tmp_path, capsys):
    """The Q4_0 file converted to Q8_0 loads and validates on the CPU."""
    dst = tmp_path / "q8.gguf"
    assert cli.main(["convert", "-m", str(ggufs["q4_0"]), "-o", str(dst)]) == 0
    assert cli.main(["validate", "-m", str(dst), "--device", "cpu", "--dtype", "f32",
                     "--golden", str(tmp_path / "none.json")]) == 0
    assert "validation: OK" in capsys.readouterr().out


def test_ppl_matches_jax(ggufs):
    argv = ["ppl", "-m", str(ggufs["q8_0"]), "--dtype", "f32", "--text", TEXT, "--chunk", "32"]
    rc, out = _stdout(cli.main, argv + ["--device", "cpu"])
    jrc, jout = _stdout(jcli.main, argv)
    got, want = json.loads(out), json.loads(jout)
    assert rc == jrc == 0 and got["tokens"] == want["tokens"] > 32
    assert abs(got["ppl"] - want["ppl"]) <= 1e-4 * want["ppl"]


def test_ppl_needs_a_text(ggufs, tmp_path):
    assert cli.main(["ppl", "-m", str(ggufs["q8_0"]), "--device", "cpu"]) == 2
    f = tmp_path / "t.txt"
    f.write_text(TEXT, encoding="utf-8")
    rc, out = _stdout(cli.main, ["ppl", "-m", str(ggufs["q8_0"]), "--device", "cpu",
                                 "--text-file", str(f)])
    assert rc == 0 and json.loads(out)["tokens"] > 0


BENCH = ["--pp", "16", "--tg", "8", "--pg", "16+8", "-d", "0", "8", "-r", "1", "-o", "jsonl"]


def test_bench_prints_the_jax_row_set(ggufs):
    rc, out = _stdout(cli.main, ["bench", "-m", str(ggufs["q8_0"]), "--device", "cpu"] + BENCH)
    jrc, jout = _stdout(jcli.main, ["bench", "-m", str(ggufs["q8_0"])] + BENCH)
    rows = [json.loads(line) for line in out.splitlines()]
    jrows = [json.loads(line) for line in jout.splitlines()]
    assert rc == jrc == 0
    assert [(r["model"], r["quant"], r["test"], r["n"]) for r in rows] == \
        [(r["model"], r["quant"], r["test"], r["n"]) for r in jrows]
    assert [r["test"] for r in rows] == ["pp16", "tg8", "pp16@d8", "tg8@d8", "pg16+8"]
    assert all(r["avg_s"] > 0 and r["tok_s"] > 0 for r in rows)


def test_bench_rowq_batch_lanes_and_formats(ggufs):
    """--rowq with --batch 2 adds the batched row; md output; no launch counted."""
    rc, out = _stdout(cli.main, ["bench", "-m", str(ggufs["q8_0"]), "--device", "cpu", "--rowq",
                                 "--pp", "16", "--tg", "4", "-r", "1", "--batch", "2"])
    assert rc == 0
    lines = out.strip().splitlines()
    assert lines[:2] == ["| model | quant | test | tok/s |", "|---|---|---|---|"]
    assert [line.split(" | ")[2] for line in lines[2:]] == ["pp16", "tg4", "tg4@b2"]
    for f in (quant_matmul.rowq_gemv, gemm.rowq_gemm, layer_fused.qkv_norm_fused_rowq,
              layer_fused.layer_attn_tail_fused_rowq, layer_fused.layer_tail_fused_rowq):
        assert f.launches == 0


def test_bench_flags_of_later_slices_raise(ggufs):
    with pytest.raises(NotImplementedError, match="parallelism"):
        cli.main(["bench", "-m", str(ggufs["q8_0"]), "--device", "cpu", "--tp", "2"])


def test_run_profile_dir_writes_a_trace(ggufs, tmp_path):
    d = tmp_path / "prof"
    rc, out = _stdout(cli.main, ["run", "-m", str(ggufs["q8_0"]), "-p", "hi", "--device", "cpu",
                                 "-n", "40", "--metrics-format", "none", "--profile-dir", str(d)])
    assert rc == 0 and out.strip()
    trace = json.loads((d / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)


def test_trace_without_a_directory_records_nothing(tmp_path):
    with profiling.trace(None):
        x = torch.ones(3) + 1
    assert x.sum().item() == 6.0 and not list(tmp_path.iterdir())
