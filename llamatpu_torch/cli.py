"""The port's command line (the commands of llamatpu/cli.py), on the card by
default:

    python -m llamatpu_torch.cli run -m model.gguf -p "Why is the sky blue?"
    python -m llamatpu_torch.cli run -m model.gguf -p "..." --device cpu
    python -m llamatpu_torch.cli run -m model.gguf -p "..." --profile-dir traces/
    python -m llamatpu_torch.cli validate -m model.gguf --dtype f32
    python -m llamatpu_torch.cli serve -m model.gguf --batch-size 8 --paged
    python -m llamatpu_torch.cli bench -m model.gguf --rowq --pp 512 --tg 128 -o jsonl
    python -m llamatpu_torch.cli ppl -m model.gguf --text-file wiki.txt
    python -m llamatpu_torch.cli convert -m model-q4_0.gguf -o model-q8_0.gguf

A GGUF of any of the nine families (Llama 3, Mistral, Devstral 2, Granite,
Phi-3, Qwen2, Qwen3, the DeepSeek-R1 Qwen distills, Qwen2-MoE: routed
experts through the grouped kernels) in Q8_0, Q4_0, or native Q4_K / Q5_K
(values plus per-32 offsets; Q6_K tensors requantized to Q8_0, so a
Q4_K_M file loads) loads as block quants (`--pack4` packs Q4_0 and Q4_K two
values per byte; `--rowq` requantizes Q8_0, the expert stacks included, to
per-row int8 and takes the q8_row kernels), F32/F16/BF16 as dense weights;
the prompt goes through the family's chat template (Llama 3 headers,
Mistral's [INST], Granite's roles, Qwen's ChatML, the DeepSeek distills'
<｜User｜> markers and <think> primer, Phi-3's <|user|> ... <|end|>), and
the answer is sampled at the family's defaults (Llama 3: temperature 0.3,
top-p 0.95; Qwen and DeepSeek: 0.8, 0.9; the others 0.7, 0.9) unless
--temperature / --top-p say otherwise, and streamed to stdout.
--no-thinking pre-closes Qwen3's <think></think>, so it answers without
reasoning.

--kv-dtype int8 keeps the KV cache (or the paged pool) in int8 with one f32
scale per token and KV head, half the bytes of a bf16 cache; -n reaches up
to the model's context, and a long cache takes the split attention kernel.

`bench` is llama-bench's matrix (bench/llama_bench.py: pp, tg, pg specs,
-d depths, -r reps, md/csv/json/jsonl/sql, --batch lanes); `ppl` prints
{"ppl", "tokens"} of a text; `convert` rewrites a GGUF with its matmul
weights in Q8_0 (gguf/convert.py). --profile-dir on `run` writes a
torch.profiler Chrome trace of the generation (utils/profiling.py).

--spec-decode K (run, and serve at batch size 1) drafts K tokens a step
from the token history's last-bigram continuation and verifies them in one
forward of K + 1 rows (runtime/engine.py): greedy output is the plain
greedy stream, sampled output is distributed as plain sampling.

The JAX package's XLA-only flags (--impl, --dump-hlo) have no counterpart
here. Flags of later slices of the port are accepted and raise, naming the
slice: --tp/--dp/--sp/--pipeline/--ep.

`serve` answers the OpenAI API (server/openai_server.py): --batch-size 1
runs one Engine behind a lock with KV prefix reuse; --batch-size N runs N
lanes through the continuous batcher, over a dense batched cache or, with
--paged, a shared block pool with block-level prefix caching.
"""
from __future__ import annotations

import argparse
import sys

# later slices of the port: (flag attribute, its default, the slice)
_LATER_FLAGS = (("tp", 0, "parallelism"), ("dp", 1, "parallelism"), ("sp", 1, "parallelism"),
                ("pipeline", 1, "parallelism"),
                ("ep", False, "parallelism (expert parallelism of MoE models)"))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="llamatpu_torch",
                                description="GGUF LLM engine: the PyTorch/CUDA port")
    sub = p.add_subparsers(dest="command")

    def common(sp):
        sp.add_argument("--model", "-m", required=True, help="path to GGUF checkpoint")
        sp.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the kernels' plain "
                             "PyTorch versions)")
        sp.add_argument("--max-tokens", "-n", type=int, default=512,
                        help="max total tokens (prompt + generation), clamps context")
        sp.add_argument("--dtype", choices=["bf16", "f32"], default="bf16",
                        help="activation/weight compute dtype")
        sp.add_argument("--kv-dtype", choices=["auto", "bf16", "f32", "int8"], default="auto",
                        help="KV cache dtype (auto = the compute dtype; int8 = per-row "
                             "quantized with f32 scales)")
        sp.add_argument("--pack4", action="store_true",
                        help="store Q4_0 and Q4_K weights two values per byte (packed4 "
                             "kernel)")
        sp.add_argument("--rowq", action="store_true",
                        help="serve Q8_0 weights as per-row int8 (q8_row kernels)")
        sp.add_argument("--prefill-chunk", type=int, default=128)
        sp.add_argument("--seed", type=int, default=42)
        sp.add_argument("--metrics-format", choices=["human", "json", "github", "none"],
                        default="human")
        sp.add_argument("--metrics-file", default=None,
                        help="append run metrics as one JSON line to this file")
        sp.add_argument("--tp", type=int, default=0, help="(parallelism slice)")
        sp.add_argument("--dp", type=int, default=1, help="(parallelism slice)")
        sp.add_argument("--sp", type=int, default=1, help="(parallelism slice)")
        sp.add_argument("--pipeline", type=int, default=1, help="(parallelism slice)")
        sp.add_argument("--ep", action="store_true", help="(parallelism slice)")
        sp.add_argument("--spec-decode", type=int, default=0,
                        help="prompt-lookup speculative decoding draft length K (run, and "
                             "serve at batch size 1; 0 = off)")

    run = sub.add_parser("run", help="single-prompt or interactive generation")
    common(run)
    run.add_argument("--prompt", "-p", help="instruct prompt")
    run.add_argument("--system-prompt", "-sp", default=None)
    run.add_argument("--interactive", "-i", action="store_true")
    run.add_argument("--temperature", "-temp", type=float, default=None,
                     help="default: the family's (Llama 3: 0.3, Qwen: 0.8, others 0.7)")
    run.add_argument("--top-p", type=float, default=None,
                     help="default: the family's (Llama 3: 0.95, others 0.9)")
    run.add_argument("--stream", action=argparse.BooleanOptionalAction, default=True)
    run.add_argument("--echo", action="store_true")
    run.add_argument("--profile-dir", default=None,
                     help="write a torch.profiler Chrome trace of the run into this directory")
    run.add_argument("--no-thinking", action="store_true",
                     help="suppress Qwen3 reasoning with a pre-closed <think></think>")

    val = sub.add_parser("validate", help="one-command checkpoint validation: "
                         "tokenizer fidelity, finite forward, greedy sample, "
                         "golden-token comparison, quick ppl")
    common(val)
    val.add_argument("--golden", default=None,
                     help="golden fixture JSON (default: fixtures/golden/<name>.json)")
    val.add_argument("--update-golden", action="store_true",
                     help="write the observed outputs as the golden fixture")
    val.add_argument("--prompt", "-p", default="The capital of France is",
                     help="deterministic probe prompt")

    srv = sub.add_parser("serve", help="OpenAI-compatible HTTP server")
    common(srv)
    srv.add_argument("--host", default="127.0.0.1")
    srv.add_argument("--port", type=int, default=8080)
    srv.add_argument("--batch-size", type=int, default=1,
                     help=">1: continuous batching across this many cache lanes")
    srv.add_argument("--paged", action="store_true",
                     help="with --batch-size > 1: paged KV block pool + prefix caching")
    srv.add_argument("--kv-blocks", type=int, default=0,
                     help="paged pool size in blocks (0 = half the dense footprint)")
    srv.add_argument("--kv-block-size", type=int, default=16)
    srv.add_argument("--no-prefix-cache", action="store_true",
                     help="disable KV prefix reuse across requests")
    srv.add_argument("--interleave-decode-steps", type=int, default=4,
                     help="decode steps between prefill chunks while a prompt is ingested")

    ppl = sub.add_parser("ppl", help="perplexity evaluation")
    common(ppl)
    ppl.add_argument("--text-file", help="UTF-8 text file to evaluate")
    ppl.add_argument("--text", help="inline text to evaluate")
    ppl.add_argument("--chunk", type=int, default=128)

    conv = sub.add_parser("convert", help="requantize a GGUF checkpoint to Q8_0")
    conv.add_argument("--model", "-m", required=True)
    conv.add_argument("--output", "-o", required=True)

    bench = sub.add_parser("bench", help="llama-bench style pp/tg matrix")
    common(bench)
    bench.add_argument("--pp", type=int, nargs="*", default=[512], help="prompt lengths")
    bench.add_argument("--tg", type=int, nargs="*", default=[128], help="generation lengths")
    bench.add_argument("--pg", nargs="*", default=[],
                       help="combined prompt+gen specs, e.g. 512+128")
    bench.add_argument("--depth", "-d", type=int, nargs="*", default=[0],
                       help="untimed KV prefill depth before the timed window")
    bench.add_argument("--reps", "-r", type=int, default=3)
    bench.add_argument("--output", "-o", choices=["md", "csv", "json", "jsonl", "sql"],
                       default="md")
    bench.add_argument("--batch", "-b", type=int, default=1)
    return p


def param_dtype(args):
    import torch

    return torch.float32 if args.dtype == "f32" else torch.bfloat16


def cache_dtype(args):
    import torch

    kv = args.kv_dtype
    if kv == "auto":
        return param_dtype(args)
    return {"bf16": torch.bfloat16, "f32": torch.float32, "int8": torch.int8}[kv]


def _check_flags(args) -> None:
    for attr, default, slice_name in _LATER_FLAGS:
        if getattr(args, attr) != default:
            flag = "--" + attr.replace("_", "-")
            raise NotImplementedError(f"{flag}: {slice_name} slice of the port")


def load(args):
    """(model, metrics): the GGUF loaded as the flags say."""
    from llamatpu_torch.models.loader import load_model
    from llamatpu_torch.utils.metrics import RunMetrics, Timer

    metrics = RunMetrics()
    with Timer() as t:
        model = load_model(args.model, max_tokens=args.max_tokens,
                           param_dtype=param_dtype(args), pack4=args.pack4)
    metrics.load_s = t.elapsed
    return model, metrics


def cmd_run(args) -> int:
    from llamatpu_torch.runtime.engine import Engine
    from llamatpu_torch.runtime.session import run_instruct_once, run_interactive
    from llamatpu_torch.utils.profiling import trace

    if not args.interactive and not args.prompt:
        print("error: --prompt required (or --interactive)", file=sys.stderr)
        return 2
    model, metrics = load(args)
    fmt = model.chat_format
    temp = args.temperature if args.temperature is not None else fmt.default_temperature()
    top_p = args.top_p if args.top_p is not None else fmt.default_top_p()
    engine = Engine(model, temperature=temp, top_p=top_p, seed=args.seed,
                    prefill_chunk=args.prefill_chunk, cache_dtype=cache_dtype(args),
                    rowq=args.rowq, device=args.device, metrics=metrics,
                    spec_decode=args.spec_decode)
    with trace(args.profile_dir):
        if args.interactive:
            run_interactive(model, engine, args.system_prompt, args.max_tokens,
                            enable_thinking=not args.no_thinking)
        else:
            run_instruct_once(model, engine, args.prompt, args.system_prompt,
                              max_new_tokens=args.max_tokens, stream=args.stream,
                              echo=args.echo, enable_thinking=not args.no_thinking)
    if args.metrics_format != "none":
        metrics.render(args.metrics_format)
    if args.metrics_file:
        metrics.write_file(args.metrics_file)
    return 0


def cmd_ppl(args) -> int:
    import json

    from llamatpu_torch.bench.perplexity import perplexity_of_text

    if not args.text and not args.text_file:
        print("error: --text or --text-file required", file=sys.stderr)
        return 2
    if args.text:
        text = args.text
    else:
        with open(args.text_file, encoding="utf-8") as f:
            text = f.read()
    model, _ = load(args)
    res = perplexity_of_text(model, text, chunk=args.chunk, device=args.device)
    print(json.dumps({"ppl": round(res["ppl"], 4), "tokens": res["tokens"]}))
    return 0


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command is None:
        parser.print_help()
        return 1
    if args.command == "convert":
        import json

        from llamatpu_torch.gguf.convert import requantize_gguf

        print(json.dumps(requantize_gguf(args.model, args.output)))
        return 0
    _check_flags(args)
    if args.command == "run":
        return cmd_run(args)
    if args.command == "ppl":
        return cmd_ppl(args)
    if args.command == "bench":
        from llamatpu_torch.bench.llama_bench import run_bench

        run_bench(args)
        return 0
    if args.command == "serve":
        from llamatpu_torch.server.openai_server import serve

        serve(args)
        return 0
    from llamatpu_torch.bench.validate import validate

    return validate(args)


if __name__ == "__main__":
    sys.exit(main())
