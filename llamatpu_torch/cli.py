"""The port's command line (the `run` and `validate` commands of
llamatpu/cli.py), on the card by default:

    python -m llamatpu_torch.cli run -m model.gguf -p "Why is the sky blue?"
    python -m llamatpu_torch.cli run -m model.gguf -p "..." --device cpu
    python -m llamatpu_torch.cli validate -m model.gguf --dtype f32

A Llama 3 GGUF in Q8_0 or Q4_0 loads as block quants (`--pack4` packs Q4_0
two values per byte; `--rowq` requantizes Q8_0 to per-row int8 and takes the
q8_row kernels), the prompt goes through the Llama 3 chat template, and the
answer is sampled at the family's defaults (temperature 0.3, top-p 0.95)
unless --temperature / --top-p say otherwise, and streamed to stdout.

The JAX package's TPU-only flags (--impl, --dump-hlo, --profile-dir) have no
counterpart here. Flags and commands of later slices of the port are
accepted and raise, naming the slice: --tp/--dp/--sp/--pipeline/--ep,
--spec-decode, --kv-dtype int8, and serve/bench/ppl/convert.
"""
from __future__ import annotations

import argparse
import sys

# later slices of the port: (flag attribute, its default, the slice)
_LATER_FLAGS = (("tp", 0, "parallelism"), ("dp", 1, "parallelism"), ("sp", 1, "parallelism"),
                ("pipeline", 1, "parallelism"), ("ep", False, "MoE/parallelism"),
                ("spec_decode", 0, "speculative-decode"))
_LATER_COMMANDS = {"serve": "serving", "bench": "benchmark", "ppl": "benchmark",
                   "convert": "quant-breadth"}


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
                        help="KV cache dtype (auto = the compute dtype; int8: later slice)")
        sp.add_argument("--pack4", action="store_true",
                        help="store Q4_0 weights two values per byte (packed4 kernel)")
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
        sp.add_argument("--ep", action="store_true", help="(MoE/parallelism slice)")
        sp.add_argument("--spec-decode", type=int, default=0,
                        help="(speculative-decode slice)")

    run = sub.add_parser("run", help="single-prompt or interactive generation")
    common(run)
    run.add_argument("--prompt", "-p", help="instruct prompt")
    run.add_argument("--system-prompt", "-sp", default=None)
    run.add_argument("--interactive", "-i", action="store_true")
    run.add_argument("--temperature", "-temp", type=float, default=None,
                     help="default: the family's (Llama 3: 0.3)")
    run.add_argument("--top-p", type=float, default=None,
                     help="default: the family's (Llama 3: 0.95)")
    run.add_argument("--stream", action=argparse.BooleanOptionalAction, default=True)
    run.add_argument("--echo", action="store_true")

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

    for name, slice_name in _LATER_COMMANDS.items():
        sub.add_parser(name, help=f"({slice_name} slice of the port)", add_help=False)
    return p


def param_dtype(args):
    import torch

    return torch.float32 if args.dtype == "f32" else torch.bfloat16


def cache_dtype(args):
    import torch

    kv = args.kv_dtype
    if kv == "int8":
        raise NotImplementedError("--kv-dtype int8: int8-KV slice of the port")
    if kv == "auto":
        return param_dtype(args)
    return {"bf16": torch.bfloat16, "f32": torch.float32}[kv]


def _check_flags(args) -> None:
    for attr, default, slice_name in _LATER_FLAGS:
        if getattr(args, attr) != default:
            flag = "--" + attr.replace("_", "-")
            raise NotImplementedError(f"{flag}: {slice_name} slice of the port")
    cache_dtype(args)


def load(args):
    """(model, metrics): the GGUF loaded as the flags say."""
    from llamatpu_torch.models.loader import load_model
    from llamatpu_torch.utils.metrics import RunMetrics, Timer

    metrics = RunMetrics()
    with Timer() as t:
        model = load_model(args.model, max_tokens=args.max_tokens,
                           param_dtype=param_dtype(args), pack4=args.pack4)
    metrics.load_s = t.elapsed
    if model.chat_format is None:
        raise NotImplementedError(
            f"{model.family.name} checkpoints: family-deltas slice of the port "
            "(this slice runs Llama 3)")
    return model, metrics


def cmd_run(args) -> int:
    from llamatpu_torch.runtime.engine import Engine
    from llamatpu_torch.runtime.session import run_instruct_once, run_interactive

    if not args.interactive and not args.prompt:
        print("error: --prompt required (or --interactive)", file=sys.stderr)
        return 2
    model, metrics = load(args)
    fmt = model.chat_format
    temp = args.temperature if args.temperature is not None else fmt.default_temperature()
    top_p = args.top_p if args.top_p is not None else fmt.default_top_p()
    engine = Engine(model, temperature=temp, top_p=top_p, seed=args.seed,
                    prefill_chunk=args.prefill_chunk, cache_dtype=cache_dtype(args),
                    rowq=args.rowq, device=args.device, metrics=metrics)
    if args.interactive:
        run_interactive(model, engine, args.system_prompt, args.max_tokens)
    else:
        run_instruct_once(model, engine, args.prompt, args.system_prompt,
                          max_new_tokens=args.max_tokens, stream=args.stream, echo=args.echo)
    if args.metrics_format != "none":
        metrics.render(args.metrics_format)
    if args.metrics_file:
        metrics.write_file(args.metrics_file)
    return 0


def main(argv=None) -> int:
    parser = build_parser()
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in _LATER_COMMANDS:
        raise NotImplementedError(f"{argv[0]}: {_LATER_COMMANDS[argv[0]]} slice of the port")
    args = parser.parse_args(argv)
    if args.command is None:
        parser.print_help()
        return 1
    _check_flags(args)
    if args.command == "run":
        return cmd_run(args)
    from llamatpu_torch.bench.validate import validate

    return validate(args)


if __name__ == "__main__":
    sys.exit(main())
