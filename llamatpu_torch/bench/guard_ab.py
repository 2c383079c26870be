"""What the decode window's guard costs (runtime/decode_graph.py): the main
path's Engine (Llama-3.2-1B, synthetic q8_0 served as q8_row, full width
and depth, seed 0, cache 1024, prefill chunk 512, decode window 128) after a
512-token seeded prompt.

- `capture` row, on any tree: the greedy capture's seconds (at the
  engine's construction) and the sampled one's (its first sampled
  window), and the bytes of the engine's decode-graph memory pools (the
  allocator's snapshot: the graph pool and, where the tree has one, the
  step bodies' pool);
- `step` rows, on a tree whose step state has a guard: the device ms a step
  over 128 back-to-back replays (CUDA events) of the engine's guarded graph
  (guard, then the step under the IF node), of guard + step captured with
  no node, and of the bare step (the graph before the guard), `--rounds`
  rounds in turn, the same tokens from each; then a traced 16-step window
  of each, read by the tree's chip_smoke.py `device_breakdown` (busy ms,
  idle share, the PDL overlap).

    python -m llamatpu_torch.bench.guard_ab [--label L] [--rounds 3]
    PYTHONPATH=<tree> python llamatpu_torch/bench/guard_ab.py --label parent

One JSON row each, with the card's name and power limit. Compare trees
within one call only, in turns (parent, change, change, parent). Needs the
card.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

REPLAYS = 128


def pools_bytes(graphs) -> int | None:
    """Bytes of the device segments of an engine's decode-graph pools, or
    None where the snapshot names no pools."""
    segs = torch.cuda.memory_snapshot()
    if not segs or "segment_pool_id" not in segs[0]:
        return None
    ids = {tuple(graphs.pool)}
    if getattr(graphs, "body_pool", None) is not None:
        ids.add(tuple(graphs.body_pool.id))
    return sum(s["total_size"] for s in segs if tuple(s["segment_pool_id"]) in ids)


def step_graphs(engine) -> dict:
    """The engine's guarded greedy graph and, captured here the way the
    graph was captured before the guard, guard + step with no IF node and
    the bare step."""
    from llamatpu_torch.runtime.decode_graph import switches

    st = engine._graphs.state
    side, pool = torch.cuda.Stream(engine.device), torch.cuda.graph_pool_handle()

    def capture(guard: bool):
        graph = torch.cuda.CUDAGraph()
        st.rewind()
        engine._park(0)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.graph(graph, pool=pool, stream=side, capture_error_mode="thread_local"):
            if guard:
                st.guard()
            engine._step(False)
        torch.cuda.synchronize()
        return graph

    return {"guarded": engine._graphs.graphs[(False, engine.impl, switches())].graph,
            "guard_no_node": capture(True), "bare": capture(False)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="tree", help="the rows' `tree` field")
    ap.add_argument("--rounds", type=int, default=3, help="timed rounds of each graph")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("guard_ab: no CUDA device")
    import importlib.util
    from pathlib import Path

    import llamatpu_torch
    from llamatpu_torch import _build
    from llamatpu_torch.models.synthetic import build_synthetic_model
    from llamatpu_torch.runtime.decode_graph import StepState, stop_ids
    from llamatpu_torch.runtime.engine import Engine

    path = Path(llamatpu_torch.__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _build.build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    model = build_synthetic_model("llama32-1b", quant="q8_0", context_length=32768)
    engine = Engine(model, cache_len=1024, prefill_chunk=512, decode_window=128, rowq=True,
                    device=dev)
    greedy_s = engine.metrics.compile_s
    prompt = np.random.default_rng(42).integers(0, model.cfg.vocab_size, 512).tolist()
    tok = int(engine.prefill(prompt)[0][0])
    engine.decode_window_run(tok, 512, 16, temperature=0.8, top_p=0.95)
    row = dict(bench="guard_ab", tree=args.label, row="capture", greedy_capture_s=greedy_s,
               sampled_capture_s=engine.metrics.compile_s - greedy_s,
               pool_bytes=pools_bytes(engine._graphs), card=card)
    print(json.dumps(row), flush=True)
    if not hasattr(StepState, "guard"):
        return
    st = engine._graphs.state
    graphs = step_graphs(engine)

    def replays(graph, n: int = REPLAYS) -> float:
        st.fill([tok], [512], [True], [0.0], [0.0], stop_ids(()))
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n):
            graph.replay()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / n

    ms = {name: [] for name in graphs}
    for _ in range(args.rounds):
        for name, graph in graphs.items():
            ms[name].append(replays(graph))
    tokens = set()
    for name, graph in graphs.items():
        replays(graph)
        tokens.add(tuple(st.out[:, 0].tolist()))
        tr = smoke.device_breakdown(lambda: replays(graph, 16))
        print(json.dumps(dict(bench="guard_ab", tree=args.label, row="step", graph=name,
                              ms_per_step=ms[name], busy_ms_16=tr["busy_ms"],
                              idle_share=tr["idle_share"], overlap_ms=tr["overlap_ms"],
                              card=card)), flush=True)
    assert len(tokens) == 1, "guard_ab: the three graphs decoded different tokens"


if __name__ == "__main__":
    main()
