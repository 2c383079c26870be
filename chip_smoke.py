"""Smoke run of the PyTorch/CUDA port (llamatpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py [--log-dir DIR]

(--log-dir DIR also writes the progress lines, the ptxas report and every
measured number as JSON into DIR.)

It runs every phase, needs one card, and exits non-zero
(printing no result) where CUDA is missing or the package is not beside it:

1. device:  the card's name and power limit (nvidia-smi).
2. build:   nvcc builds every kernel from llamatpu_torch/csrc into build/kernels.
3. kernels: each kernel (K1-K20, with K6's and K8's int8 variants) against
            its plain PyTorch version on the card, at the main-path shapes of
            llama32-1b (K1-K9, K3 at pos 0, 31, 32, 511 and S - 1 in bf16
            and 511 in f32, two runs bit-equal, timed beside K6 + K9 at
            T = 1; K4 and K17 at every prefill projection the
            paths give them: llama32-1b's four at T = 512 and 128,
            Phi-3-medium's four at T = 128 and a ragged T = 200, O = 2560, I =
            2064, each logged with its CTAs and shared tiles; K1 on the
            head also at 8 and 32 rows (T = 1 also on gemv.cuh's
            gemv_kernel<1>), K1 and K2's edges (check_rowq_edges: bf16 and
            f32, O = 1000 and 300, I = 2048 and 200, T = 1-127, two runs
            bit-equal); K2 also at 8 and 32 rows, K5 at T = 8, K6 at 8
            lanes, K8 at 8 lanes of a shuffled block pool, K9 at 1, 8 and 32
            rows; K6 and K6-int8's edges (check_dense_edges: f32, bf16 and
            int8 at the Llama, Qwen1.5-MoE and Phi-3-medium geometries,
            every cluster size, 1152 rows and the largest short cache, pos
            0 to S - 1 and -1) and times at B = 1 and 8 lanes, pos 512, warm
            and cold, every cluster size; K14 fused bf16/int8 on a 33792-row cache at pos 0 to 32767
            and 8 mixed lanes, unfused, stats and f32; K15 over 4000 of 4128
            rows in f32, bf16 and int8, one lane at pos 3999 under the
            path's plan; K14's and K15's one kernel (stripe_cluster_kernel)
            at its edges (check_stripe_edges: unit, cluster and round
            boundaries under the planner's plans at the path shapes and
            the cluster sizes of STRIPE_EDGE_CLUSTERS, fused, unfused and
            stats, s_use 3990 under the one-lane plans, Phi-3-medium's
            geometry, two runs bit-equal), each timed under the planner's
            plan, with K6 at pos 512 in the same call; K6-int8 at pos 0 to 1151 and 8
            lanes, K8-int8 at 8 lanes; quantize_kv card against CPU bit for bit) and of
            Qwen1.5-MoE-A2.7B (K10-K13 on one layer's folded stacks, E = 64,
            at 1, 8 and 512 tokens; their one kernel's edges,
            check_moe_edges: every front end with bf16 and f32 x, tm 8, 32
            and 128, groups of 1-128 real rows, an expert of no rows, -1
            tail tiles, I 1408, 2048 and 4608, ragged O, two runs
            bit-equal; K6 and K8 at hd 128, G 1; K2 at O = 6144; K5 on the
            151936-row head), with the stated tolerances;
            slice 6's: K16 at T = 1, 8 and 32 in bf16 and f32 (two runs
            bit-equal, timed beside K9), K18a-j and
            K19a-c on the
            probe scripts' [24, 4096, 4096] stacks at every configuration
            of the scripts, the tensor-core GEMV also at ragged
            shapes (K18a / K18i: GEMV_TC_EDGES, T = 1, 3, 8; O = 300, 1000;
            K slices and their second pass; I = 9232; K18b / K18c / K18g in
            both weight kinds: GEMV_Q8_EDGES, also NB = 16 to I and two
            runs bit-equal; K18d / K18e / K18h, the W_S8 kind:
            INT8DOT_EDGES, T = 1, 3, 5, 8, ragged O, I = 16 x 33 and 16 x
            129, forced and planned K slices, block scales past the
            registers, the +-127 / -128 worst case, exact without scales
            and two runs bit-equal); slice 7's: K20 at
            Phi-3-medium widths, T = 17 and 24 in bf16, and at Qwen2.5-14B
            widths, T = 32 in f32, with K9 (T = 1, 8, 16), K2 (1, 8, 24, 32
            rows) and K1 (wo, w13, w2 at 24 and 32 rows) at Phi-3-medium
            widths; slice 23's int8_dot (the int8 mode's block dot) at the
            five Llama-3.2-1B projections, T = 1, 8, 16, bf16 and f32 x, its
            edges (I = 32, ragged O, a zero row, an f16-subnormal scale,
            grouped expert rows) and an exact case held bit for bit; times
            from CUDA events and
            torch.profiler (kernel,
            plain version, one-call library yardstick) beside the bound
            from the published H100 SXM peaks.
4. moe:     slice 4's path, full-width Qwen1.5-MoE-A2.7B (synthetic Q8_0,
            seed 0, the shared expert folded) at 6 of its 24 layers (a
            depth cut for the script's time limit): Engine, prefill 512 then
            128 greedy tokens (K10, K5, K6); the same with rowq (K12, K1,
            K2, K4, K6); PagedBatchEngine with 8 lanes
            (K10, K5, K8), a traced window and the distinct experts per
            layer.
5. moe gguf: the model at full width and 4 layers (depth cut to keep the file
            ~3 GB) as a qwen2moe Q8_0 GGUF with a 151936-id ChatML vocab:
            `cli run`; `cli serve --batch-size 8 --paged` in-process over
            HTTP (launch counts held to the engine's steps and chunks); a Q4_0
            copy through `cli run --pack4` and Engine (K11, K7).
6. moe cpu: full width, 2 layers, f32: the card against the CPU (plain
            versions), Q8_0 experts (K10) and dense f32 experts served
            unfolded (K13, driven and traced on the card).
7. main:    slice 1's path, full-width llama32-1b (synthetic q8_0 -> q8_row,
            seed 0, built with context_length 32768): prefill 512 then 128
            greedy tokens through the port's Engine, with K1-K4's launch
            counts read over that run (K3 = 16 per step); a one-lane
            BatchEngine on the same weights, 32 tokens (its device
            positions take K3 = 16 per step, as the JAX BatchEngine takes
            its megakernel); then 32 steps with LLAMATPU_NO_ATTN_TAIL=1
            (K3 = 0, K6 = K9 = 16 per step).
8. longctx: slice 5's path on the same weights: Engine at cache 32768,
            prefill chunk 512, a 32000-token prompt then 128 greedy tokens,
            with bf16 and with int8 KV (K14 fused = K2 = K9 = 16 and K1 = 1
            per step, K3 = K6 = 0); prefill and decode tok/s, a traced
            16-step window, peak device memory, the first token where the
            two differ. Then the full-stripe path: f32 KV at cache 4000 with
            a 3000-token prompt (K15); int8 KV there (K6-int8); and with
            LLAMATPU_NO_FUSED_ATTN=1 int8 KV at 4000 (K15-int8) and 16384
            (K14 unfused) rows.
9. gguf:    slice 2's path. The same synthetic model, written by the port's
            GGUF writer as a full-width, full-depth Q8_0 Llama 3 GGUF (tied
            head, byte-level BPE vocab of 128256 ids with the Llama 3
            specials at their ids, context 8192), then: `llamatpu_torch.cli run` on it
            in-process; Engine(rowq=False) prefill 512 + 128 greedy tokens
            with the launch counts of K5 and K6 (and K1-K4 at 0); a sampled
            generation (temperature 0.3, top-p 0.95, seed 42) run twice.
9b. tools:  slice 6's commands on that GGUF: `cli bench --rowq --pp 512
            --tg 128 --pg 512+128 -d 0 4096 -r 2 -o jsonl --batch 8
            --prefill-chunk 512` (its
            six rows; K4, K1, K2, K3, K6 and K9 launched), `cli ppl` on a
            short text, `cli run --rowq --profile-dir` (the trace names K1's
            kernel).
10. serve:  slice 3's path, `cli serve --batch-size 8 --paged` in-process on
            that GGUF: PagedBatchEngine (8 lanes, block 16, max_len 2048,
            prefill chunk 128, window 16) behind BatchedInferenceService and
            make_server on 127.0.0.1; 8 concurrent greedy chat completions,
            2 streamed ones (SSE to [DONE]), a text completion, /health and
            /v1/models; launch counts held to the engine's decode steps and
            prefill chunks (K5 and K8), no scheduler error; a traced 16-step
            window at 8 lanes; the serving-latency benchmark (16 requests,
            prompt 128, 64 new, a 1024-token adversary, prefix-cache repeat).
11. serve --rowq: the same HTTP run with q8_row weights (K1, K2, K4, K8, K9).
12. int8:   on that GGUF, `cli run --kv-dtype int8` (K5, K6-int8) and the
            HTTP run of `serve --kv-dtype int8 --batch-size 8 --paged` (K5,
            K8-int8 = 16 per step) with serve's gates.
12b. int8 mode: slice 23's exact int8 mode on that GGUF (`run_int8_paths`):
            `cli run --impl int8` (int8_dot = 65 a decode step), `cli ppl
            --chunk 16` with --impl int8 (int8_dot alone) beside --impl
            auto (K5 alone), Engine(impl="int8") pp512 + tg128 as graph
            replays (a 16-step window: int8_dot = 65 a step, K5 none) with
            the graph held to the eager window; a 4-layer BatchEngine at 8
            lanes in int8 mode, graph == eager; the same 4 layers as q8_row
            in int8 mode (K1 at a 512-row chunk, never K4; graph == eager);
            Qwen1.5-MoE-A2.7B at full width and 2 layers, int8 mode (the
            experts' (token, slot) rows in grouped int8_dot calls): prefill
            and 4 decode steps held to the same forwards with the plain
            version on the card, and a 128-token prefill chunk timed in int8
            and auto mode. The kernels phase holds K1 at the int8 mode's
            prefill rows (Llama-3.2-1B's four projections at T = 128 and
            512, the rowq_gemv row's "int8_mode_rows").
13. pack4:  the GGUF in Q4_0 at 4 layers, loaded with pack4: prefill 128 +
            32 decode steps through K7 (K5 at 0); then `cli convert` of it to
            Q8_0 and `cli validate` of the converted file on the card.
14. dense batch: BatchEngine, q8_row, full width, 4 layers, 8 lanes:
            generate_batch through K6 at each lane's position and K2 + K9.
14a. phi3:  slice 7's path, full-width Phi-3-medium-4k at 20 of its 40
            layers (a depth cut for the time limit since slice 22;
            synthetic Q8_0 served as q8_row, seed 0), where the JAX
            package's VMEM fits decline K3 and, at 17-24 rows, K9: Engine
            at one lane (K3 = 0, K6 = K9 = 20 per step), BatchEngine at 8
            lanes (K9 = 20 per step), 24 lanes dense and paged (K20 = 20
            per step, K9 = 0) and 32 lanes (the two-call FFN, K20 = 0); load
            s, peak host RSS, tok/s and a traced window's idle share each;
            then a 4-layer full-width phi3 Q8_0 GGUF with an SPM vocab
            through `cli run` and `cli serve --batch-size 8 --paged` over
            HTTP.
14b. qwen3: slice 22's paths. Full-width, full-depth Qwen3-0.6B (the
            qwen3-0.6b preset: q/k norm, 16 heads of 128 on 8 KV heads, q
            width 2048 on dim 1024; synthetic Q8_0 served as q8_row, seed
            0) through Engine, pp512 then tg128 greedy (K4, K1, K2, the q/k
            norm as a plain op, then K3 where the JAX fit takes it, else K6
            + K9), the graph against the eager window; the card against
            the CPU at 2 layers in f32, prefill and 4 decode-step logits
            within 1e-4, q8_row and native Q4_K; a Q4_K_M-style GGUF
            (Q4_K projections, Q6_K attn_v / ffn_down / token_embd, seeded
            raw superblocks, a ChatML vocab with <think> / </think>) at full
            width and depth through `cli run`, `cli run --no-thinking`,
            `cli run --pack4` (K7) and `cli serve` (three HTTP requests);
            a Q5_K copy at 4 layers through `cli run`; then `cli run` on
            the tiny Q8_0 GGUF of each of the five families (DeepSeek-R1
            distill, Qwen3, Mistral, Devstral 2, Granite: tests/tiny_models.py's
            files, written by `tiny_family_gguf`), DeepSeek's streaming
            its <think> primer. Slice 22's kernel holds, in the kernels
            phase: K2 and K3 at Qwen3-0.6B's shapes and at Granite-3.2-2b's
            µP scales, K1 on the 151936- and 49155-row heads, K5 on the
            49155-row head, K5 / K7 on Q4_K and Q5_K values at Qwen3-0.6B's
            projections (T = 1, 8, 512, with the offset epilogue), K13 on
            the experts' offset term at Qwen1.5-MoE's widths (each row's
            "slice22" entry).
14c. parity: bench/parity.py on the card (`run_parity_path`): the f32
            master at Llama-3.2-1B width and 2 layers (a depth cut for
            time), a 128-token corpus, f32 / bf16 / q8_0 / q8_0-int8dot /
            q8_0-kvint8 / q8_row / q4_0 inside tests/test_parity_gate.py's
            bounds. The qwen3 phase also loads its Q4_K_M file with the
            native codecs (gguf/native.py, built with the host compiler) and
            with LLAMATPU_NO_NATIVE=1 (seconds each, equal trees), and
            holds every `cli run` of it to native decoding.
14d. harnesses: slice 6's, each a path with its counts read over it:
            bench/sweep_tail.py (K9 against K16 over the 16 layers, T = 1
            and 8), bench/bench_gemm.py (torch._int_mm, K4, K17 and bf16
            torch.matmul at T = 512 and 128),
            bench/roofline.py (K18 and the library rows) and
            bench/dma_sweep.py (K19) on [24, 4096, 4096] stacks; each times
            its launches as one CUDA-graph replay, asserts its counts and
            prints its JSON rows.
15. cpu:    the port on the card against the port on the CPU (plain
            versions), full width, 2 layers: slice 1's q8_row model, the Q8_0
            GGUF through Engine and through PagedBatchEngine.generate_batch,
            f32 prefill logits held to 1e-4 of the largest, greedy agreement
            reported; slice 5's int8 KV at cache 1024 (K6-int8) and 16384
            (K14 int8) and f32 KV at 8192 (K14 f32), with all 16 greedy ids
            equal.

graph_decode, inside the phases above: every decode window on the card is
replays of a captured CUDA graph of one step (runtime/decode_graph.py). For
the main path, the one-lane and 8-lane dense BatchEngine, 32k bf16 and int8,
the Q8_0 GGUF, paged serving at 8 lanes, paged MoE and Phi-3-medium at 24
and 32 lanes, a greedy and a sampled 16-step window from the graph equal the
same windows run eagerly (the engines' private `_graphs._eager_windows`)
from one prefilled cache and generator state, their launches equal 16 x the
launches each capture recorded, and the eager and graph windows are traced:
device busy ms, idle share and tok/s, beside the capture's seconds and the
graph pool's bytes (one `graph_decode:` log line at the end).

spec, inside the main path's phase (slice 21): a K = 8 speculative Engine
on the main path's weights (cache 1024, prefill chunk 512) and the plain
main-path Engine each generate tg128 greedy after bench/spec_bench.py's
tiled 512-token prompt: the spec run launches K2 and K9 16 times and K1
once a verify forward (K + 1 = 9 rows, no K3), its greedy tokens equal the
plain ones or part at a logged bf16 argmax near-tie of the plain step;
spec windows from the captured verify step equal the same windows run
eagerly, greedy and sampled, with launches = forwards x captured; plain
and spec tok/s, acceptance, forwards, rounds, parked forwards, traced
windows, capture seconds and pool bytes are logged; then bench/spec_bench.py
on the same weights as Q8_0 block quants (K5 = 65 a forward or chunk).

Every path's launch counts are set to 0 just before it is driven and read
just after. Then one {"kernels": [...]} line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Imports nothing of JAX or of the JAX package.
The GGUF files go to build/smoke/ in the checkout and are deleted at the end.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

# published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_S = 3.35e12
BF16_OPS_S = 989e12
INT8_OPS_S = 1979e12
F32_OPS_S = 67e12  # float32 outside the tensor cores

T0 = time.perf_counter()
LOG_FILES = []  # the --log-dir copy of the progress lines


def log(msg: str) -> None:
    """One progress line, stamped with the seconds since the script began."""
    line = f"[chip_smoke {time.perf_counter() - T0:6.1f}s] {msg}"
    print(line, flush=True)
    for f in LOG_FILES:
        print(line, file=f, flush=True)


def bound(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    """Least time the card could take (ms), and what sets it."""
    tb, to = nbytes / HBM_BYTES_S * 1e3, ops / peak_ops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def time_ms(fn, iters: int = 16, reps: int = 5) -> float:
    """Device time of one fn() call: `iters` calls captured in one CUDA graph,
    replayed `reps` times between CUDA events, so host launch gaps are not
    counted (the wrapper's own small torch ops are)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * iters)


def kernel_ms(fn, names, iters: int = 16):
    """Device time of the named kernels per fn() call, from a torch.profiler
    trace (None if the trace holds no device time): each named kernel's mean
    time a launch, times its launches a call. A trace can miss launches
    (seen on the H100: 1 of 4 long kernels recorded, 15 of 16 short ones),
    which summing the trace and dividing by the calls would count as time not
    spent; a kernel seen n times in `iters` calls is taken to launch
    ceil(n / iters) times a call. A trace that holds none of them at all
    (seen on the H100 after some hundred traces in one process) is taken
    again, up to three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages() if any(n in e.key for n in names) and e.count]
        if any(e.count % iters for e in hits):
            log(f"profiler missed launches of {names}: {[e.count for e in hits]} for {iters} calls")
        tot = sum(getattr(e, "device_time_total", 0.0) / e.count * -(-e.count // iters)
                  for e in hits)
        if tot > 0:
            return tot / 1e3
        log(f"profiler saw no device time of {names} (trace {attempt + 1} of 3)")
    return None


def fmt_ms(ms) -> str:
    """A time for a progress line: "not measured" where the profiler saw none."""
    return "not measured" if ms is None else f"{ms:.5f}"


def timings(fn, names, plain, library, iters: int = 16, graph: bool = False) -> dict:
    """ms: the kernels' own device time (profiler; the wrapper's graph time if
    the profiler saw none, or with graph=True: for kernels launched with
    programmatic dependent launch, whose launches overlap, so the profiler's
    per-kernel times count the overlap twice); kernel_ms: the profiler's sum;
    wrapper_ms: the wrapper call in a CUDA graph; plain_ms / library_ms: the
    plain version and the library yardstick."""
    wrapper = time_ms(fn, iters=iters)
    own = kernel_ms(fn, names, iters=iters)
    graph = graph or own is None
    return dict(ms=wrapper if graph else own, ms_source="cuda graph" if graph else "profiler",
                kernel_ms=own,
                wrapper_ms=wrapper, plain_ms=time_ms(plain, iters=min(iters, 4)),
                library_ms=None if library is None else time_ms(library, iters=iters))


def max_err(got, want) -> tuple[float, float]:
    d = (got.float() - want.float()).abs().max().item()
    return d, d / max(want.float().abs().max().item(), 1e-30)


def rand_rowq(L, o, i, dev, gen):
    """Stacked q8_row weights whose projection keeps unit variance."""
    import torch

    from llamatpu_torch.models.weights import QTensor

    qs = torch.randint(-127, 128, (L, o, i), dtype=torch.int8, device=dev, generator=gen)
    s = (torch.rand((L, o, 1), device=dev, generator=gen) + 0.5) / (73.6 * i ** 0.5)
    return QTensor(qs, s, "q8_row")


MOE_KERNELS = ("grouped_tc_kernel",)  # K10-K13: one template, both tile regimes
STRIPE = ("stripe_cluster_kernel",)  # K14 and K15: one launch, P clusters a head
# llama32-1b main-path shapes: layers, dim, hidden, kv heads, groups, head dim,
# physical cache length (cache_len 1024 + one 128-row granule), vocab, prefill rows
LLAMA32_1B = dict(L=16, D=2048, F=8192, KV=8, G=4, HD=64, S=1152, V=128256, T=512)
# Phi-3-medium-4k-instruct's published geometry (microsoft/Phi-3-medium-4k-instruct
# config.json): dim 5120, FFN 17920, 40 layers, 40 heads of 128 over 10 KV heads,
# vocab 32064, context 4096. L: the layers of the kernel checks' weight stacks.
PHI3_MEDIUM = dict(L=3, D=5120, F=17920, KV=10, G=4, HD=128, V=32064)
PHI3_OVERRIDES = dict(dim=5120, hidden_dim=17920, n_layers=40, n_heads=40, n_kv_heads=10,
                      head_dim=128, vocab_size=32064, context_length=4096)
QWEN25_14B = dict(L=2, D=5120, F=13824)  # Qwen2.5-14B's FFN widths (f32 rows take K20 there)
# csrc/rowq_tc.cuh's template runs the bf16 GEMV phases of K1, K2, K9 and K20;
# its last template argument names the caller in the symbol
# (`rtc::rowq_tc_kernel<NF, PAIR, rtc::K9>`), so a trace tells them apart
# (the GEMV `rowq_tc_kernel` and a split contraction's `rowq_tc_reduce`)
K1_NAMES = ("rtc::K1>",)  # K1's passes (bf16)
K2_TC = ("qkv_rmsnorm_kernel", "rtc::K2>")  # K2's norm phase and GEMV phases (bf16)
K9_TC = ("rtc::K9>",)
K20_TC = ("rtc::K20>",)
INT8_NAMES = ("q8_quantize_kernel", "q8_dot_kernel")  # the int8 mode's two launches a call


def check_k1(dev, gen, dims=LLAMA32_1B, edges: bool = True) -> dict:
    """K1 on the vocab head at T = 1, 8 and 32 bf16 rows against its plain
    version (within 1e-5 of the largest output, two runs bit-equal), timed
    beside its bound and bf16 torch.matmul, T = 1 also on gemv.cuh's
    gemv_kernel<1> (the route kept there if the template is more than 5 %
    slower); then, with `edges`, its edges (`check_rowq_edges`)."""
    import torch

    from llamatpu_torch.ops import quant_matmul

    D, V = dims["D"], dims["V"]
    qs = torch.randint(-127, 128, (V, D), dtype=torch.int8, device=dev, generator=gen)
    w_bf = qs.to(torch.bfloat16)
    per = {}
    for t in (1, 8, 32):
        x = torch.randn((t, D), device=dev, generator=gen).to(torch.bfloat16)
        got, want = quant_matmul.rowq_gemv(x, qs), quant_matmul.rowq_gemv_plain(x, qs)
        again = quant_matmul.rowq_gemv(x, qs)
        torch.cuda.synchronize()
        assert torch.equal(got, again), f"K1 head T={t}: two runs differ"
        abs_e, rel_e = max_err(got, want)
        assert rel_e <= 1e-5, f"K1 disagrees at T={t}: max abs {abs_e} rel {rel_e}"  # f32 sums
        b_ms, b_by = bound(V * D + t * D * 2 + t * V * 4, 2 * t * V * D, BF16_OPS_S)
        per[t] = dict(max_abs_err=abs_e, max_rel_err=rel_e, bound_ms=b_ms, bound_by=b_by,
                      **timings(lambda x=x: quant_matmul.rowq_gemv(x, qs), K1_NAMES,
                                lambda x=x: quant_matmul.rowq_gemv_plain(x, qs),
                                lambda x=x: torch.matmul(x, w_bf.T), iters=8, graph=True))
        log(f"K1 head T={t}: {per[t]['ms']:.4f} ms (bound {b_ms:.4f}, library "
            f"{per[t]['library_ms']:.4f}), rel err {rel_e:.3g}, two runs bit-equal")
    # the 5 % rule of T = 1: gemv.cuh's gemv_kernel<1> on the same call
    x1 = torch.randn((1, D), device=dev, generator=gen).to(torch.bfloat16)
    per[1]["gemv_kernel_ms"] = time_ms(
        lambda: quant_matmul._rowq_launch(x1, qs, route=("gemv", 1)), iters=8)
    log(f"K1 head T=1 on gemv_kernel<1>: {per[1]['gemv_kernel_ms']:.4f} ms")
    return dict(
        name="rowq_gemv", route="cuda", source="llamatpu_torch/csrc/quant_matmul.cu",
        replaces="llamatpu/ops/pallas_matmul.py:113",
        max_abs_err=max(r["max_abs_err"] for r in per.values()),
        max_rel_err=max(r["max_rel_err"] for r in per.values()),
        tolerance="rel <= 1e-5 of max|plain| (f32 sums in another order); two runs bit-equal",
        **{k: per[1][k] for k in ("ms", "ms_source", "wrapper_ms", "plain_ms", "library_ms",
                                  "bound_ms", "bound_by")},
        library="bf16 torch.matmul", shape=f"T=1 O={V} I={D}",
        by_rows={t: per[t] for t in (8, 32)}, t1_gemv_kernel_ms=per[1]["gemv_kernel_ms"],
        edges=check_rowq_edges(dev) if edges else None)


def check_k2(dev, gen, dims=LLAMA32_1B) -> dict:
    """K2 at llama32-1b widths with 1, 8 and 32 bf16 rows against its plain
    version (within 1e-2 of the largest output: bf16 output), two runs
    bit-equal, every layer of a stack in turn (L2 stays cold), timed beside
    its bound and bf16 torch.matmul."""
    import torch

    from llamatpu_torch.ops import layer_fused

    L, D, KV, G, HD = (dims[k] for k in ("L", "D", "KV", "G", "HD"))
    O = (G * KV + 2 * KV) * HD
    wqkv = rand_rowq(L, O, D, dev, gen)
    norm = torch.rand((L, D), device=dev, generator=gen) + 0.5
    x = torch.randn((1, 1, D), device=dev, generator=gen).to(torch.bfloat16)
    got = layer_fused.qkv_norm_fused_rowq(wqkv, norm, x, 3 % L, 1e-5)
    again = layer_fused.qkv_norm_fused_rowq(wqkv, norm, x, 3 % L, 1e-5)
    want = layer_fused.qkv_norm_plain(wqkv, norm, x, 3 % L, 1e-5)
    torch.cuda.synchronize()
    assert torch.equal(got, again), "K2: two runs differ"
    abs_e, rel_e = max_err(got, want)
    assert rel_e <= 1e-2, f"K2 disagrees: max abs {abs_e} rel {rel_e}"  # bf16 output, 1-2 ulp
    li = iter(range(10**9))
    w_bf = wqkv.qs.to(torch.bfloat16)
    h = torch.randn((1, D), device=dev, generator=gen).to(torch.bfloat16)
    b_ms, b_by = bound(O * D + O * 4 + D * 2 + D * 4 + O * 2, 2 * O * D, BF16_OPS_S)
    row = dict(
        name="qkv_norm_fused_rowq", route="cuda", source="llamatpu_torch/csrc/layer_fused.cu",
        replaces="llamatpu/ops/layer_fused.py:779", max_abs_err=abs_e, max_rel_err=rel_e,
        tolerance="rel <= 1e-2 of max|plain| (bf16 output)",
        **timings(lambda: layer_fused.qkv_norm_fused_rowq(wqkv, norm, x, next(li) % L, 1e-5),
                  K2_TC, lambda: layer_fused.qkv_norm_plain(wqkv, norm, x, next(li) % L, 1e-5),
                  lambda: torch.matmul(h, w_bf[next(li) % L].T), graph=True),
        library="bf16 torch.matmul", bound_ms=b_ms, bound_by=b_by, shape=f"T=1 O={O} D={D}")
    # the B lanes of a batched decode step: 8 and 32 rows
    row["by_rows"] = {}
    for t in (8, 32):
        xt = torch.randn((t, 1, D), device=dev, generator=gen).to(torch.bfloat16)
        got = layer_fused.qkv_norm_fused_rowq(wqkv, norm, xt, 3 % L, 1e-5)
        again = layer_fused.qkv_norm_fused_rowq(wqkv, norm, xt, 3 % L, 1e-5)
        want = layer_fused.qkv_norm_plain(wqkv, norm, xt, 3 % L, 1e-5)
        torch.cuda.synchronize()
        assert torch.equal(got, again), f"K2 at {t} rows: two runs differ"
        abs_t, rel_t = max_err(got, want)
        assert rel_t <= 1e-2, f"K2 disagrees at {t} rows: max abs {abs_t} rel {rel_t}"
        ht = torch.randn((t, D), device=dev, generator=gen).to(torch.bfloat16)
        tb_ms, _ = bound(O * D + O * 4 + t * D * 2 + D * 4 + t * O * 2, 2 * t * O * D,
                         BF16_OPS_S)
        row["by_rows"][t] = dict(
            max_abs_err=abs_t, max_rel_err=rel_t, bound_ms=tb_ms,
            **timings(lambda: layer_fused.qkv_norm_fused_rowq(wqkv, norm, xt, next(li) % L, 1e-5),
                      K2_TC, lambda: layer_fused.qkv_norm_plain(wqkv, norm, xt, next(li) % L,
                                                                1e-5),
                      lambda: torch.matmul(ht, w_bf[next(li) % L].T), graph=True))
        log(f"K2 at {t} rows: {row['by_rows'][t]['ms']:.4f} ms (bound {tb_ms:.4f}, library "
            f"{row['by_rows'][t]['library_ms']:.4f}), rel err {rel_t:.3g}, two runs "
            "bit-equal")
    return row


K3_NAMES = ("attn_tail_cluster_kernel", "rtc::K3>")  # K3's attention phase and GEMV phases


def check_k3(dev, gen, dims=LLAMA32_1B, scale: float | None = None, rs: float = 1.0) -> dict:
    """K3 (append + attention + wo + FFN at T = 1) against its plain version
    at pos 0, 31, 32, 511 and S - 1 in bf16 and at 511 in f32, pos an int32
    on the card as the path passes it, at the attention scale `scale`
    (default HD ** -0.5) and residual scale `rs`: the cache bit-equal, the output
    within bf16 |d| <= 2e-2 + 1e-2|p| (1-2 ulp where the f32 sums, in
    another order, round apart), f32 |d| <= 1e-3 + 5e-4|p| (the CPU tests'
    tolerance); a second run bit-equal to the first. Timed at pos 512 on
    the cluster attention + rowq_tc.cuh route (CUDA-graph time: the phases
    overlap under programmatic dependent launch), beside the two-call
    yardstick K6 + K9 at T = 1 on the same inputs."""
    import torch

    from llamatpu_torch.ops import attention, layer_fused

    L, D, F, KV, G, HD, S = (dims[k] for k in ("L", "D", "F", "KV", "G", "HD", "S"))
    li = iter(range(10**9))  # every layer of a stack in turn (L2 stays cold)
    hdim = KV * G * HD
    wo, w13, w2 = rand_rowq(L, D, hdim, dev, gen), rand_rowq(L, 2 * F, D, dev, gen), \
        rand_rowq(L, D, F, dev, gen)
    nw = torch.rand((L, D), device=dev, generator=gen) + 0.5
    scale = HD ** -0.5 if scale is None else scale
    worst = (0.0, 0.0)
    for dt, positions in ((torch.bfloat16, (0, 31, 32, 511 % S, S - 1)),
                          (torch.float32, (511 % S,))):
        kvc = torch.randn((L, 1, KV, S, 2 * HD), device=dev, generator=gen).to(dt)
        for pos in positions:
            q4 = torch.randn((1, KV, G, HD), device=dev, generator=gen).to(dt)
            kvn = torch.randn((1, KV, 2 * HD), device=dev, generator=gen).to(dt)
            x = torch.randn((1, 1, D), device=dev, generator=gen).to(dt)
            pv = torch.tensor([pos], dtype=torch.int32, device=dev)
            c1, c2, c3 = kvc.clone(), kvc.clone(), kvc.clone()
            got, _ = layer_fused.layer_attn_tail_fused_rowq(
                wo, w13, w2, nw, q4, kvn, c1, x, pv, 5 % L, 1e-5, scale, HD, rs)
            again, _ = layer_fused.layer_attn_tail_fused_rowq(
                wo, w13, w2, nw, q4, kvn, c3, x, pv, 5 % L, 1e-5, scale, HD, rs)
            want, _ = layer_fused.layer_attn_tail_plain(
                wo, w13, w2, nw, q4, kvn, c2, x, pos, 5 % L, 1e-5, scale, HD, rs)
            torch.cuda.synchronize()
            assert torch.equal(c1, c2), f"K3 cache differs at pos {pos} ({dt})"
            assert torch.equal(got, again) and torch.equal(c1, c3), \
                f"K3: two runs differ at pos {pos} ({dt})"
            d = (got.float() - want.float()).abs()
            atol, rtol = (2e-2, 1e-2) if dt == torch.bfloat16 else (1e-3, 5e-4)
            assert bool((d <= atol + rtol * want.float().abs()).all()), \
                f"K3 disagrees at pos {pos} ({dt}): max abs {d.max().item()}"
            e = max_err(got, want)
            worst = max(worst, e)
            log(f"K3 pos {pos} {dt}: max abs {e[0]:.3g} rel {e[1]:.3g}, cache bit-equal, two "
                "runs bit-equal")
    pos = 512 % S
    kvc = torch.randn((L, 1, KV, S, 2 * HD), device=dev, generator=gen).to(torch.bfloat16)
    q4 = torch.randn((1, KV, G, HD), device=dev, generator=gen).to(torch.bfloat16)
    kvn = torch.randn((1, KV, 2 * HD), device=dev, generator=gen).to(torch.bfloat16)
    x = torch.randn((1, 1, D), device=dev, generator=gen).to(torch.bfloat16)
    pv = torch.tensor([pos], dtype=torch.int32, device=dev)
    wbytes = D * hdim + 2 * F * D + D * F + (D + 2 * F + D) * 4
    nbytes = wbytes + KV * (pos + 1) * 2 * HD * 2 + KV * 2 * HD * 2 + 2 * D * 2 + D * 4 \
        + KV * (G + 2) * HD * 2
    ops = 2 * (D * hdim + 2 * F * D + D * F) + 2 * KV * G * (pos + 1) * 2 * HD
    b_ms, b_by = bound(nbytes, ops, BF16_OPS_S)

    def two_calls():  # the yardstick: K6, then K9 at T = 1, on the same inputs
        k = next(li) % L
        a, _ = attention.decode_attention_fused_write(q4, kvn, kvc, pv, scale, k, HD)
        return layer_fused.layer_tail_fused_rowq(wo, w13, w2, nw, a.reshape(1, 1, hdim).to(x.dtype),
                                                 x, k, 1e-5, rs)
    row = dict(
        name="layer_attn_tail_fused_rowq", route="cuda", source="llamatpu_torch/csrc/layer_fused.cu",
        replaces="llamatpu/ops/layer_fused.py:416", max_abs_err=worst[0], max_rel_err=worst[1],
        tolerance="cache bit-equal; bf16 |d| <= 2e-2 + 1e-2|p|; f32 |d| <= 1e-3 + 5e-4|p|; two "
                  "runs bit-equal",
        **timings(lambda: layer_fused.layer_attn_tail_fused_rowq(
                      wo, w13, w2, nw, q4, kvn, kvc, x, pv, next(li) % L, 1e-5, scale, HD, rs),
                  K3_NAMES,
                  lambda: layer_fused.layer_attn_tail_plain(
                      wo, w13, w2, nw, q4, kvn, kvc, x, pos, next(li) % L, 1e-5, scale, HD, rs),
                  None, graph=True),
        k6_k9_ms=time_ms(two_calls), library=None, bound_ms=b_ms, bound_by=b_by,
        shape=f"pos={pos} S={S} KV={KV} G={G} hd={HD} D={D} F={F} scale={scale:.6g} rs={rs}")
    log(f"K3 at pos {pos}: {row['ms']:.5f} ms (bound {b_ms:.5f}, K6 + K9 at T = 1 "
        f"{row['k6_k9_ms']:.5f}, plain {row['plain_ms']:.4f})")
    del wo, w13, w2, kvc
    return row


def check_kernels(dev, dims=LLAMA32_1B) -> list[dict]:
    import torch

    from llamatpu_torch.ops import layer_fused

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

    rows.append(check_k1(dev, gen, dims))
    rows.append(check_k2(dev, gen, dims))

    rows.append(check_k3(dev, gen, dims))

    # ---- K4: every prefill projection shape of the paths (one layer at T = 512 is the row)
    rows.append(check_rowq_gemm(dev, bf16=False, dims=dims))
    for r in rows:
        log(f"{r['name']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
            f"plain {r['plain_ms']:.4f}, library {r['library_ms']}) err {r['max_abs_err']:.3g}")
    return rows


# K1's and K2's edges: (T, O, I) with O not a multiple of any row block, a
# split contraction, T at every fragment edge and, for K1, the passes of a
# short prefill chunk; a width that is not a multiple of 16 (gemv.cuh's route)
ROWQ_EDGES = {"K1": [(t, 1000, 2048) for t in (1, 9, 31, 32, 33, 127)]
              + [(t, 300, 200) for t in (1, 9, 31, 33)],
              "K2": [(t, 1000, 2048) for t in (1, 9, 31, 32)] + [(t, 300, 200) for t in (1, 9, 31)]}


def check_rowq_edges(dev) -> dict:
    """K1 and K2 at ROWQ_EDGES against their plain versions: K1 in bf16 and
    f32 within 1e-5 of the largest plain output (exact products, f32 sums
    in another order), K2 in bf16 within 1e-2 (bf16 output) and f32 within
    1e-5; two runs bit-equal. Returns the worst relative error per kernel,
    dtype and route."""
    import torch

    from llamatpu_torch.ops import ffn_fused, layer_fused, quant_matmul

    gen = torch.Generator(device=dev).manual_seed(15)
    worst = {}
    for t, o, i in ROWQ_EDGES["K1"]:
        qs = torch.randint(-127, 128, (2, o, i), dtype=torch.int8, device=dev, generator=gen)
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn((t, i), device=dev, generator=gen).to(dt)
            got, again = quant_matmul.rowq_gemv(x, qs[1]), quant_matmul.rowq_gemv(x, qs[1])
            want = quant_matmul.rowq_gemv_plain(x, qs[1])
            torch.cuda.synchronize()
            route = quant_matmul.rowq_route(t, i, dt)[0]
            assert torch.equal(got, again), f"K1 T={t} O={o} I={i} {dt}: two runs differ"
            abs_e, rel_e = max_err(got, want)
            assert rel_e <= 1e-5, f"K1 T={t} O={o} I={i} {dt} ({route}): {abs_e} {rel_e}"
            key = f"K1 {str(dt)[6:]} {route}"
            worst[key] = max(worst.get(key, 0.0), rel_e)
    for t, o, d in ROWQ_EDGES["K2"]:
        wqkv = rand_rowq(2, o, d, dev, gen)
        nw = torch.rand((2, d), device=dev, generator=gen) + 0.5
        for dt, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
            x = torch.randn((t, 1, d), device=dev, generator=gen).to(dt)
            got = layer_fused.qkv_norm_fused_rowq(wqkv, nw, x, 1, 1e-5)
            again = layer_fused.qkv_norm_fused_rowq(wqkv, nw, x, 1, 1e-5)
            want = layer_fused.qkv_norm_plain(wqkv, nw, x, 1, 1e-5)
            torch.cuda.synchronize()
            route = "tc" if ffn_fused.tc_route(dt, d) else "tiled"
            assert got.dtype == dt and got.shape == (t, 1, o)
            assert torch.equal(got, again), f"K2 T={t} O={o} D={d} {dt}: two runs differ"
            abs_e, rel_e = max_err(got, want)
            assert rel_e <= tol, f"K2 T={t} O={o} D={d} {dt} ({route}): {abs_e} {rel_e}"
            key = f"K2 {str(dt)[6:]} {route}"
            worst[key] = max(worst.get(key, 0.0), rel_e)
    log(f"K1 and K2 edges {ROWQ_EDGES}: worst rel {worst}, two runs bit-equal")
    return worst


# K5 / K7 per decode token at llama32-1b: 16 layers x (wqkv, wo, w13, w2) + the head
def block_shapes(dims) -> dict:
    D, F, KV, G, HD, V = (dims[k] for k in ("D", "F", "KV", "G", "HD", "V"))
    return {"wqkv": (KV * (G + 2) * HD, D), "wo": (D, KV * G * HD), "w13": (2 * F, D),
            "w2": (D, F), "head": (V, D)}


# K5 / K7's kernels as the profiler names them: the wgmma GEMM and its
# stream-K second pass (`bq_wgmma_kernel`, `bq_wgmma_reduce`; bf16 prefill
# chunks), rowq_tc.cuh's block kinds (`rowq_tc_bq_kernel<NF, rtc::K5>`, bf16
# decode rows) and the CUDA-core routes (f32 x, widths % 128 != 0)
K5_NAMES = ("bq_wgmma", "rtc::K5>", "bq_gemv_kernel", "bq_gemm_kernel")
K7_NAMES = ("bq_wgmma", "rtc::K7>", "bq_gemv_kernel", "bq_gemm_kernel")
BLOCK_CHECK_T = (1, 8, 17, 32, 33)  # + the prefill chunk: every route and its edges
BLOCK_TIMED_T = (1, 8)              # + the prefill chunk


def block_weight(o, i, packed: bool, dev, gen, layers: int = 1):
    """Random Q8_0 (packed: Q4_0 packed two a byte) weights [layers, O, I]
    with block scales whose products keep unit variance, and the values
    [layers, O, I] int8 they hold."""
    import torch

    from llamatpu_torch.models.weights import unpack4_pairs

    if packed:
        q = torch.randint(-8, 8, (layers, o, i), dtype=torch.int8, device=dev, generator=gen)
        lo, hi = q[..., 0::2].to(torch.int32) & 0xF, q[..., 1::2].to(torch.int32) & 0xF
        w = (lo | (hi << 4)).to(torch.uint8).view(torch.int8).contiguous()
        assert torch.equal(unpack4_pairs(w), q)
    else:
        q = w = torch.randint(-127, 128, (layers, o, i), dtype=torch.int8, device=dev,
                              generator=gen)
    s = (torch.rand((layers, o, i // 32), device=dev, generator=gen) * 0.001 + 0.0005) \
        * (16.0 if packed else 1.0)
    return w, s, q


def hold_block(kern, plain, x, w, s, label: str) -> tuple[float, float]:
    """One K5 / K7 call against its plain version, two runs bit-equal:
    relative to max|plain|, f32 <= 1e-5 (sums in another order), bf16 <=
    1e-3 (identical rounded operands, tensor-core f32 accumulation).
    Returns (max abs, rel)."""
    import torch

    got, again, want = kern(x, w, s), kern(x, w, s), plain(x, w, s)
    torch.cuda.synchronize()
    abs_e, rel_e = max_err(got, want)
    tol = 1e-5 if x.dtype == torch.float32 else 1e-3
    assert rel_e <= tol, f"{label}: max abs {abs_e} rel {rel_e}"
    assert torch.equal(got, again), f"{label}: two runs differ"
    assert bool(torch.isfinite(got).all()), f"{label}: non-finite output"
    return abs_e, rel_e


def check_block_matmul(dev, dims, packed: bool) -> dict:
    """K5 (packed=False) or K7 (packed=True) against its plain version at
    every main-path shape, at T in BLOCK_CHECK_T and the prefill chunk, bf16
    and f32, two runs bit-equal (hold_block); timed in bf16 at T = 1, 8 and
    the prefill chunk beside bf16 torch.matmul on the dequantized weight and
    the bound. The table row is one decode token: 16 layers' four
    projections + the head at T = 1; per_shape has every timed (shape, T)."""
    import torch

    from llamatpu_torch.ops import quant_matmul as qm

    kern = qm.packed4_matmul if packed else qm.block_matmul
    plain = qm.packed4_matmul_plain if packed else qm.block_matmul_plain
    names = K7_NAMES if packed else K5_NAMES
    gen = torch.Generator(device=dev).manual_seed(1 + packed)
    L, T = dims["L"], dims["T"]
    per, worst = {}, {"bf16": 0.0, "f32": 0.0}
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, wrapper_ms=0.0)
    abs_max = 0.0
    for name, (o, i) in block_shapes(dims).items():
        w, s, q = block_weight(o, i, packed, dev, gen)
        w, s = w[0], s[0]
        w_bf = qm.dequant_blocks(q[0], s, torch.bfloat16)
        del q
        for t in BLOCK_CHECK_T + (T,):
            for dt in (torch.bfloat16, torch.float32):
                x = torch.randn((t, i), device=dev, generator=gen).to(dt)
                key = "f32" if dt == torch.float32 else "bf16"
                abs_e, rel_e = hold_block(kern, plain, x, w, s,
                                          f"{kern.__name__} {name} T={t} {key}")
                worst[key] = max(worst[key], rel_e)
                abs_max = max(abs_max, abs_e)
            if t not in BLOCK_TIMED_T + (T,):
                continue
            xb = torch.randn((t, i), device=dev, generator=gen).to(torch.bfloat16)
            wbytes = o * (i // 2 if packed else i) + o * (i // 32) * 4
            b_ms, b_by = bound(wbytes + t * i * 2 + t * o * 4, 2 * t * o * i, BF16_OPS_S)
            iters = 4 if (name == "head" and t > 8) else 16
            route = qm.block_route(t, i, xb.dtype, packed)
            # rowq_tc.cuh's launches use programmatic dependent launch: their
            # profiler times count the overlap twice, so the CUDA graph's
            tm = timings(lambda: kern(xb, w, s), names, lambda: plain(xb, w, s),
                         lambda: torch.matmul(xb, w_bf.T), iters=iters, graph=route == "tc")
            per[f"{name} T={t}"] = dict(**tm, bound_ms=b_ms, bound_by=b_by, route=route,
                                        shape=f"T={t} O={o} I={i}")
            if t == 1:
                reps = 1 if name == "head" else L
                for k in tot:
                    tot[k] += reps * (b_ms if k == "bound_ms" else tm[k])
            log(f"{kern.__name__} {name} T={t} ({per[f'{name} T={t}']['route']}): "
                f"{tm['ms']:.4f} ms (bound {b_ms:.4f} by {b_by}, plain {tm['plain_ms']:.4f}, "
                f"bf16 matmul {tm['library_ms']:.4f})")
        del w, s, w_bf
        torch.cuda.empty_cache()
    for t in BLOCK_TIMED_T + (T,):  # one layer's four projections
        row = [per[f"{n} T={t}"] for n in ("wqkv", "wo", "w13", "w2")]
        per[f"layer T={t}"] = {k: sum(r[k] for r in row)
                               for k in ("ms", "library_ms", "bound_ms", "plain_ms")}
        log(f"{kern.__name__} a layer's four projections at T={t}: "
            f"{per[f'layer T={t}']['ms']:.4f} ms (bound {per[f'layer T={t}']['bound_ms']:.4f}, "
            f"bf16 matmul {per[f'layer T={t}']['library_ms']:.4f})")
    edges = check_block_edges(dev, packed)
    wide = check_block_wide(dev, packed)
    return dict(
        name=kern.__name__, route="cuda", source="llamatpu_torch/csrc/block_matmul.cu",
        replaces="llamatpu/ops/pallas_matmul.py:212" if packed
        else "llamatpu/ops/pallas_matmul.py:101",
        max_abs_err=max(abs_max, edges["max_abs_err"], wide["max_abs_err"]),
        max_rel_err=max(*worst.values(), edges["max_rel_err"], wide["max_rel_err"]),
        max_rel_err_by_dtype=worst,
        tolerance="rel to max|plain|: f32 <= 1e-5, bf16 <= 1e-3 (all shapes, T in "
                  f"{BLOCK_CHECK_T + (T,)}, the edges and the other paths' widths); two runs "
                  "bit-equal",
        ms=tot["ms"], ms_source=per["wo T=1"]["ms_source"], wrapper_ms=tot["wrapper_ms"],
        plain_ms=tot["plain_ms"], library_ms=tot["library_ms"],
        library="bf16 torch.matmul against the bf16-dequantized weight",
        bound_ms=tot["bound_ms"], bound_by="bytes",
        shape=f"one decode token at T=1: {L} x (wqkv+wo+w13+w2) + head", per_shape=per,
        edges=edges, wide=wide)


# K5 / K7's edges: a width whose block-scale rows are not 16-byte multiples
# (the CUDA-core routes in bf16 too), a ragged O, and a layer view qs[li] of
# a stacked weight at li > 0
BLOCK_EDGES = ((200, 2080, 0), (200, 2048, 2), (1000, 4096, 1))


def check_block_edges(dev, packed: bool) -> dict:
    """K5 / K7 at BLOCK_EDGES (O, I, li) for T in BLOCK_CHECK_T and 512, bf16
    and f32, through hold_block: the route each takes is logged."""
    import torch

    from llamatpu_torch.ops import quant_matmul as qm

    kern = qm.packed4_matmul if packed else qm.block_matmul
    plain = qm.packed4_matmul_plain if packed else qm.block_matmul_plain
    gen = torch.Generator(device=dev).manual_seed(17 + packed)
    worst, abs_max, routes = 0.0, 0.0, {}
    for o, i, li in BLOCK_EDGES:
        w, s, _ = block_weight(o, i, packed, dev, gen, layers=li + 1)
        w, s = w[li], s[li]  # views: the layer's base pointer inside the stack
        for t in BLOCK_CHECK_T + (512,):
            for dt in (torch.bfloat16, torch.float32):
                x = torch.randn((t, i), device=dev, generator=gen).to(dt)
                label = f"{kern.__name__} edge O={o} I={i} li={li} T={t} {str(dt)[6:]}"
                abs_e, rel_e = hold_block(kern, plain, x, w, s, label)
                worst, abs_max = max(worst, rel_e), max(abs_max, abs_e)
                routes[label] = qm.block_route(t, i, dt, packed)
    log(f"{kern.__name__} edges {BLOCK_EDGES} at T {BLOCK_CHECK_T + (512,)}, bf16 and f32: "
        f"worst rel {worst:.3g}, two runs bit-equal; routes "
        f"{sorted(set(routes.values()))}")
    return dict(max_rel_err=worst, max_abs_err=abs_max, routes=routes)


def block_wide_cases() -> list[tuple[str, int, int, tuple]]:
    """(label, O, I, rows) of K5 / K7 at the other GGUF paths' widths: the
    Phi-3-medium GGUF's four projections at decode rows, served lanes, a
    short chunk and the prefill chunk and its head at decode rows (`cli run`
    and `serve`), and Qwen1.5-MoE's attention projection (its prefill chunk):
    the plans the Llama widths do not reach (stream-K over 140 K stages of
    w2, tiles shared beside whole ones, two x blocks a tile at I = 5120)."""
    phi3 = block_shapes(PHI3_MEDIUM)
    cases = [(f"phi3 {n}", *phi3[n], (1, 8, 33, 512)) for n in ("wqkv", "wo", "w13", "w2")]
    cases.append(("phi3 head", *phi3["head"], (1, 8)))
    cases.append(("qwen15 wqkv", QWEN15["KV"] * (QWEN15["G"] + 2) * QWEN15["HD"], QWEN15["D"],
                  (8, QWEN15["T"])))
    return cases


def check_block_wide(dev, packed: bool) -> dict:
    """K5 / K7 at `block_wide_cases`, bf16 and f32, through hold_block; each
    bf16 case's route and plan logged (wgmma: x blocks a tile, shared tiles,
    CTAs, tiles, whole tiles, K stages; tc: g, splits, ksl, CTAs)."""
    import torch

    from llamatpu_torch.ops import quant_matmul as qm
    from llamatpu_torch.ops.gemm import _sm_count

    kern = qm.packed4_matmul if packed else qm.block_matmul
    plain = qm.packed4_matmul_plain if packed else qm.block_matmul_plain
    gen = torch.Generator(device=dev).manual_seed(29 + packed)
    sms = _sm_count(dev.index or 0)
    worst, abs_max, plans = {"bf16": 0.0, "f32": 0.0}, 0.0, {}
    for label, o, i, rows in block_wide_cases():
        w, s, _ = block_weight(o, i, packed, dev, gen)
        w, s = w[0], s[0]
        for t in rows:
            route = qm.block_route(t, i, torch.bfloat16, packed)
            plan = qm.block_plan(t, o, i, route, packed, sms)
            if route == "wgmma":
                walk, nx = plan
                desc = (f"nx {nx} split {walk.split} ctas {walk.ctas} tiles {walk.tiles} "
                        f"whole {walk.tiles_dp} nk {walk.nk}")
            else:
                desc = f"(g, splits, ksl, ctas) {plan.args}"
            for dt, key in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
                x = torch.randn((t, i), device=dev, generator=gen).to(dt)
                name = f"{kern.__name__} {label} O={o} I={i} T={t} {key}"
                abs_e, rel_e = hold_block(kern, plain, x, w, s, name)
                worst[key], abs_max = max(worst[key], rel_e), max(abs_max, abs_e)
            plans[f"{label} T={t}"] = f"{route}: {desc}"
            log(f"{kern.__name__} {label} O={o} I={i} T={t}: bf16 {route} {desc}; bf16 and f32 "
                "within tolerance, two runs bit-equal")
        del w, s
        torch.cuda.empty_cache()
    log(f"{kern.__name__} at the other paths' widths: worst rel bf16 {worst['bf16']:.3g}, "
        f"f32 {worst['f32']:.3g}")
    return dict(max_rel_err=max(worst.values()), max_rel_err_by_dtype=worst,
                max_abs_err=abs_max, plans=plans)


def check_attention(dev, dims, sweep: bool = True) -> dict:
    """K6 against its plain version: cache bit-equal everywhere, output
    within 1e-5 in f32 (bf16 cache: 1e-5 too, the cast rows are the same),
    at pos 0, 31, 32, 511, S-1 on S = dims["S"] and at pos 8191 on S = 9216
    (the physical length of an 8192-row cache), and 8 lanes at distinct
    positions with one parked at S - 1. Timed by time_dense (sweep: every
    cluster size, warm and cold, at two cache lengths; else the plan's)."""
    import torch

    from llamatpu_torch.models.transformer import physical_cache_len
    from llamatpu_torch.ops import attention

    gen = torch.Generator(device=dev).manual_seed(3)
    KV, G, HD, S = dims["KV"], dims["G"], dims["HD"], dims["S"]
    scale = HD ** -0.5
    worst = worst_abs = 0.0
    long_s = physical_cache_len(8192, 512)
    cases = [(S, p, dt) for p in (0, 31, 32, 511 % S, S - 1)
             for dt in (torch.bfloat16, torch.float32)]
    cases += [(long_s, 8191, torch.bfloat16), (long_s, 8191, torch.float32)]
    for s_len, pos, dt in cases:
        kvc = torch.randn((2, 1, KV, s_len, 2 * HD), device=dev, generator=gen).to(dt)
        q = torch.randn((1, KV, G, HD), device=dev, generator=gen).to(dt)
        kvn = torch.randn((1, KV, 2 * HD), device=dev, generator=gen).to(dt)
        pv = torch.tensor([pos], dtype=torch.int32, device=dev)
        c1, c2 = kvc.clone(), kvc.clone()
        got, _ = attention.decode_attention_fused_write(q, kvn, c1, pv, scale, 1, HD)
        want, _ = attention.decode_attention_fused_write_plain(q, kvn, c2, pv, scale, 1, HD)
        torch.cuda.synchronize()
        assert torch.equal(c1, c2), f"K6 cache differs at pos {pos} S {s_len} ({dt})"
        abs_e, rel_e = max_err(got, want)
        assert rel_e <= 1e-5, f"K6 disagrees at pos {pos} S {s_len} ({dt}): {abs_e} {rel_e}"
        worst, worst_abs = max(worst, rel_e), max(worst_abs, abs_e)
        log(f"K6 pos {pos} S {s_len} {dt}: max abs {abs_e:.3g} rel {rel_e:.3g}, cache bit-equal")

    # the dense batched cache: 8 lanes at distinct positions, lane 7 parked at
    # the last physical row as BatchEngine parks an inactive lane
    B = 8
    lanes = torch.tensor([0, 31, 32, 100, 511 % S, 700 % S, S - 2, S - 1], dtype=torch.int32,
                         device=dev)
    for dt in (torch.bfloat16, torch.float32):
        kvc = torch.randn((2, B, KV, S, 2 * HD), device=dev, generator=gen).to(dt)
        qb = torch.randn((B, KV, G, HD), device=dev, generator=gen).to(dt)
        kvnb = torch.randn((B, KV, 2 * HD), device=dev, generator=gen).to(dt)
        c1, c2 = kvc.clone(), kvc.clone()
        got, _ = attention.decode_attention_fused_write(qb, kvnb, c1, lanes, scale, 1, HD)
        want, _ = attention.decode_attention_fused_write_plain(qb, kvnb, c2, lanes, scale, 1, HD)
        torch.cuda.synchronize()
        assert torch.equal(c1, c2), f"K6 cache differs at B = {B} ({dt})"
        abs_e, rel_e = max_err(got, want)
        assert rel_e <= 1e-5, f"K6 disagrees at B = {B} ({dt}): {abs_e} {rel_e}"
        worst, worst_abs = max(worst, rel_e), max(worst_abs, abs_e)
        log(f"K6 B {B} lanes {lanes.tolist()} {dt}: max abs {abs_e:.3g} rel {rel_e:.3g}, "
            "cache bit-equal")
    del kvc, c1, c2
    return dict(
        name="decode_attention_fused_write", route="cuda", source="llamatpu_torch/csrc/attention.cu",
        replaces="llamatpu/ops/pallas_attention.py:718", max_abs_err=worst_abs, max_rel_err=worst,
        tolerance="cache bit-equal; rel to max|plain| <= 1e-5 (bf16 and f32 caches)",
        **time_dense(dev, dims, quant=False, seed=4, sweep=sweep))


DENSE = ("dense_cluster_kernel",)  # K6 and K6-int8: one launch, clusters of CTAs


def dense_case(dev, gen, layers: int, b: int, kvh: int, g: int, hd: int, s_len: int, dt):
    """A random stacked dense cache [L, B, KV, S, 2 hd] (f32, bf16, or int8
    with its scale rows [L, B, KV, 2, S] through quantize_kv), q (bf16; f32
    for an f32 cache) and this token's rows (int8 with scales [B, KV, 2]
    under int8): (q, kvn, sn, kvc, sc), sn and sc None but under int8."""
    import torch

    x = torch.randn((layers, b, kvh, s_len, 2 * hd), device=dev, generator=gen)
    new = torch.randn((b, kvh, 1, 2 * hd), device=dev, generator=gen)
    q = torch.randn((b, kvh, g, hd), device=dev, generator=gen)
    q = q.to(torch.float32 if dt == torch.float32 else torch.bfloat16)
    if dt == torch.int8:
        kvc, sc = int8_rows(x)
        kvn, sn = int8_rows(new)
        return q, kvn[:, :, 0], sn[..., 0], kvc, sc
    return q, new[:, :, 0].to(dt), None, x.to(dt), None


def fused_dense(attention, plain: bool, q, kvn, sn, kvc, sc, pv, scale, li, hd):
    """One K6 call (or its int8 variant, or either plain version): the output."""
    if sc is None:
        fn = attention.decode_attention_fused_write_plain if plain \
            else attention.decode_attention_fused_write
        return fn(q, kvn, kvc, pv, scale, li, hd)[0]
    fn = attention.decode_attention_fused_write_q_plain if plain \
        else attention.decode_attention_fused_write_q
    return fn(q, kvn, sn, kvc, sc, pv, scale, li, hd)[0]


def short_caches(dt) -> tuple[int, int]:
    """Cache lengths K6 is timed and checked at: the main path's 1152 rows
    and the largest short cache the engine allocates in that dtype (bf16:
    8160 rows under 16 KB a stripe; int8: 15360, physical_cache_len rounding
    to 1024 past 8192; f32: 4064)."""
    import torch

    return 1152, {torch.float32: 4064, torch.bfloat16: 8160, torch.int8: 15360}[dt]


def time_dense(dev, dims, quant: bool, seed: int, sweep: bool = True) -> dict:
    """K6 (or K6-int8) at pos 512 of the Llama-3.2-1B geometry `dims`: B = 1
    and 8 lanes, the main path's 1152-row cache and the largest short cache
    (8160 bf16, 15360 int8), warm (one layer replayed: its live rows stay in
    L2) and cold (a stacked cache cycled through layers whose live rows pass
    50 MB between two reads of one layer, as in a decode step), under the
    plan and every cluster size at 16- and 32-row stages, beside the plain
    version and GQA SDPA over contiguous (dequantized) bf16 K and V prepared
    beforehand. The row's own numbers are B = 1 at 1152 rows under the plan;
    sweep=False times only that."""
    import torch

    from llamatpu_torch.ops import attention as A

    gen = torch.Generator(device=dev).manual_seed(seed)
    KV, G, HD = dims["KV"], dims["G"], dims["HD"]
    W, scale, pos = 2 * HD, HD ** -0.5, 512
    dt = torch.int8 if quant else torch.bfloat16
    row_bytes = W + 8 if quant else 2 * W
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tag = "K6-int8" if quant else "K6"
    per = {}
    for b in ((1, 8) if sweep else (1,)):
        for s_len in (short_caches(dt) if sweep else (dims["S"],)):
            live = b * KV * (pos + 1) * row_bytes
            layers = -(-64_000_000 // live) + 1 if sweep else 2
            q, kvn, sn, kvc, sc = dense_case(dev, gen, layers, b, KV, G, HD, s_len, dt)
            pv = torch.full((b,), pos, dtype=torch.int32, device=dev)
            library, lib_name = sdpa_yardstick(q, *dense_kv(kvc, sc, 1, pos + 1, HD), scale)
            b_ms, b_by = bound(attn_bytes(b, KV, G, HD, pos + 1, row_bytes, row_bytes),
                               b * 2 * KV * G * (pos + 1) * W, BF16_OPS_S)
            plan = A.plan_dense(b, KV, s_len, W, kvc.element_size(), sms)
            tm = timings(lambda: fused_dense(A, False, q, kvn, sn, kvc, sc, pv, scale, 1, HD),
                         DENSE,
                         lambda: fused_dense(A, True, q, kvn, sn, kvc, sc, pv, scale, 1, HD),
                         library)
            row = dict(**tm, library=lib_name, bound_ms=b_ms, bound_by=b_by,
                       cluster=plan.cluster, stage_rows=plan.rows,
                       shape=f"B={b} lanes at pos={pos} S={s_len} KV={KV} G={G} hd={HD}")
            if sweep:
                cycle = iter(range(10**9))
                row["ms_cold"] = kernel_ms(lambda: fused_dense(
                    A, False, q, kvn, sn, kvc, sc, pv, scale, next(cycle) % layers, HD), DENSE)
                row["cold_layers"] = layers
                row["by_plan"] = {}  # every cluster size at 16- and 32-row stages
                for c in (1, 2, 4, 8):
                    for r in (16, 32):
                        with forced_cluster(A, c, "plan_dense", rows=r):
                            row["by_plan"][f"C{c} R{r}"] = dict(
                                ms=kernel_ms(lambda: fused_dense(A, False, q, kvn, sn, kvc, sc,
                                                                 pv, scale, 1, HD), DENSE),
                                ms_cold=kernel_ms(lambda: fused_dense(
                                    A, False, q, kvn, sn, kvc, sc, pv, scale,
                                    next(cycle) % layers, HD), DENSE))
            per.setdefault(b, {})[s_len] = row
            log(f"{tag} B {b} at pos {pos} S {s_len}: {row['ms']:.5f} ms warm"
                + (f", {fmt_ms(row['ms_cold'])} cold over {layers} layers" if sweep else "")
                + f" (bound {b_ms:.5f} by {b_by}, plain {row['plain_ms']:.4f}, sdpa "
                f"{row['library_ms']:.5f}); cluster {plan.cluster} of {plan.rows}-row stages"
                + ("; warm / cold by plan " + ", ".join(
                    f"{k}: {fmt_ms(v['ms'])} / {fmt_ms(v['ms_cold'])}"
                    for k, v in row["by_plan"].items())
                   if sweep else ""))
            del q, kvn, sn, kvc, sc
            torch.cuda.empty_cache()
    top = per[1][short_caches(dt)[0] if sweep else dims["S"]]
    return dict({k: top[k] for k in ("ms", "ms_source", "wrapper_ms", "plain_ms", "library_ms",
                                     "library", "bound_ms", "bound_by", "shape", "cluster",
                                     "stage_rows")},
                **({"ms_cold": top["ms_cold"]} if sweep else {}), by_lanes=per)


# K6's edge geometries: (label, KV heads, G, head dim), each at 8 lanes
DENSE_EDGE_GEOMETRIES = (("llama32-1b", 8, 4, 64), ("qwen15-moe", 16, 1, 128),
                         ("phi3-medium", 10, 4, 128), ("qwen3-0.6b", 8, 2, 128))


def check_dense_edges(dev) -> dict:
    """K6 and K6-int8 against their plain versions at f32, bf16 and int8
    caches, the geometries of DENSE_EDGE_GEOMETRIES (hd 64 G 4; hd 128 G 1;
    hd 128 G 4 on 10 KV heads) and every cluster size, at 1152 rows and the
    largest short cache of the dtype (short_caches): 8 lanes at pos 0, R - 1,
    R, 4 R, 8 R (rank boundaries; R the stage rows), one random, one parked
    at S - 1 and one at pos -1 (NaN in every output, nothing written). Over
    the other lanes: rel <= 1e-5 of max|plain|, finite, the cache and scale
    rows equal to the plain version's with only row pos changed; two runs
    give the same bits."""
    import torch

    from llamatpu_torch.ops import attention as A

    gen = torch.Generator(device=dev).manual_seed(41)
    cases, worst = 0, {}
    B, nan_lane = 8, 7
    keep = torch.arange(B, device=dev) != nan_lane
    for label, KV, G, HD in DENSE_EDGE_GEOMETRIES:
        for dt in (torch.float32, torch.bfloat16, torch.int8):
            for s_len in short_caches(dt):
                q, kvn, sn, kvc, sc = dense_case(dev, gen, 2, B, KV, G, HD, s_len, dt)
                R = A.plan_dense(B, KV, s_len, 2 * HD, kvc.element_size()).rows
                rnd = int(torch.randint(0, s_len, (1,), generator=torch.Generator().manual_seed(s_len)))
                positions = [min(p, s_len - 1) for p in (0, R - 1, R, 4 * R, 8 * R)] + \
                    [rnd, s_len - 1, -1]
                pv = torch.tensor(positions, dtype=torch.int32, device=dev)
                c2 = kvc.clone()
                s2 = None if sc is None else sc.clone()
                want = fused_dense(A, True, q, kvn, sn, c2, s2, pv, HD ** -0.5, 1, HD)
                written = torch.zeros(kvc.shape[:-1], dtype=torch.bool, device=dev)
                written[1, torch.arange(B - 1, device=dev), :, pv[:-1].long()] = True
                for c in (1, 2, 4, 8):
                    what = f"K6 edges {label} {dt} S {s_len} cluster {c}"
                    outs = []
                    for _ in range(2):
                        c1 = kvc.clone()
                        s1 = None if sc is None else sc.clone()
                        with forced_cluster(A, c, "plan_dense"):
                            got = fused_dense(A, False, q, kvn, sn, c1, s1, pv, HD ** -0.5, 1, HD)
                        torch.cuda.synchronize()
                        outs.append(got)
                        assert torch.equal(c1[:, :-1], c2[:, :-1]), f"{what}: cache differs"
                        assert not ((c1 != kvc).any(dim=-1) & ~written).any(), \
                            f"{what}: another row written"
                        if sc is not None:
                            assert torch.equal(s1[:, :-1], s2[:, :-1]), f"{what}: scales differ"
                            assert not ((s1 != sc).any(dim=-2) & ~written).any(), \
                                f"{what}: another scale written"
                    assert bool(torch.isnan(outs[0][nan_lane]).all()), f"{what}: pos -1 not NaN"
                    assert bool(torch.isfinite(outs[0][keep]).all()), f"{what}: not finite"
                    assert torch.equal(outs[0][keep], outs[1][keep]), f"{what}: runs differ"
                    abs_e, rel_e = max_err(outs[0][keep], want[keep])
                    assert rel_e <= 1e-5, f"{what}: max abs {abs_e} rel {rel_e}"
                    key = f"{label} {dt}".replace("torch.", "")
                    worst[key] = max(worst.get(key, 0.0), rel_e)
                    cases += 1
                del q, kvn, sn, kvc, sc, c1, s1, c2, s2
    torch.cuda.empty_cache()
    log(f"K6 edges: {cases} cases (f32/bf16/int8, 1152 rows and the largest short caches, "
        f"clusters 1/2/4/8, two runs each bit-equal) within rel 1e-5: worst {worst}")
    return dict(cases=cases, worst_rel_err=worst,
                tolerance="rel to max|plain| <= 1e-5 over the lanes with pos >= 0; pos -1 NaN "
                          "and nothing written; cache and scale rows as the plain version's, "
                          "only row pos changed; two runs bit-equal")


def paged_tables(positions, parked, maxblk: int, nblk: int, bs: int, seed: int):
    """Block tables of a shuffled allocator state: each lane owns the blocks
    its rows 0..pos need, drawn from a random permutation of the pool; the
    rest of its row, and a parked lane's whole row, is the trash block."""
    import torch

    perm = torch.randperm(nblk - 1, generator=torch.Generator().manual_seed(seed)).tolist()
    tables = torch.full((len(positions), maxblk), nblk - 1, dtype=torch.int32)
    for b, p in enumerate(positions):
        if b not in parked:
            for j in range(p // bs + 1):
                tables[b, j] = perm.pop()
    return tables


PAGED = ("paged_cluster_kernel",)  # K8 and K8-int8: one launch, clusters of CTAs
PAGED_CLUSTERS = (1, 2, 4, 8)  # every cluster size ops/attention.plan_paged can pick


def forced_cluster(attention, c: int, planner_name: str = "plan_paged", rows: int | None = None,
                   parts: int | None = None):
    """A context in which K8's planner (or K6's, "plan_dense", or K14's and
    K15's, "plan_stripe") keeps its stages (or takes `rows`) but takes
    cluster c (and, "plan_stripe", `parts` clusters a head)."""
    import contextlib
    import dataclasses

    @contextlib.contextmanager
    def ctx():
        planner = getattr(attention, planner_name)
        forced = dict(cluster=c)
        if rows is not None:
            forced["rows"] = rows
        if parts is not None:
            forced["parts"] = parts
        setattr(attention, planner_name,
                lambda *a, **kw: dataclasses.replace(planner(*a, **kw), **forced))
        try:
            yield
        finally:
            setattr(attention, planner_name, planner)
    return ctx()


def paged_pool(dev, gen, layers: int, nblk: int, kvh: int, bs: int, width: int, dt):
    """A random stacked pool [L, NBLK, KV, BS, W] (f32, bf16, or int8 with its
    scale pool [L, NBLK, KV, 2, BS] through quantize_kv), scale pool or None."""
    import torch

    x = torch.randn((layers, nblk, kvh, bs, width), device=dev, generator=gen)
    if dt == torch.int8:
        return int8_rows(x)
    return x.to(dt), None


def time_paged(dev, dims, quant: bool, seed: int) -> dict:
    """K8 (or K8-int8) at B = 8 lanes of a shuffled pool at pos 512 (block
    16, lanes up to 2048 rows, 512 blocks): the kernel warm (the same layer
    replayed: its live rows stay in L2) and cold (a stacked pool cycled
    through layers whose live rows pass 50 MB between two reads of one
    layer, as in a serving step), under every cluster size, beside its plain
    version, GQA SDPA over a dense (dequantized) view prepared beforehand,
    and the same with the gather inside the timed call."""
    import torch
    import torch.nn.functional as F

    from llamatpu_torch.ops import attention as A

    gen = torch.Generator(device=dev).manual_seed(seed)
    KV, G, HD = dims["KV"], dims["G"], dims["HD"]
    B, BS, MAXLEN, pos = 8, 16, 2048, 512
    W, scale = 2 * HD, HD ** -0.5
    maxblk = MAXLEN // BS
    nblk = B * maxblk // 2
    nb = pos // BS + 1
    tables = paged_tables([pos] * B, set(), maxblk, nblk, BS, seed=seed).to(dev)
    pv = torch.full((B,), pos, dtype=torch.int32, device=dev)
    q = torch.randn((B, KV, G, HD), device=dev, generator=gen).to(torch.bfloat16)
    row_bytes = W + 8 if quant else 2 * W
    live = B * KV * (pos + 1) * row_bytes
    layers = -(-64_000_000 // live) + 1  # > 50 MB of other layers' rows between two reads
    pool, spool = paged_pool(dev, gen, layers, nblk, KV, BS, W,
                             torch.int8 if quant else torch.bfloat16)
    fn = A.decode_attention_paged_q if quant else A.decode_attention_paged
    plain = A.decode_attention_paged_q_plain if quant else A.decode_attention_paged_plain
    args = lambda li: (q, pool, spool, tables, pv, scale, HD, li) if quant \
        else (q, pool, tables, pv, scale, HD, li)  # noqa: E731
    tl = tables[:, :nb].long()

    def gathered(li):  # the lane's rows as contiguous bf16 K and V [B, KV, pos + 1, hd]
        kv = pool[li][tl].permute(0, 2, 1, 3, 4).reshape(B, KV, nb * BS, W)[:, :, : pos + 1]
        if quant:
            sc = spool[li][tl].permute(0, 2, 3, 1, 4).reshape(B, KV, 2, nb * BS)[..., : pos + 1]
            kv = torch.cat([kv[..., :HD] * sc[:, :, 0, :, None],
                            kv[..., HD:] * sc[:, :, 1, :, None]], dim=-1).to(torch.bfloat16)
        return kv[..., :HD], kv[..., HD:]

    library, lib_name = sdpa_yardstick(q, *(t.contiguous() for t in gathered(1)), scale)
    gqa = "GQA" in lib_name
    qs = q.reshape(B, KV * G, 1, HD)

    def library_gather():
        k, v = gathered(1)
        if not gqa:
            k, v = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
        return F.scaled_dot_product_attention(qs, k, v, scale=scale, enable_gqa=True) if gqa \
            else F.scaled_dot_product_attention(qs, k, v, scale=scale)

    nbytes = B * KV * (pos + 1) * row_bytes + B * KV * G * HD * 2 + B * nb * 4 + B * 4 \
        + B * KV * G * HD * 4
    b_ms, b_by = bound(nbytes, B * 2 * KV * G * (pos + 1) * W, BF16_OPS_S)
    tm = timings(lambda: fn(*args(1)), PAGED, lambda: plain(*args(1)), library)
    tm["library_gather_ms"] = time_ms(library_gather)
    cycle = iter(range(10**9))
    tm["ms_cold"] = kernel_ms(lambda: fn(*args(next(cycle) % layers)), PAGED)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = A.plan_paged(B, KV, maxblk, W, pool.element_size(), sms)
    by_cluster = {}
    for c in PAGED_CLUSTERS:
        with forced_cluster(A, c):
            by_cluster[c] = dict(ms=kernel_ms(lambda: fn(*args(1)), PAGED),
                                 ms_cold=kernel_ms(lambda: fn(*args(next(cycle) % layers)), PAGED))
    tag = "K8-int8" if quant else "K8"
    log(f"{tag} B {B} at pos {pos}: {tm['ms']:.5f} ms warm, {fmt_ms(tm['ms_cold'])} cold over "
        f"{layers} layers (bound {b_ms:.5f} by {b_by}, plain {tm['plain_ms']:.4f}, sdpa "
        f"{tm['library_ms']:.5f}, with the gather {tm['library_gather_ms']:.5f}); cluster "
        f"{plan.cluster} of {plan.rows}-row stages; by cluster " + ", ".join(
            f"{c}: {fmt_ms(v['ms'])} / {fmt_ms(v['ms_cold'])}" for c, v in by_cluster.items()))
    del pool, spool
    torch.cuda.empty_cache()
    return dict(**tm, library=lib_name + (" (gathered and dequantized beforehand)" if quant
                                          else " (gathered beforehand)"),
                library_gather="the same with the gather (and dequantization) in the call",
                bound_ms=b_ms, bound_by=b_by, cluster=plan.cluster, stage_rows=plan.rows,
                cold_layers=layers, by_cluster=by_cluster,
                shape=f"B={B} lanes at pos={pos} BS={BS} MAXBLK={maxblk} NBLK={nblk} KV={KV} "
                      f"G={G} hd={HD}")


def check_paged_attention(dev, dims=LLAMA32_1B) -> dict:
    """K8 against its plain version at the geometry `dims`, B = 8 lanes of a
    shuffled pool (block size 16, lanes up to 2048 rows, the engine's default
    pool of 512 blocks), bf16 and f32 pools: lanes at pos 0, 15, 16, 100,
    511, 1023 and 2047 and one parked at the trash block; output within 1e-5
    of the largest plain |value|, the pool unchanged. Timed by time_paged."""
    import torch

    from llamatpu_torch.ops import attention

    gen = torch.Generator(device=dev).manual_seed(8)
    KV, G, HD = dims["KV"], dims["G"], dims["HD"]
    B, BS, MAXLEN = 8, 16, 2048
    maxblk = MAXLEN // BS
    nblk = B * maxblk // 2
    scale = HD ** -0.5
    positions = [0, 15, 16, 100, 511, 1023, 2047, 700]
    tables = paged_tables(positions, {7}, maxblk, nblk, BS, seed=8).to(dev)
    pv = torch.tensor(positions, dtype=torch.int32, device=dev)
    worst = worst_abs = 0.0
    for dt in (torch.bfloat16, torch.float32):
        pool = torch.randn((2, nblk, KV, BS, 2 * HD), device=dev, generator=gen).to(dt)
        q = torch.randn((B, KV, G, HD), device=dev, generator=gen).to(dt)
        before = pool.clone()
        got = attention.decode_attention_paged(q, pool, tables, pv, scale, HD, 1)
        want = attention.decode_attention_paged_plain(q, pool, tables, pv, scale, HD, 1)
        torch.cuda.synchronize()
        assert torch.equal(pool, before), f"K8 wrote the pool ({dt})"
        abs_e, rel_e = max_err(got, want)
        assert rel_e <= 1e-5, f"K8 disagrees ({dt}): max abs {abs_e} rel {rel_e}"
        assert bool(torch.isfinite(got).all())
        worst, worst_abs = max(worst, rel_e), max(worst_abs, abs_e)
        log(f"K8 {dt} lanes {positions} (lane 7 parked): max abs {abs_e:.3g} rel {rel_e:.3g}")
    del pool, before
    return dict(
        name="decode_attention_paged", route="cuda", source="llamatpu_torch/csrc/attention.cu",
        replaces="llamatpu/ops/pallas_attention.py:617", max_abs_err=worst_abs, max_rel_err=worst,
        tolerance="rel to max|plain| <= 1e-5 (bf16 and f32 pools); the pool is not written",
        **time_paged(dev, dims, quant=False, seed=9))


# K8's edge geometries: (label, lanes, KV heads, G, head dim, MAXLEN)
PAGED_EDGE_GEOMETRIES = (("llama32-1b", 8, 8, 4, 64, 2304), ("qwen15-moe", 8, 16, 1, 128, 256),
                         ("phi3-medium", 24, 10, 4, 128, 256))


def check_paged_edges(dev) -> dict:
    """K8 and K8-int8 against their plain versions at block sizes 8 and 16,
    f32, bf16 and int8 pools, the geometries of PAGED_EDGE_GEOMETRIES (hd 64
    G 4; hd 128 G 1; hd 128 G 4 with 24 lanes of 10 KV heads) and every
    cluster size: lanes at pos 0, BS - 1, BS, a block boundary in the
    middle and MAXLEN - 1 (llama32-1b's 2304 rows at BS 8 give a one-CTA
    cluster more table entries than it holds in shared memory), one parked
    at the trash block, one at pos -1 (NaN in every output), the others
    random; rel <= 1e-5 of max|plain| over the other lanes, finite, the pool
    and scale pool unchanged."""
    import torch

    from llamatpu_torch.ops import attention as A

    gen = torch.Generator(device=dev).manual_seed(31)
    cases, worst = 0, {}
    for label, B, KV, G, HD, MAXLEN in PAGED_EDGE_GEOMETRIES:
        for BS in (8, 16):
            maxblk = MAXLEN // BS
            nblk = B * maxblk + 1
            rnd = torch.randint(0, MAXLEN, (B,), generator=torch.Generator().manual_seed(BS))
            positions = [0, BS - 1, BS, (maxblk // 2) * BS, MAXLEN - 1, MAXLEN // 3 + 1, -1] + \
                rnd.tolist()[7:]
            parked, nan_lane = 5, 6
            tables = paged_tables([max(p, 0) for p in positions], {parked, nan_lane}, maxblk,
                                  nblk, BS, seed=BS).to(dev)
            pv = torch.tensor(positions, dtype=torch.int32, device=dev)
            keep = torch.arange(B, device=dev) != nan_lane
            for dt in (torch.float32, torch.bfloat16, torch.int8):
                pool, spool = paged_pool(dev, gen, 2, nblk, KV, BS, 2 * HD, dt)
                q = torch.randn((B, KV, G, HD), device=dev, generator=gen)
                q = q.to(torch.bfloat16 if dt == torch.bfloat16 else torch.float32)
                before = (pool.clone(), None if spool is None else spool.clone())
                want = A.decode_attention_paged_plain(q, pool, tables, pv, HD ** -0.5, HD, 1,
                                                      scale_pool=spool)
                for c in PAGED_CLUSTERS:
                    with forced_cluster(A, c):
                        got = A.decode_attention_paged(q, pool, tables, pv, HD ** -0.5, HD, 1,
                                                       scale_pool=spool)
                    torch.cuda.synchronize()
                    what = f"K8 edges {label} BS {BS} {dt} cluster {c}"
                    assert torch.equal(pool, before[0]) and (
                        spool is None or torch.equal(spool, before[1])), f"{what}: pool written"
                    assert bool(torch.isnan(got[nan_lane]).all()), f"{what}: pos -1 not NaN"
                    assert bool(torch.isfinite(got[keep]).all()), f"{what}: not finite"
                    abs_e, rel_e = max_err(got[keep], want[keep])
                    assert rel_e <= 1e-5, f"{what}: max abs {abs_e} rel {rel_e}"
                    key = f"{label} {dt}".replace("torch.", "")
                    worst[key] = max(worst.get(key, 0.0), rel_e)
                    cases += 1
                del pool, spool, before
    torch.cuda.empty_cache()
    log(f"K8 edges: {cases} cases (BS 8 and 16, f32/bf16/int8, clusters {PAGED_CLUSTERS}) "
        f"within rel 1e-5: worst {worst}")
    return dict(cases=cases, worst_rel_err=worst,
                tolerance="rel to max|plain| <= 1e-5 over the lanes with pos >= 0; pos -1 NaN; "
                          "pool and scale pool unchanged")


TAIL_EDGE_ROWS = (1, 2, 7, 8, 9, 16, 17, 31, 32)
TAIL_UNALIGNED = (200, 196, 324)  # (D, H, F): multiples of 4, not of 16 (gemv.cuh in bf16)
TAIL_UNALIGNED_ROWS = (1, 8, 9, 32)  # both of gemv.cuh's row templates (8 and 32)


def check_tail(dev, dims=LLAMA32_1B) -> dict:
    """K9 against its plain version at llama32-1b widths: T in 1, 2, 7, 8,
    9, 16, 17, 31 and 32 rows (every x-fragment count and its edges), rs 1
    and 0.5, bf16 (rowq_tc.cuh) and f32 (gemv.cuh) activations: f32 within
    1e-5 of the largest plain output (sums in another order), bf16 within
    1e-2 (h and act round to bf16, so a sum that rounds the other way moves
    one bf16 ulp); two runs bit-equal; None at 33 rows. Then bf16 at widths
    that are not multiples of 16 (`TAIL_UNALIGNED`: gemv.cuh's route) within
    1e-2, two runs bit-equal. Timed at T = 1, 8 and 32 (bf16)."""
    import torch

    from llamatpu_torch.ops import layer_fused

    gen = torch.Generator(device=dev).manual_seed(9)
    L, D, F, KV, G, HD = (dims[k] for k in ("L", "D", "F", "KV", "G", "HD"))
    H = KV * G * HD

    def tail_weights(n, d, h, f):
        return (rand_rowq(n, d, h, dev, gen), rand_rowq(n, 2 * f, d, dev, gen),
                rand_rowq(n, d, f, dev, gen), torch.rand((n, d), device=dev, generator=gen) + 0.5)

    def case(ws, t, rs, dt, key, tol):
        """One K9 call checked: (abs err, rel err)."""
        d, h = ws[0].qs.shape[1:]
        li = 5 % ws[0].qs.shape[0]
        attn = torch.randn((t, h), device=dev, generator=gen).to(dt)
        x = torch.randn((t, d), device=dev, generator=gen).to(dt)
        got = layer_fused.layer_tail_fused_rowq(*ws, attn, x, li, 1e-5, rs)
        again = layer_fused.layer_tail_fused_rowq(*ws, attn, x, li, 1e-5, rs)
        want = layer_fused.layer_tail_plain(*ws, attn, x, li, 1e-5, rs)
        torch.cuda.synchronize()
        assert got.dtype == dt and got.shape == x.shape
        assert torch.equal(got, again), f"K9 T={t} rs={rs} ({key}, D={d}): two runs differ"
        abs_e, rel_e = max_err(got, want)
        assert rel_e <= tol, f"K9 disagrees at T={t} rs={rs} ({key}, D={d}): {abs_e} {rel_e}"
        return abs_e, rel_e

    ws = tail_weights(L, D, H, F)
    wo, w13, w2, nw = ws
    worst = {"bf16": 0.0, "f32": 0.0, "bf16_unaligned": 0.0}
    worst_abs = 0.0
    for dt, key, tol in ((torch.float32, "f32", 1e-5), (torch.bfloat16, "bf16", 1e-2)):
        for t in TAIL_EDGE_ROWS:
            for rs in (1.0, 0.5):
                abs_e, rel_e = case(ws, t, rs, dt, key, tol)
                worst[key] = max(worst[key], rel_e)
                worst_abs = max(worst_abs, abs_e)
        log(f"K9 {key}, T in {TAIL_EDGE_ROWS}, rs 1 and 0.5: worst rel {worst[key]:.3g}, "
            "two runs bit-equal")
        x33 = torch.zeros((33, D), device=dev, dtype=dt)
        assert layer_fused.layer_tail_fused_rowq(wo, w13, w2, nw, torch.zeros((33, H), device=dev,
                                                                              dtype=dt),
                                                 x33, 0, 1e-5) is None
    uws = tail_weights(2, *TAIL_UNALIGNED)
    for t in TAIL_UNALIGNED_ROWS:
        for rs in (1.0, 0.5):
            abs_e, rel_e = case(uws, t, rs, torch.bfloat16, "bf16", 1e-2)
            worst["bf16_unaligned"] = max(worst["bf16_unaligned"], rel_e)
            worst_abs = max(worst_abs, abs_e)
    del uws
    log(f"K9 bf16 at (D, H, F) = {TAIL_UNALIGNED} (gemv.cuh), T in {TAIL_UNALIGNED_ROWS}, rs 1 "
        f"and 0.5: worst rel {worst['bf16_unaligned']:.3g}, two runs bit-equal")
    li = iter(range(10**9))
    per = {}
    for t in (1, 8, 32):
        attn = torch.randn((t, H), device=dev, generator=gen).to(torch.bfloat16)
        x = torch.randn((t, D), device=dev, generator=gen).to(torch.bfloat16)
        wbytes = D * H + 2 * F * D + D * F + (D + 2 * F + D) * 4 + D * 4
        b_ms, b_by = bound(wbytes + t * (H + D + D) * 2, 2 * t * (D * H + 2 * F * D + D * F),
                           BF16_OPS_S)
        per[t] = dict(bound_ms=b_ms, bound_by=b_by, **timings(
            lambda: layer_fused.layer_tail_fused_rowq(wo, w13, w2, nw, attn, x, next(li) % L,
                                                      1e-5),
            K9_TC,
            lambda: layer_fused.layer_tail_plain(wo, w13, w2, nw, attn, x, next(li) % L, 1e-5),
            None, graph=True))
        log(f"K9 T={t}: {per[t]['ms']:.4f} ms (bound {b_ms:.4f} by {b_by}, plain "
            f"{per[t]['plain_ms']:.4f})")
    del ws, wo, w13, w2
    torch.cuda.empty_cache()
    return dict(
        name="layer_tail_fused_rowq", route="cuda", source="llamatpu_torch/csrc/rowq_tc.cuh",
        replaces="llamatpu/ops/layer_fused.py:50", max_abs_err=worst_abs,
        max_rel_err=max(worst.values()), max_rel_err_by_dtype=worst,
        tolerance=f"rel to max|plain|: f32 <= 1e-5, bf16 <= 1e-2 (T in {TAIL_EDGE_ROWS}; "
                  f"rs 1 and 0.5; bf16 also at (D, H, F) = {TAIL_UNALIGNED}, T in "
                  f"{TAIL_UNALIGNED_ROWS}); two runs bit-equal",
        **{k: per[8][k] for k in ("ms", "ms_source", "wrapper_ms", "plain_ms", "library_ms",
                                  "bound_ms", "bound_by")},
        library=None, shape=f"T=8 rows (the B lanes of a decode step) D={D} H={H} F={F}",
        by_rows=per)


# ------------------------------------------------------------ slice 5 kernels
LONG_S = 33792  # physical rows of a 32768-row cache (prefill chunk 512)


def sdpa_yardstick(q, kd, vd, scale: float):
    """(one scaled_dot_product_attention call over contiguous K/V prepared
    beforehand, its name): q [B, KV, G, hd] as B x KV*G heads of one query,
    kd/vd [B, KV, s, d] bf16, GQA; K/V expanded where torch has no
    enable_gqa."""
    import torch.nn.functional as F

    b, kvh, g, hd = q.shape
    qs = q.reshape(b, kvh * g, 1, hd).to(kd.dtype)
    try:
        F.scaled_dot_product_attention(qs, kd, vd, scale=scale, enable_gqa=True)
        return (lambda: F.scaled_dot_product_attention(qs, kd, vd, scale=scale, enable_gqa=True),
                "scaled_dot_product_attention (GQA), bf16 K/V prepared beforehand")
    except TypeError:
        ke, ve = kd.repeat_interleave(g, dim=1), vd.repeat_interleave(g, dim=1)
        return (lambda: F.scaled_dot_product_attention(qs, ke, ve, scale=scale),
                "scaled_dot_product_attention, bf16 K/V expanded beforehand")


def int8_rows(x):
    """Packed [..., S, 2 hd] float rows -> (int8 rows, scale rows [..., 2, S])
    through ops/kv_quant.quantize_kv, K and V each."""
    import torch

    from llamatpu_torch.ops.kv_quant import quantize_kv

    hd = x.shape[-1] // 2
    (k, ks), (v, vs) = quantize_kv(x[..., :hd]), quantize_kv(x[..., hd:])
    return torch.cat([k, v], dim=-1), torch.stack([ks, vs], dim=-2)


def dense_kv(kvc, sc, li: int, n: int, hd: int):
    """Layer li's first n rows as contiguous bf16 K and V [B, KV, n, hd]
    (int8 rows dequantized with their scales)."""
    import torch

    kv = kvc[li, :, :, :n].float()
    if sc is not None:
        kv = torch.cat([kv[..., :hd] * sc[li, :, :, 0, :n, None],
                        kv[..., hd:] * sc[li, :, :, 1, :n, None]], dim=-1)
    kv = kv.to(torch.bfloat16)
    return kv[..., :hd].contiguous(), kv[..., hd:].contiguous()


def attn_bytes(b: int, kvh: int, g: int, hd: int, rows: int, row_bytes: int,
               new_row_bytes: int = 0) -> int:
    """Bytes a decode attention call must move: the live cache rows once, q
    (bf16), the f32 output, and a fused call's new row read and written."""
    return b * kvh * (rows * row_bytes + g * hd * 2 + g * hd * 4 + 2 * new_row_bytes)


def check_fused(A, dev, gen, kvh, g, hd, s_len, positions, dt, k6: bool = False):
    """One fused call (K14, or K6-int8 with k6=True) against its
    plain version on a 2-layer stacked cache: the caches after both equal, and
    nothing but row pos (and its scales) of the written layer changed. Returns
    (got, want)."""
    import torch

    b, W = len(positions), 2 * hd
    x = torch.randn((2, b, kvh, s_len, W), device=dev, generator=gen)
    quant = dt == torch.int8
    kvc, sc = int8_rows(x) if quant else (x.to(dt), None)
    del x
    pv = torch.tensor(positions, dtype=torch.int32, device=dev)
    q = torch.randn((b, kvh, g, hd), device=dev, generator=gen).to(
        torch.bfloat16 if quant else dt)
    new = torch.randn((b, kvh, W), device=dev, generator=gen)
    c1, c2 = kvc.clone(), kvc.clone()
    if quant:
        kvn, sn = int8_rows(new[:, :, None])
        kvn, sn = kvn[:, :, 0], sn[..., 0]                 # [B, KV, W], [B, KV, 2]
        s1, s2 = sc.clone(), sc.clone()
        kern = A.decode_attention_fused_write_q if k6 else A.decode_attention_split_fused_write_q
        plain = A.decode_attention_fused_write_q_plain if k6 else \
            A.decode_attention_split_fused_write_q_plain
        got = kern(q, kvn, sn, c1, s1, pv, hd ** -0.5, 1, hd)[0]
        want = plain(q, kvn, sn, c2, s2, pv, hd ** -0.5, 1, hd)[0]
    else:
        kvn = new.to(dt)
        got = A.decode_attention_split_fused_write(q, kvn, c1, pv, hd ** -0.5, 1, hd)[0]
        want = A.decode_attention_split_fused_write_plain(q, kvn, c2, pv, hd ** -0.5, 1, hd)[0]
    torch.cuda.synchronize()
    assert torch.equal(c1, c2), f"fused write: cache differs from the plain version's ({dt})"
    written = torch.zeros((2, b, kvh, s_len), dtype=torch.bool, device=dev)
    written[1, torch.arange(b, device=dev), :, pv.long()] = True
    assert not ((c1 != kvc).any(dim=-1) & ~written).any(), "fused write changed another row"
    if quant:
        assert torch.equal(s1, s2), "fused write: scale rows differ from the plain version's"
        assert not ((s1 != sc).any(dim=-2) & ~written).any(), "fused write changed another scale"
    return got, want


# K14's and K15's cluster sizes that the planner does not pick, held to the
# plain version under forced plans at the edges (cluster, parts; the
# planner's stage rows). Their times are bench/paged_ablation.py's.
STRIPE_EDGE_CLUSTERS = ((1, 16), (4, 4), (8, 2))


def check_stripe_edges(dev, dims=LLAMA32_1B) -> dict:
    """K14 and K15 against their plain versions at the edges of their plans,
    Llama-3.2-1B geometry unless said, two calls giving the same bits (plans
    as (C, P, stage rows) on an H100's 132 SMs):
    - the 33792-row cache (2 layers, 8 lanes), lanes at R - 1 and R (a unit
      boundary), C R - 1 and C R (the second cluster's first unit), C P R -
      1 and C P R (the second round), 20000 and 32767 under the 8 lanes'
      plan (2, 1, 32), the one-lane plans of bf16 (2, 8, 32) and int8 (2,
      16, 32), and the cluster sizes of STRIPE_EDGE_CLUSTERS: fused bf16
      and int8 (the caches and scale rows as the plain version's, only row
      pos changed), unfused bf16, stats bf16;
    - K15 over s_use = 3990 of 4128 rows (not a multiple of the stage rows)
      at pos 0, 15, 16, 3989, 3990 and 4127, f32, bf16 and int8, under the
      plan of these 6 lanes, the one-lane plan of the dtype (f32 (2, 8,
      16), bf16 and int8 (2, 8, 32): P > 1, the clusters combined through
      the scratch and the counter) and (8, 2, 32) (not f32: its stages
      would pass STRIPE_STAGE_BYTES);
    - Phi-3-medium's geometry (KV 10, G 4, hd 128), bf16, one lane at pos
      4000 of 4128 rows under its plan (2, 6, 16), K15 and K14 unfused.
    Outputs (and m, l) within rel 1e-5 of max|plain|."""
    import torch

    from llamatpu_torch.ops import attention as A

    gen = torch.Generator(device=dev).manual_seed(61)
    KV, G, HD = dims["KV"], dims["G"], dims["HD"]
    W, scale = 2 * HD, HD ** -0.5
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst, cases = {}, 0

    def hold(got, want, what, again=None):
        nonlocal cases
        if again is not None:
            assert all(torch.equal(a, b) for a, b in zip(got, again)), f"{what}: runs differ"
        for a, b in zip(got, want):
            abs_e, rel_e = max_err(a, b)
            assert rel_e <= 1e-5 and bool(torch.isfinite(a).all()), \
                f"K14/K15 edges {what}: max abs {abs_e} rel {rel_e}"
            key = what.split(" plan")[0]
            worst[key] = max(worst.get(key, 0.0), rel_e)
        cases += 1

    def plans_of(b, s_len, width, itemsize, extra):
        """The planner's plan at b lanes, then each (cluster, parts, rows) of
        extra (rows None: the planner's) whose stage fits STRIPE_STAGE_BYTES."""
        base = A.plan_stripe(b, KV, s_len, width, itemsize, sms)
        plans = [base]
        for c, p, r in extra:
            pl = A.StripePlan(c, p, r or base.rows)
            if pl not in plans and pl.rows * width * itemsize <= A.STRIPE_STAGE_BYTES:
                plans.append(pl)
        return plans

    def as_tuple(pl):
        return pl.cluster, pl.parts, pl.rows

    S = LONG_S
    one = A.plan_stripe(1, KV, S, W, 2, sms)
    one_int8 = A.plan_stripe(1, KV, S, W, 1, sms)
    C, P, R = one.cluster, one.parts, one.rows
    positions = [R - 1, R, C * R - 1, C * R, C * P * R - 1, C * P * R, min(20000, S // 2),
                 min(32767, S - 1)]
    B = len(positions)
    pv = torch.tensor(positions, dtype=torch.int32, device=dev)
    q = torch.randn((B, KV, G, HD), device=dev, generator=gen).to(torch.bfloat16)
    new = torch.randn((B, KV, W), device=dev, generator=gen)
    x = torch.randn((2, B, KV, S, W), device=dev, generator=gen)
    written = torch.zeros((2, B, KV, S), dtype=torch.bool, device=dev)
    written[1, torch.arange(B, device=dev), :, pv.long()] = True
    plans = plans_of(B, S, W, 2, [as_tuple(one), as_tuple(one_int8)]
                     + [(c, p, None) for c, p in STRIPE_EDGE_CLUSTERS])
    for dt in (torch.bfloat16, torch.int8):
        quant = dt == torch.int8
        kvc, sc = int8_rows(x) if quant else (x.to(dt), None)
        if quant:
            kvn, sn = int8_rows(new[:, :, None])
            kvn, sn = kvn[:, :, 0], sn[..., 0]
        else:
            kvn, sn = new.to(dt), None
        c2, s2 = kvc.clone(), None if sc is None else sc.clone()
        want = fused_split(A, True, q, kvn, sn, c2, s2, pv, scale, HD)
        for pl in plans:
            what = f"fused {dt} plan {pl}"
            outs = []
            for _ in range(2):
                c1, s1 = kvc.clone(), None if sc is None else sc.clone()
                with forced_cluster(A, pl.cluster, "plan_stripe", rows=pl.rows, parts=pl.parts):
                    outs.append(fused_split(A, False, q, kvn, sn, c1, s1, pv, scale, HD))
                torch.cuda.synchronize()
                assert torch.equal(c1, c2), f"{what}: cache differs"
                assert not ((c1 != kvc).any(dim=-1) & ~written).any(), f"{what}: another row"
                if quant:
                    assert torch.equal(s1, s2), f"{what}: scale rows differ"
            hold([outs[0]], [want], what, [outs[1]])
            if not quant:  # unfused and stats over the written cache
                with forced_cluster(A, pl.cluster, "plan_stripe", rows=pl.rows, parts=pl.parts):
                    got = [A.decode_attention_split(q, c2, pv, scale, HD, 1024, 1)
                           for _ in range(2)]
                    st = [A.decode_attention_split_stats(q, c2[1], pv, scale, HD, 1024)
                          for _ in range(2)]
                hold([got[0]], [A.decode_attention_split_plain(q, c2, pv, scale, HD, 1024, 1)],
                     f"unfused {dt} plan {pl}", [got[1]])
                hold(st[0], A.decode_attention_split_stats_plain(q, c2[1], pv, scale, HD, 1024),
                     f"stats {dt} plan {pl}", st[1])
        del kvc, sc, c1, s1, c2, s2
    del x
    torch.cuda.empty_cache()

    # K15 over s_use rows not a multiple of the stage rows
    S4, s_use = 4128, 3990
    positions = [0, 15, 16, s_use - 1, s_use, S4 - 1]
    pv = torch.tensor(positions, dtype=torch.int32, device=dev)
    x = torch.randn((2, len(positions), KV, S4, W), device=dev, generator=gen)
    for dt in (torch.float32, torch.bfloat16, torch.int8):
        kvc, sc = int8_rows(x) if dt == torch.int8 else (x.to(dt), None)
        q = torch.randn((len(positions), KV, G, HD), device=dev, generator=gen).to(
            torch.float32 if dt == torch.float32 else torch.bfloat16)
        if sc is None:
            fn, plain = A.decode_attention, A.decode_attention_plain
            args = (q, kvc, pv, scale, HD, s_use, 1)
        else:
            fn, plain = A.decode_attention_q, A.decode_attention_q_plain
            args = (q, kvc, sc, pv, scale, HD, s_use, 1)
        want = plain(*args)
        lone = A.plan_stripe(1, KV, S4, W, kvc.element_size(), sms)  # the path's plan
        for pl in plans_of(len(positions), S4, W, kvc.element_size(),
                           (as_tuple(lone), (8, 2, 32))):
            with forced_cluster(A, pl.cluster, "plan_stripe", rows=pl.rows, parts=pl.parts):
                got = [fn(*args) for _ in range(2)]
            hold([got[0]], [want], f"K15 s_use {s_use} {dt} plan {pl}", [got[1]])
        del kvc, sc
    del x

    # Phi-3-medium's geometry at one lane, its own plan
    kvh, hd = 10, 128
    x = torch.randn((2, 1, kvh, S4, 2 * hd), device=dev, generator=gen).to(torch.bfloat16)
    q = torch.randn((1, kvh, G, hd), device=dev, generator=gen).to(torch.bfloat16)
    pv = torch.tensor([4000], dtype=torch.int32, device=dev)
    pl = A.plan_stripe(1, kvh, S4, 2 * hd, 2, sms)
    got = [A.decode_attention(q, x, pv, hd ** -0.5, hd, 4000, 1) for _ in range(2)]
    hold([got[0]], [A.decode_attention_plain(q, x, pv, hd ** -0.5, hd, 4000, 1)],
         f"K15 phi3-medium plan {pl}", [got[1]])
    got = [A.decode_attention_split(q, x, pv, hd ** -0.5, hd, 32, 1) for _ in range(2)]
    hold([got[0]], [A.decode_attention_split_plain(q, x, pv, hd ** -0.5, hd, 32, 1)],
         f"unfused phi3-medium plan {pl}", [got[1]])
    del x
    torch.cuda.empty_cache()
    log(f"K14/K15 edges: {cases} cases (unit, cluster and round boundaries under "
        f"{plans}, s_use {s_use} under the one-lane plans, Phi-3-medium's plan {pl}; two "
        f"runs each bit-equal) within rel 1e-5: worst {worst}")
    return dict(cases=cases, worst_rel_err=worst,
                tolerance="rel to max|plain| <= 1e-5 (outputs, m, l); fused caches and scale "
                          "rows as the plain version's, only row pos changed; two runs bit-equal")


def fused_split(A, plain: bool, q, kvn, sn, kvc, sc, pv, scale, hd):
    """One fused K14 call at layer 1 (or its int8 variant, or either plain
    version): the output."""
    if sc is None:
        fn = A.decode_attention_split_fused_write_plain if plain \
            else A.decode_attention_split_fused_write
        return fn(q, kvn, kvc, pv, scale, 1, hd)[0]
    fn = A.decode_attention_split_fused_write_q_plain if plain \
        else A.decode_attention_split_fused_write_q
    return fn(q, kvn, sn, kvc, sc, pv, scale, 1, hd)[0]


def check_split_attention(dev, dims=LLAMA32_1B) -> dict:
    """K14 against its plain versions at llama32-1b geometry on a stacked
    2-layer cache of 33792 rows (the physical length of a 32768-row cache):
    fused bf16 and int8 at pos 0, 1023, 1024, 20000 and 32767 and with 8
    lanes at mixed positions (each fused call leaves the cache equal to the
    plain version's and changes only row pos and its scales); unfused bf16
    and int8, stats mode (o, m, l), fused f32. Outputs within 1e-5 of the
    largest plain value. Timed at pos 32767 under the planner's plan: fused
    bf16 (the row) and int8, and K6 at pos 512 in the same call; the
    stripe's edges by check_stripe_edges."""
    import torch

    from llamatpu_torch.ops import attention as A

    gen = torch.Generator(device=dev).manual_seed(14)
    KV, G, HD = dims["KV"], dims["G"], dims["HD"]
    S, W, scale = LONG_S, 2 * HD, HD ** -0.5
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst = {"rel": 0.0, "abs": 0.0}

    def hold(got, want, what):
        abs_e, rel_e = max_err(got, want)
        assert rel_e <= 1e-5, f"K14 {what}: max abs {abs_e} rel {rel_e}"
        worst["rel"], worst["abs"] = max(worst["rel"], rel_e), max(worst["abs"], abs_e)
        log(f"K14 {what}: max abs {abs_e:.3g} rel {rel_e:.3g}")

    mixed = [0, 1023, 1024, 5000, 20000, 31999, 32767, 777]
    for dt in (torch.bfloat16, torch.int8):
        for pos in (0, 1023, 1024, 20000, 32767):
            hold(*check_fused(A, dev, gen, KV, G, HD, S, [pos], dt),
                 f"fused {dt} pos {pos}, cache as the plain version's")
        hold(*check_fused(A, dev, gen, KV, G, HD, S, mixed, dt), f"fused {dt} B=8 {mixed}")
    hold(*check_fused(A, dev, gen, KV, G, HD, S, [20000, 32767], torch.float32),
         "fused f32 B=2")
    pv = torch.tensor([1024, 32767], dtype=torch.int32, device=dev)
    x = torch.randn((2, 2, KV, S, W), device=dev, generator=gen)
    q = torch.randn((2, KV, G, HD), device=dev, generator=gen).to(torch.bfloat16)
    kvb = x.to(torch.bfloat16)
    hold(A.decode_attention_split(q, kvb, pv, scale, HD, 1024, 1),
         A.decode_attention_split_plain(q, kvb, pv, scale, HD, 1024, 1), "unfused bf16 B=2")
    got, want = A.decode_attention_split_stats(q, kvb[1], pv, scale, HD), \
        A.decode_attention_split_stats_plain(q, kvb[1], pv, scale, HD)
    for name, a, b in zip("oml", got, want):
        hold(a, b, f"stats {name} B=2")
    k8, s8 = int8_rows(x)
    hold(A.decode_attention_split_q(q, k8, s8, pv, scale, HD, 1024, 1),
         A.decode_attention_split_q_plain(q, k8, s8, pv, scale, HD, 1024, 1), "unfused int8 B=2")
    del x, kvb, k8, s8

    # timed at the end of a 32k cache, B = 1: fused bf16 (the row), fused int8
    pos = 32767
    pv = torch.tensor([pos], dtype=torch.int32, device=dev)
    x = torch.randn((2, 1, KV, S, W), device=dev, generator=gen)
    q = torch.randn((1, KV, G, HD), device=dev, generator=gen).to(torch.bfloat16)
    new = torch.randn((1, KV, W), device=dev, generator=gen)
    per = {}
    for key, dt in (("bf16", torch.bfloat16), ("int8", torch.int8)):
        if dt == torch.int8:
            kvc, sc = int8_rows(x)
            kvn, sn = int8_rows(new[:, :, None])
            kvn, sn = kvn[:, :, 0], sn[..., 0]
            fn = lambda: A.decode_attention_split_fused_write_q(  # noqa: E731
                q, kvn, sn, kvc, sc, pv, scale, 1, HD)
            plain = lambda: A.decode_attention_split_fused_write_q_plain(  # noqa: E731
                q, kvn, sn, kvc, sc, pv, scale, 1, HD)
            row_bytes, new_bytes = W + 8, W + 8
        else:
            kvc, sc, kvn = x.to(dt), None, new.to(dt)
            fn = lambda: A.decode_attention_split_fused_write(  # noqa: E731
                q, kvn, kvc, pv, scale, 1, HD)
            plain = lambda: A.decode_attention_split_fused_write_plain(  # noqa: E731
                q, kvn, kvc, pv, scale, 1, HD)
            row_bytes, new_bytes = W * 2, W * 2
        library, lib_name = sdpa_yardstick(q, *dense_kv(kvc, sc, 1, pos + 1, HD), scale)
        b_ms, b_by = bound(attn_bytes(1, KV, G, HD, pos + 1, row_bytes, new_bytes),
                           2 * KV * G * (pos + 1) * W, BF16_OPS_S)
        plan = A.plan_stripe(1, KV, S, W, kvc.element_size(), sms)
        per[key] = dict(bound_ms=b_ms, bound_by=b_by, **timings(fn, STRIPE, plain, library),
                        library=lib_name, shape=f"B=1 pos={pos} S={S} KV={KV} G={G} hd={HD}",
                        plan=dict(cluster=plan.cluster, parts=plan.parts, stage_rows=plan.rows))
        log(f"K14 fused {key} at pos {pos}: {per[key]['ms']:.5f} ms (bound {b_ms:.5f} by {b_by}, "
            f"plain {per[key]['plain_ms']:.4f}, sdpa {per[key]['library_ms']:.5f}); plan {plan}")
        del kvc, sc
    torch.cuda.empty_cache()
    k6 = time_dense(dev, dims, quant=False, seed=4, sweep=False)  # the shared body, same call
    log(f"K6 at pos 512 beside K14: {k6['ms']:.5f} ms ({k6['ms_source']})")
    return dict(
        name="decode_attention_split_fused_write", route="cuda",
        source="llamatpu_torch/csrc/attention.cu",
        replaces="llamatpu/ops/pallas_attention.py:230", max_abs_err=worst["abs"],
        max_rel_err=worst["rel"],
        tolerance="rel to max|plain| <= 1e-5; fused caches and scale rows equal the plain "
                  "version's, only row pos changed",
        **{k: per["bf16"][k] for k in ("ms", "ms_source", "wrapper_ms", "plain_ms", "library_ms",
                                       "bound_ms", "bound_by", "library", "shape", "plan")},
        by_dtype=per, k6_pos512_ms=k6["ms"], edges=check_stripe_edges(dev, dims))


def check_full_attention(dev, dims=LLAMA32_1B) -> dict:
    """K15 against its plain versions at llama32-1b geometry over the first
    s_use = 4000 of 4128 physical rows (a 4000-row cache's, prefill chunk
    512), f32 (the path's), bf16 and int8 caches: 3 lanes at 0, 1023, 3999
    and 8 lanes with one parked at the last physical row; within 1e-5 of the
    largest plain value; and one lane at pos 3999 (the path's launch: the
    one-lane plan, P clusters a head combined through the scratch and the
    counter), held to the plain version and timed, in f32 (the row), bf16
    and int8."""
    import torch

    from llamatpu_torch.ops import attention as A

    gen = torch.Generator(device=dev).manual_seed(15)
    KV, G, HD = dims["KV"], dims["G"], dims["HD"]
    S, s_use, W, scale = 4128, 4000, 2 * HD, HD ** -0.5
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst = [0.0, 0.0]
    per = {}
    for key, dt in (("f32", torch.float32), ("bf16", torch.bfloat16), ("int8", torch.int8)):
        x = torch.randn((2, 8, KV, S, W), device=dev, generator=gen)
        kvc, sc = int8_rows(x) if dt == torch.int8 else (x.to(dt), None)
        qdt = torch.float32 if dt == torch.float32 else torch.bfloat16
        for positions in ([0, 1023, 3999], [0, 31, 500, 2047, 3998, 3999, 1234, S - 1]):
            b = len(positions)
            pv = torch.tensor(positions, dtype=torch.int32, device=dev)
            q = torch.randn((b, KV, G, HD), device=dev, generator=gen).to(qdt)
            kv_b = kvc[:, :b].contiguous()
            sc_b = None if sc is None else sc[:, :b].contiguous()
            if sc is None:
                got = A.decode_attention(q, kv_b, pv, scale, HD, s_use, 1)
                want = A.decode_attention_plain(q, kv_b, pv, scale, HD, s_use, 1)
            else:
                got = A.decode_attention_q(q, kv_b, sc_b, pv, scale, HD, s_use, 1)
                want = A.decode_attention_q_plain(q, kv_b, sc_b, pv, scale, HD, s_use, 1)
            abs_e, rel_e = max_err(got, want)
            assert rel_e <= 1e-5, f"K15 {key} lanes {positions}: max abs {abs_e} rel {rel_e}"
            worst = [max(worst[0], rel_e), max(worst[1], abs_e)]
            log(f"K15 {key} lanes {positions}: max abs {abs_e:.3g} rel {rel_e:.3g}")
        pos = 3999
        pv = torch.tensor([pos], dtype=torch.int32, device=dev)
        q = torch.randn((1, KV, G, HD), device=dev, generator=gen).to(qdt)
        k1 = kvc[:, :1].contiguous()
        s1 = None if sc is None else sc[:, :1].contiguous()
        if sc is None:
            fn = lambda: A.decode_attention(q, k1, pv, scale, HD, s_use, 1)  # noqa: E731
            plain = lambda: A.decode_attention_plain(q, k1, pv, scale, HD, s_use, 1)  # noqa: E731
        else:
            fn = lambda: A.decode_attention_q(q, k1, s1, pv, scale, HD, s_use, 1)  # noqa: E731
            plain = lambda: A.decode_attention_q_plain(  # noqa: E731
                q, k1, s1, pv, scale, HD, s_use, 1)
        plan = A.plan_stripe(1, KV, S, W, k1.element_size(), sms)
        abs_e, rel_e = max_err(fn(), plain())
        assert rel_e <= 1e-5, f"K15 {key} B=1 pos {pos} plan {plan}: max abs {abs_e} rel {rel_e}"
        worst = [max(worst[0], rel_e), max(worst[1], abs_e)]
        log(f"K15 {key} B=1 pos {pos} plan {plan}: max abs {abs_e:.3g} rel {rel_e:.3g}")
        row_bytes = W + 8 if sc is not None else W * k1.element_size()
        library, lib_name = sdpa_yardstick(q, *dense_kv(k1, s1, 1, pos + 1, HD), scale)
        b_ms, b_by = bound(attn_bytes(1, KV, G, HD, pos + 1, row_bytes),
                           2 * KV * G * (pos + 1) * W, BF16_OPS_S)
        per[key] = dict(bound_ms=b_ms, bound_by=b_by, **timings(fn, STRIPE, plain, library),
                        library=lib_name, shape=f"B=1 pos={pos} s_use={s_use} S={S} KV={KV} "
                                                f"G={G} hd={HD}",
                        plan=dict(cluster=plan.cluster, parts=plan.parts, stage_rows=plan.rows))
        log(f"K15 {key} at pos {pos}: {per[key]['ms']:.5f} ms (bound {b_ms:.5f} by {b_by}, plain "
            f"{per[key]['plain_ms']:.4f}, sdpa {per[key]['library_ms']:.5f}); plan {plan}")
        del x, kvc, sc
    torch.cuda.empty_cache()
    return dict(
        name="decode_attention", route="cuda", source="llamatpu_torch/csrc/attention.cu",
        replaces="llamatpu/ops/pallas_attention.py:119", max_abs_err=worst[1],
        max_rel_err=worst[0], tolerance="rel to max|plain| <= 1e-5 (f32, bf16, int8 caches)",
        **{k: per["f32"][k] for k in ("ms", "ms_source", "wrapper_ms", "plain_ms", "library_ms",
                                      "bound_ms", "bound_by", "library", "shape", "plan")},
        by_dtype=per)


def check_int8_attention(dev, dims=LLAMA32_1B) -> list[dict]:
    """K6's and K8's int8 variants against their plain versions at
    llama32-1b geometry, and quantize_kv on the card against the CPU, bit for
    bit (bf16 and f32 rows, zero rows included).
    - K6-int8: cache 1152 rows, pos 0, 31, 32, 511, 1151 and 8 lanes at
      mixed positions (one parked at the last row); caches and scale rows
      equal the plain version's, only row pos changed; timed by
      time_dense (B = 1, the row, and 8; 1152 and 15360 rows; warm, cold,
      every cluster size).
    - K8-int8: 8 lanes of a shuffled int8 pool (block 16, lanes up to 2048
      rows) at pos 0, 15, 16, 100, 511, 1023, 2047 and one parked at the
      trash block; the pool and scale pool only read; timed at 8 lanes at
      pos 512.
    Outputs within 1e-5 of the largest plain value."""
    import torch

    from llamatpu_torch.ops import attention as A
    from llamatpu_torch.ops.kv_quant import quantize_kv

    gen = torch.Generator(device=dev).manual_seed(16)
    KV, G, HD, S = dims["KV"], dims["G"], dims["HD"], dims["S"]
    W, scale = 2 * HD, HD ** -0.5
    # quantize_kv: the card's scales and values bit-equal to the CPU's
    x = torch.randn((4096, KV, HD), device=dev, generator=gen) * 3.0
    x[::97] = 0.0
    for dt in (torch.bfloat16, torch.float32):
        qc, sc_ = quantize_kv(x.to(dt))
        qh, sh = quantize_kv(x.to(dt).cpu())
        assert torch.equal(qc.cpu(), qh) and torch.equal(sc_.cpu(), sh), \
            f"quantize_kv on the card differs from the CPU ({dt})"
    log("quantize_kv: card and CPU bit-equal (bf16 and f32 rows, zero rows included)")
    worst = [0.0, 0.0]
    for positions in ([0], [31], [32], [511], [S - 1], [0, 31, 32, 100, 511, 700, S - 2, S - 1]):
        got, want = check_fused(A, dev, gen, KV, G, HD, S, positions, torch.int8, k6=True)
        abs_e, rel_e = max_err(got, want)
        assert rel_e <= 1e-5, f"K6-int8 lanes {positions}: max abs {abs_e} rel {rel_e}"
        worst = [max(worst[0], rel_e), max(worst[1], abs_e)]
        log(f"K6-int8 lanes {positions}: max abs {abs_e:.3g} rel {rel_e:.3g}, cache and scales "
            "as the plain version's")
    k6q = dict(name="decode_attention_fused_write_q", route="cuda",
               source="llamatpu_torch/csrc/attention.cu",
               replaces="llamatpu/ops/pallas_attention.py:718", max_abs_err=worst[1],
               max_rel_err=worst[0], quantize_kv_bit_equal=True,
               tolerance="rel to max|plain| <= 1e-5; cache and scale rows equal the plain "
                         "version's, only row pos changed; quantize_kv card == CPU bit for bit",
               **time_dense(dev, dims, quant=True, seed=17))

    B, BS, MAXLEN = 8, 16, 2048
    maxblk = MAXLEN // BS
    nblk = B * maxblk // 2
    positions = [0, 15, 16, 100, 511, 1023, 2047, 700]
    tables = paged_tables(positions, {7}, maxblk, nblk, BS, seed=18).to(dev)
    pv = torch.tensor(positions, dtype=torch.int32, device=dev)
    pool, spool = int8_rows(torch.randn((2, nblk, KV, BS, W), device=dev, generator=gen))
    q = torch.randn((B, KV, G, HD), device=dev, generator=gen).to(torch.bfloat16)
    before, sbefore = pool.clone(), spool.clone()
    got = A.decode_attention_paged(q, pool, tables, pv, scale, HD, 1, scale_pool=spool)
    want = A.decode_attention_paged_q_plain(q, pool, spool, tables, pv, scale, HD, 1)
    torch.cuda.synchronize()
    assert torch.equal(pool, before) and torch.equal(spool, sbefore), "K8-int8 wrote the pool"
    abs8, rel8 = max_err(got, want)
    assert rel8 <= 1e-5 and bool(torch.isfinite(got).all()), f"K8-int8: {abs8} {rel8}"
    log(f"K8-int8 lanes {positions} (lane 7 parked): max abs {abs8:.3g} rel {rel8:.3g}")
    del pool, spool, before, sbefore
    torch.cuda.empty_cache()
    k8q = dict(name="decode_attention_paged_q", route="cuda",
               source="llamatpu_torch/csrc/attention.cu",
               replaces="llamatpu/ops/pallas_attention.py:617", max_abs_err=abs8,
               max_rel_err=rel8,
               tolerance="rel to max|plain| <= 1e-5; the pool and scale pool are not written",
               **time_paged(dev, dims, quant=True, seed=19))
    return [k6q, k8q]


def check_long_kernels(dev, dims=LLAMA32_1B) -> list[dict]:
    return [check_split_attention(dev, dims), check_full_attention(dev, dims)] \
        + check_int8_attention(dev, dims)


def check_block_kernels(dev, dims=LLAMA32_1B) -> list[dict]:
    return [check_block_matmul(dev, dims, False),
            dict(check_attention(dev, dims), edges=check_dense_edges(dev)),
            check_block_matmul(dev, dims, True)]


def check_serving_kernels(dev, dims=LLAMA32_1B) -> list[dict]:
    return [dict(check_paged_attention(dev, dims), edges=check_paged_edges(dev)),
            check_tail(dev, dims)]


# ------------------------------------------------------------ slice 6 kernels
PROBE_DIMS = dict(L=24, O=4096, I=4096)  # the TPU probe scripts' stack
STREAM = ("probe_stream_kernel", "probe_stream_finish_kernel")
GEMV_TC = ("probe_gemv_tc_kernel", "probe_gemv_sum_kernel")  # K18a / K18i and the K-slice sum
# the bf16 GEMV's edges (T, L, O, I): a ragged O over a 2-layer stack in one
# short stage; a ragged O split into ten K slices (the second pass); I over
# the 4096 columns a CTA stages (three slices, each a stage and a short one)
GEMV_TC_EDGES = ((1, 2, 300, 528), (3, 1, 300, 4096), (8, 1, 1000, 9232))
# the q8 GEMV's edges (T, L, O, I, NB), both weight kinds: NB = 16 over a
# 3-layer stack at I = 16 * 33; NB = 128 (a lane's scales fixed) and NB =
# 256 = I / 16 (scales a step) over ten K slices starting off multiples of
# 128; three slices of I = 16 * 577; NB = I = 528; NB = 64 in one whole stage
GEMV_Q8_EDGES = ((1, 3, 300, 528, 16), (3, 1, 300, 4096, 128), (8, 3, 300, 4096, 256),
                 (8, 1, 1000, 9232, 16), (3, 1, 1000, 528, 528), (8, 2, 1000, 2048, 64))
# K18d / K18e / K18h: the GEMV's W_S8 kind and its K-slice pass (int32 sums)
INT8DOT = ("probe_gemv_tc_kernel", "probe_s8_sum_kernel")
# the int8 dot's edges (T, L, O, I, NB (0: no block scales), K slices (0:
# the planner's), data): T = 1 over a ragged 2-layer O at I = 16 x 33 (an
# odd count of 16-column halves in one short stage); T = 5 whole-K, without
# and with NB = 96 (lanes past NB); a ragged O = 300 over the planner's K
# slices; three forced slices of 16 x 43 columns (odd again) at I = 16 x
# 129; block scales under a forced split (the second pass applies them) and
# at NB = 600 (scales and xsc past a lane's registers, read at the unit's end);
# the worst case (xq = 127, rows of w = 127 and -128: |sum| 66.6 M > 2^24)
# whole-K and split
INT8DOT_EDGES = ((1, 2, 300, 528, 0, 0, "random"), (5, 1, 1000, 4096, 0, 0, "random"),
                 (5, 1, 1000, 4096, 96, 0, "random"), (8, 1, 300, 4096, 0, 0, "random"),
                 (8, 1, 1000, 2064, 0, 3, "random"), (8, 2, 300, 4096, 128, 2, "random"),
                 (8, 1, 1000, 528, 600, 0, "random"), (3, 1, 1000, 4096, 0, 0, "+-127"),
                 (3, 1, 1000, 4096, 0, 2, "+-127"))


K16_NAMES = ("rtc::K9>", "rtc::K16>")  # K16's wo and w13 phases (K9's), its w2 phase (bf16)


def check_tail_kt(dev, dims=LLAMA32_1B) -> dict:
    """K16 against its plain version at llama32-1b widths (F = 8192: 8
    contraction tiles of 1024), T in {1, 8, 32}, bf16 and f32 activations, K9's
    tolerances: f32 within 1e-5 of the largest plain output (sums in another
    order), bf16 within 1e-2 (one bf16 ulp); a second run bit-equal to the
    first. Timed at each T in bf16 (CUDA-graph time: the phases overlap under
    programmatic dependent launch), beside K9 in the same call."""
    import torch

    from llamatpu_torch.ops import layer_fused

    gen = torch.Generator(device=dev).manual_seed(16)
    L, D, F, KV, G, HD = (dims[k] for k in ("L", "D", "F", "KV", "G", "HD"))
    H = KV * G * HD
    wo, w13, w2 = rand_rowq(L, D, H, dev, gen), rand_rowq(L, 2 * F, D, dev, gen), \
        rand_rowq(L, D, F, dev, gen)
    nw = torch.rand((L, D), device=dev, generator=gen) + 0.5
    kt = layer_fused.layer_tail_kt_fused_rowq
    worst = {"bf16": 0.0, "f32": 0.0}
    worst_abs, vs_k9 = 0.0, 0.0
    for dt, key, tol in ((torch.float32, "f32", 1e-5), (torch.bfloat16, "bf16", 1e-2)):
        for t, rs in ((1, 1.0), (8, 1.0), (32, 1.0), (8, 0.5)):
            attn = torch.randn((t, H), device=dev, generator=gen).to(dt)
            x = torch.randn((t, D), device=dev, generator=gen).to(dt)
            got = kt(wo, w13, w2, nw, attn, x, 5 % L, 1e-5, rs)
            again = kt(wo, w13, w2, nw, attn, x, 5 % L, 1e-5, rs)
            want = layer_fused.layer_tail_kt_plain(wo, w13, w2, nw, attn, x, 5 % L, 1e-5, rs)
            k9 = layer_fused.layer_tail_fused_rowq(wo, w13, w2, nw, attn, x, 5 % L, 1e-5, rs)
            torch.cuda.synchronize()
            assert got.dtype == dt and got.shape == x.shape
            assert torch.equal(got, again), f"K16: two runs differ at T={t} rs={rs} ({key})"
            abs_e, rel_e = max_err(got, want)
            assert rel_e <= tol, f"K16 disagrees at T={t} rs={rs} ({key}): {abs_e} {rel_e}"
            worst[key] = max(worst[key], rel_e)
            worst_abs = max(worst_abs, abs_e)
            vs_k9 = max(vs_k9, max_err(got, k9)[1])
            log(f"K16 T={t} rs={rs} {key}: max abs {abs_e:.3g} rel {rel_e:.3g}")
    li = iter(range(10**9))
    per = {}
    for t in (1, 8, 32):
        attn = torch.randn((t, H), device=dev, generator=gen).to(torch.bfloat16)
        x = torch.randn((t, D), device=dev, generator=gen).to(torch.bfloat16)
        wbytes = D * H + 2 * F * D + D * F + (D + 2 * F + D) * 4 + D * 4
        b_ms, b_by = bound(wbytes + t * (H + D + D) * 2, 2 * t * (D * H + 2 * F * D + D * F),
                           BF16_OPS_S)
        per[t] = dict(bound_ms=b_ms, bound_by=b_by, **timings(
            lambda: kt(wo, w13, w2, nw, attn, x, next(li) % L, 1e-5), K16_NAMES,
            lambda: layer_fused.layer_tail_kt_plain(wo, w13, w2, nw, attn, x, next(li) % L, 1e-5),
            None, graph=True), k9_ms=time_ms(lambda: layer_fused.layer_tail_fused_rowq(
                wo, w13, w2, nw, attn, x, next(li) % L, 1e-5)))
        log(f"K16 T={t}: {per[t]['ms']:.4f} ms (K9 {per[t]['k9_ms']:.4f}, bound {b_ms:.4f} by "
            f"{b_by}, plain {per[t]['plain_ms']:.4f})")
    del wo, w13, w2
    torch.cuda.empty_cache()
    return dict(
        name="layer_tail_kt_fused_rowq", route="cuda", source="llamatpu_torch/csrc/layer_fused.cu",
        replaces="llamatpu/ops/layer_fused.py:110", max_abs_err=worst_abs,
        max_rel_err=max(worst.values()), max_rel_err_by_dtype=worst, max_rel_vs_k9=vs_k9,
        tolerance="rel to max|plain|: f32 <= 1e-5, bf16 <= 1e-2 (T in 1, 8, 32; rs 1 and 0.5); "
                  "two runs bit-equal",
        **{k: per[8][k] for k in ("ms", "ms_source", "wrapper_ms", "plain_ms", "library_ms",
                                  "bound_ms", "bound_by")},
        library=None, shape=f"T=8 rows D={D} H={H} F={F} tf=1024", by_rows=per)


K4_NAMES = ("gemm_s8_kernel", "gemm_s8_reduce_kernel")  # K4's main kernel and second pass
K17_NAMES = ("gemm_bf16_kernel", "gemm_bf16_reduce_kernel")


def gemm_shapes(dims=LLAMA32_1B, phi3=PHI3_MEDIUM) -> dict:
    """{layer: {projection: (T, O, I)}} of every K4 call on the paths:
    llama32-1b's four projections at the 512-row prefill chunk and at the
    128-row serving chunks, Phi-3-medium's at its 128-token prompt,
    Qwen3-0.6B's at its 512-row chunk (q width 2048 on dim 1024), and a
    ragged last chunk."""
    def layer(d):
        qkv = (d["G"] * d["KV"] + 2 * d["KV"]) * d["HD"]
        return {"wqkv": (qkv, d["D"]), "wo": (d["D"], d["KV"] * d["G"] * d["HD"]),
                "w13": (2 * d["F"], d["D"]), "w2": (d["D"], d["F"])}

    llama, phi, qwen3 = layer(dims), layer(phi3), layer(QWEN3_06B)
    return {f"llama32-1b T={dims['T']}": {k: (dims["T"], o, i) for k, (o, i) in llama.items()},
            "llama32-1b T=128": {k: (128, o, i) for k, (o, i) in llama.items()},
            "phi3-medium T=128": {k: (128, o, i) for k, (o, i) in phi.items()},
            f"qwen3-0.6b T={QWEN3_06B['T']}": {k: (QWEN3_06B["T"], o, i)
                                               for k, (o, i) in qwen3.items()},
            "ragged": {"T=200": (200, 2560, 2064)}}


def check_rowq_gemm(dev, bf16: bool, dims=LLAMA32_1B) -> dict:
    """K4 (bf16=False) or K17 against its plain version at every shape of
    `gemm_shapes`: K4 bit-identical, K17 within 1e-5 of the largest plain
    output (the same exact products summed in f32 in another order). Each
    shape's times, bound, CTAs and shared tiles are logged; the table row
    is one llama32-1b layer at the prefill chunk, with every layer's sums
    and every shape beside it. Library: `torch._int_mm` (int32 out, no
    epilogue); for K17 also bf16 `torch.matmul` of the cast operands (its
    output is bf16). Where the other kernel's plan differs (whole tiles
    against stream-K, `ops/gemm.py plan_gemm`), the shape is checked and
    timed under it too, the planner swapped for that call: the evidence for
    the planner's rule."""
    import torch

    from llamatpu_torch.ops import gemm

    gen = torch.Generator(device=dev).manual_seed(17 if bf16 else 4)
    tag, names = ("K17", K17_NAMES) if bf16 else ("K4", K4_NAMES)
    peak = BF16_OPS_S if bf16 else INT8_OPS_S
    fn = gemm.rowq_gemm_bf16 if bf16 else gemm.rowq_gemm
    plain = gemm.rowq_gemm_bf16_plain if bf16 else gemm.rowq_gemm_plain
    per, layers, worst = {}, {}, (0.0, 0.0)
    for label, shapes in gemm_shapes(dims).items():
        tot = {"bytes": 0, "ops": 0}
        for name, (t, o, i) in shapes.items():
            w = rand_rowq(1, o, i, dev, gen)
            qs, s = w.qs[0], w.scales[0]
            xi8 = torch.randint(-127, 128, (t, i), dtype=torch.int8, device=dev, generator=gen)
            ax = torch.rand((t, 1), device=dev, generator=gen) * 0.01
            got, want = fn(qs, s, xi8, ax), plain(qs, s, xi8, ax)
            torch.cuda.synchronize()
            e = max_err(got, want)
            if bf16:
                assert e[1] <= 1e-5, f"K17 {label} {name} disagrees: {e}"
            else:
                assert torch.equal(got, want), f"K4 {label} {name} not bit-identical: {e}"
            worst = max(worst, e)
            qt = qs.t()
            tm = timings(lambda: fn(qs, s, xi8, ax), names, lambda: plain(qs, s, xi8, ax),
                         lambda: torch._int_mm(xi8, qt))
            if bf16:
                xb, wb = xi8.to(torch.bfloat16), qs.to(torch.bfloat16)
                tm["library_bf16_ms"] = time_ms(lambda: torch.matmul(xb, wb.T))
                del xb, wb
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            plan, alt = gemm.plan_gemm(t, o, i, sms, bf16), gemm.plan_gemm(t, o, i, sms, not bf16)
            if alt != plan:
                planner = gemm.plan_gemm
                gemm.plan_gemm = lambda *args, **kw: alt
                try:
                    got = fn(qs, s, xi8, ax)
                    torch.cuda.synchronize()
                    ea = max_err(got, want)
                    assert (ea[1] <= 1e-5) if bf16 else torch.equal(got, want), \
                        f"{tag} {label} {name} under the other plan: {ea}"
                    tm["other_plan_ms"] = kernel_ms(lambda: fn(qs, s, xi8, ax), names)
                finally:
                    gemm.plan_gemm = planner
                tm["other_plan"] = ("whole tiles" if alt.tiles_dp == alt.tiles else
                                    f"{alt.ctas} CTAs, stream-K")
            nb, op = o * i + t * i + t * 4 + o * 4 + t * o * 4, 2 * t * o * i
            b_ms = bound(nb, op, peak)[0]
            shared = sum(1 for tile in range(plan.tiles) if plan.pieces(tile))
            per[f"{label} {name}"] = dict(
                **tm, bound_ms=b_ms, shape=f"T={t} O={o} I={i}", max_rel_err=e[1],
                ctas=plan.ctas, whole_tile_rounds=-(-plan.tiles_dp // plan.ctas),
                tiles=plan.tiles, shared_tiles=shared, k_stages=plan.nk)
            for k in ("ms", "wrapper_ms", "plain_ms", "library_ms", "library_bf16_ms"):
                if k in tm:
                    tot[k] = tot.get(k, 0.0) + tm[k]
            tot["bytes"] += nb
            tot["ops"] += op
            log(f"{tag} {label} {name} (T={t} O={o} I={i}): {tm['ms']:.4f} ms, bound "
                f"{b_ms:.4f}, _int_mm {tm['library_ms']:.4f}, {plan.ctas} CTAs, "
                f"{-(-plan.tiles_dp // plan.ctas)} whole-tile rounds, {shared} of {plan.tiles} "
                f"tiles shared over {plan.nk} K stages; rel err {e[1]:.3g}"
                + (f"; under the other plan ({tm['other_plan']}) {fmt_ms(tm['other_plan_ms'])} ms"
                   if "other_plan" in tm else ""))
            del w, qs, s, xi8, got, want
        b_ms, b_by = bound(tot.pop("bytes"), tot.pop("ops"), peak)
        layers[label] = dict(**tot, bound_ms=b_ms, bound_by=b_by)
        if label != "ragged":
            log(f"{tag} {label}, a layer: {tot['ms']:.4f} ms (bound {b_ms:.4f} by {b_by}, "
                f"_int_mm {tot['library_ms']:.4f})")
    torch.cuda.empty_cache()
    row = layers[f"llama32-1b T={dims['T']}"]
    return dict(
        name="rowq_gemm_bf16" if bf16 else "rowq_gemm", route="cuda",
        source="llamatpu_torch/csrc/gemm.cu",
        replaces="llamatpu/ops/pallas_gemm.py:" + ("65" if bf16 else "56"),
        max_abs_err=worst[0], max_rel_err=worst[1],
        tolerance=("rel <= 1e-5 of max|plain| (f32 sums of exact products, another order)"
                   if bf16 else "bit-identical"),
        ms=row["ms"], ms_source=per[f"llama32-1b T={dims['T']} wo"]["ms_source"],
        wrapper_ms=row["wrapper_ms"], plain_ms=row["plain_ms"], library_ms=row["library_ms"],
        library="torch._int_mm (int32 out, no epilogue)", bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], shape=f"one layer: wqkv+wo+w13+w2 at T={dims['T']}",
        **({"library_bf16_ms": row["library_bf16_ms"],
            "library_bf16": "bf16 torch.matmul of the cast operands (bf16 out)"} if bf16 else {}),
        per_layer=layers, per_shape=per)


def probe_weights(dev):
    from llamatpu_torch.bench import roofline

    return roofline.make_weights(PROBE_DIMS["L"], PROBE_DIMS["O"], PROBE_DIMS["I"], dev)


def check_roofline_probes(dev, w) -> list[dict]:
    """K18a-j against their plain versions on the script's [24, 4096, 4096]
    stacks (x bf16 [8, 4096]): the integer dots and the stream probes exactly,
    the f32 sums within 1e-5 of the largest plain output (the same products
    in another order). The 2-D steps are timed on each layer in turn, so the
    32 MB layer is not served from the 50 MB L2 cache."""
    import torch

    from llamatpu_torch.bench import roofline as rf

    L, O, I = (PROBE_DIMS[k] for k in ("L", "O", "I"))
    x, tt = w["x"], w["x"].shape[0]
    nb = I // rf.BLOCK
    bf, q8, qo = (w["bf16"],), (w["qs"], w["ss"]), (w["qs"],)
    wflat = w["bf16"].reshape(-1, I)
    li, lj = iter(range(10**9)), iter(range(10**9))
    # the q8 GEMVs' library call: bf16 torch.matmul on the dequantized weight
    # (prepared beforehand, as for K1 and K5), a layer in turn or the stack
    wdq = torch.stack([rf.deq_q8_current(w["qs"][i], w["ss"][i]) for i in range(L)])
    dq_flat = wdq.reshape(-1, I)
    # the int8 dots' library call: torch._int_mm on xq padded with zero rows
    # (prepared beforehand) to the fewest the call takes on the card
    xq = rf.quantize_x(x)
    xq_pad = int_mm_operand(xq, w["qs"][0].t())
    xsc = torch.ones((tt, nb), dtype=torch.float32, device=dev)
    assert torch.equal(torch._int_mm(xq_pad, w["qs"][3].t())[:tt].float(),
                       rf.step_q8_int8dot_plain(tuple(t[3] for t in q8), x)), "_int_mm disagrees"
    int_mm = f"torch._int_mm (int32 out; xq padded to {xq_pad.shape[0]} zero rows beforehand)"
    dq_mm = "bf16 torch.matmul (dequantized weight, prepared beforehand)"
    # name, its line in scripts/bench_roofline.py, weights, stacked, exact,
    # profiler names, weight bytes per layer, library yardstick and its name
    spec = [("step_pallas_bf16", 99, bf, False, False, GEMV_TC, 2 * O * I,
             lambda lw: torch.matmul(x, lw[0].T), "bf16 torch.matmul"),
            ("step_q8_current", 112, q8, False, False, GEMV_TC, O * I + O * nb * 4,
             lambda lw: torch.matmul(x, wdq[next(lj) % L].T), dq_mm),
            ("step_q8_bf16mul", 125, q8, False, False, GEMV_TC, O * I + O * nb * 4,
             lambda lw: torch.matmul(x, wdq[next(lj) % L].T), dq_mm),
            ("step_q8_int8dot", 139, q8, False, True, INT8DOT, O * I,
             lambda lw: torch._int_mm(xq_pad, lw[0].t()), int_mm + ", a layer in turn"),
            ("step_q8_int8dot_blockscale", 158, q8, False, False, INT8DOT, O * I + O * nb * 4,
             None, None),
            ("step_dma_probe", 172, bf, False, True, STREAM, 2 * O * I, None, None),
            ("call3_q8_current", 243, q8, True, False, GEMV_TC, O * I + O * nb * 4,
             lambda lw: torch.matmul(x, dq_flat.T), dq_mm),
            ("call3_q8_int8dot", 256, qo, True, True, INT8DOT, O * I,
             lambda lw: torch._int_mm(xq_pad, lw[0].reshape(-1, I).t()), int_mm + ", the stack"),
            ("call3_bf16", 267, bf, True, False, GEMV_TC, 2 * O * I,
             lambda lw: torch.matmul(x, wflat.T), "bf16 torch.matmul"),
            ("call3_dma_probe", 278, bf, True, True, STREAM, 2 * O * I, None, None)]
    rows = []
    for name, line, ws, stacked, exact, names, wbytes, lib, lib_name in spec:
        fn, plain = getattr(rf, name), getattr(rf, name + "_plain")
        # timed calls take the layers in turn; the check takes one
        args = (lambda: ws) if stacked else (lambda: tuple(t[next(li) % L] for t in ws))
        one = ws if stacked else tuple(t[3 % L] for t in ws)
        got, want = fn(one, x), plain(one, x)
        torch.cuda.synchronize()
        assert got.shape == want.shape == (tt, O)
        abs_e, rel_e = max_err(got, want)
        if exact:
            assert torch.equal(got, want), f"{name} not exact: {abs_e}"
        else:
            assert rel_e <= 1e-5, f"{name} disagrees: max abs {abs_e} rel {rel_e}"
        layers = L if stacked else 1
        nbytes = layers * wbytes + x.numel() * 2 + tt * O * 4
        ops = 0 if "dma" in name else 2 * tt * O * I * layers
        b_ms, b_by = bound(nbytes, ops, BF16_OPS_S if "int8" not in name else INT8_OPS_S)
        tm = timings(lambda: fn(args(), x), names, lambda: plain(args(), x),
                     None if lib is None else (lambda: lib(args())), iters=4 if stacked else 16)
        rows.append(dict(
            name=name, route="cuda", source="llamatpu_torch/csrc/probes.cu",
            replaces=f"scripts/bench_roofline.py:{line}", max_abs_err=abs_e, max_rel_err=rel_e,
            tolerance="exact" if exact else "rel <= 1e-5 of max|plain|", **tm,
            library=lib_name, bound_ms=b_ms, bound_by=b_by,
            gbs=nbytes / tm["ms"] / 1e6,
            shape=(f"[{L}, {O}, {I}] stack, x [{tt}, {I}]" if stacked
                   else f"one [{O}, {I}] layer of {L} in turn, x [{tt}, {I}]")))
        if name == "step_q8_int8dot_blockscale":  # no one call: the library route
            rows[-1].update(library_route_ms=time_ms(lambda: (lambda lw: torch._int_mm(
                xq_pad, lw[0].t())[:tt].float() * (lw[1] @ xsc.T).T)(args())),
                library_route="torch._int_mm, then ss @ xsc^T and the f32 product")
        log(f"{name}: {tm['ms']:.4f} ms (bound {b_ms:.4f} by {b_by}; {rows[-1]['gbs']:.1f} GB/s), "
            f"plain {tm['plain_ms']:.4f}, library {fmt_ms(tm['library_ms'])}, err {abs_e:.3g}")
    edges, q8_edges = check_gemv_tc_edges(dev), check_gemv_q8_edges(dev)
    s8_edges = check_int8dot_edges(dev)
    for r in rows:
        e = edges if r["name"] in ("step_pallas_bf16", "call3_bf16") else (
            q8_edges if r["name"] in ("step_q8_current", "step_q8_bf16mul", "call3_q8_current")
            else s8_edges if "int8dot" in r["name"] else None)
        if e is not None:
            r["edges"] = e
            r["max_rel_err"] = max(r["max_rel_err"], *(v["max_rel_err"] for v in e.values()))
    return rows


def check_gemv_tc_edges(dev) -> dict:
    """K18a / K18i's kernel (ops/probes.py gemv_bf16) on every layer of the
    GEMV_TC_EDGES stacks against the plain product, within 1e-5 of the
    largest plain output; each with its plan (K slices, CTAs)."""
    import torch

    from llamatpu_torch.ops import probes

    gen = torch.Generator(device=dev).manual_seed(18)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for t, lay, o, i in GEMV_TC_EDGES:
        w = torch.randn((lay, o, i), generator=gen, device=dev).to(torch.bfloat16)
        x = (torch.randn((t, i), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
        got, want = probes.gemv_bf16(x, w), x.float() @ w.float().transpose(-1, -2)
        torch.cuda.synchronize()
        assert got.shape == want.shape == (lay, t, o)
        abs_e, rel_e = max_err(got, want)
        plan = probes.plan_gemv(o, i, lay, sms)
        assert rel_e <= 1e-5, f"gemv_bf16 T={t} L={lay} O={o} I={i} disagrees: {abs_e} {rel_e}"
        key = f"T={t} L={lay} O={o} I={i}"
        out[key] = dict(max_abs_err=abs_e, max_rel_err=rel_e, k_slices=plan.nks, ctas=plan.ctas)
        log(f"gemv_bf16 {key}: {plan.nks} K slices on {plan.ctas} CTAs, rel err {rel_e:.3g}")
    return out


def check_gemv_q8_edges(dev) -> dict:
    """K18b / K18c / K18g's kernel (ops/probes.py gemv) in both weight kinds on
    every layer of the GEMV_Q8_EDGES stacks against the plain product on
    bench/roofline.py's dequantization, within 1e-5 of the largest plain
    output, and two runs bit-equal; each with its plan (K slices, CTAs) and
    whether a lane's scales are fixed for a unit (NB divides 16 * PARTS)."""
    import torch

    from llamatpu_torch.bench import roofline as rf
    from llamatpu_torch.ops import probes

    gen = torch.Generator(device=dev).manual_seed(19)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for t, lay, o, i, nb in GEMV_Q8_EDGES:
        qs = torch.randint(-127, 128, (lay, o, i), dtype=torch.int8, generator=gen, device=dev)
        ss = torch.randn((lay, o, nb), generator=gen, device=dev).abs() * 0.01
        x = (torch.randn((t, i), generator=gen, device=dev) * 0.1).to(torch.bfloat16)
        plan = probes.plan_gemv(o, i, lay, sms)
        for kind, deq in ((probes.W_Q8_F32, rf.deq_q8_current),
                          (probes.W_Q8_BF16, rf.deq_q8_bf16mul)):
            got, again = probes.gemv(x, qs, ss, kind), probes.gemv(x, qs, ss, kind)
            want = x.float() @ deq(qs, ss).float().transpose(-1, -2)
            torch.cuda.synchronize()
            key = f"{'f32' if kind == probes.W_Q8_F32 else 'bf16'} T={t} L={lay} O={o} I={i} NB={nb}"
            assert got.shape == want.shape == (lay, t, o)
            assert torch.equal(got, again), f"gemv {key}: two runs differ"
            abs_e, rel_e = max_err(got, want)
            assert rel_e <= 1e-5, f"gemv {key} disagrees: {abs_e} {rel_e}"
            out[key] = dict(max_abs_err=abs_e, max_rel_err=rel_e, k_slices=plan.nks,
                            ctas=plan.ctas, scales_fixed=probes.scales_fixed(nb))
            log(f"gemv {key}: {plan.nks} K slices on {plan.ctas} CTAs, rel err {rel_e:.3g}, "
                "two runs bit-equal")
    return out


def int_mm_operand(xq, wt):
    """xq [T, I] int8 padded with zero rows to the fewest that torch._int_mm
    takes against wt [I, O] on this card (it refuses short operands)."""
    import torch

    for m in range(xq.shape[0], 129):
        a = torch.zeros((m, xq.shape[1]), dtype=torch.int8, device=xq.device)
        a[:xq.shape[0]] = xq
        try:
            torch._int_mm(a, wt)
        except RuntimeError:
            continue
        return a
    raise RuntimeError("torch._int_mm takes no operand of up to 128 rows")


def forced_slices(probes, nks: int):
    """A context in which ops/probes.py plans nks K slices over the SMs
    (rounded down to a multiple of nks) whatever the shape."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        planner = probes.plan_gemv
        probes.plan_gemv = lambda o, i, layers, sms=132: probes.GemvPlan(o, i, layers, nks,
                                                                         sms - sms % nks)
        try:
            yield
        finally:
            probes.plan_gemv = planner
    return ctx()


def check_int8dot_edges(dev) -> dict:
    """K18d / K18e / K18h's kernel (ops/probes.py int8dot, the GEMV's W_S8
    kind) on every layer of the INT8DOT_EDGES stacks against the plain
    product (bench/roofline.py's float64 dot): exactly without block scales,
    within 1e-5 of the largest plain output with them; two runs bit-equal;
    each with its plan (K slices, CTAs)."""
    import contextlib

    import torch

    from llamatpu_torch.bench import roofline as rf
    from llamatpu_torch.ops import probes

    gen = torch.Generator(device=dev).manual_seed(20)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for t, lay, o, i, nb, nks, data in INT8DOT_EDGES:
        if data == "random":
            xq = torch.randint(-127, 128, (t, i), dtype=torch.int8, generator=gen, device=dev)
            w = torch.randint(-128, 128, (lay, o, i), dtype=torch.int8, generator=gen, device=dev)
        else:  # the largest |sum| of each sign
            xq = torch.full((t, i), 127, dtype=torch.int8, device=dev)
            w = torch.full((lay, o, i), 127, dtype=torch.int8, device=dev)
            w[:, 1::2] = -128
        s = xsc = None
        if nb:
            s = torch.randn((lay, o, nb), generator=gen, device=dev).abs() * 0.01
            xsc = torch.randn((t, nb), generator=gen, device=dev)
        plan = probes.GemvPlan(o, i, lay, nks, sms - sms % nks) if nks else \
            probes.plan_gemv(o, i, lay, sms)
        with forced_slices(probes, nks) if nks else contextlib.nullcontext():
            got, again = probes.int8dot(xq, w, s, xsc), probes.int8dot(xq, w, s, xsc)
        want = rf._int_dot(xq, w)
        if nb:
            want = want * (s @ xsc.T).transpose(-1, -2)
        torch.cuda.synchronize()
        key = f"T={t} L={lay} O={o} I={i} NB={nb} {data}" + (f" forced {nks} slices" if nks else "")
        assert got.shape == want.shape == (lay, t, o)
        assert torch.equal(got, again), f"int8dot {key}: two runs differ"
        abs_e, rel_e = max_err(got, want)
        if nb:
            assert rel_e <= 1e-5, f"int8dot {key} disagrees: {abs_e} {rel_e}"
        else:
            assert torch.equal(got, want), f"int8dot {key} not exact: {abs_e}"
        out[key] = dict(max_abs_err=abs_e, max_rel_err=rel_e, k_slices=plan.nks, ctas=plan.ctas,
                        max_abs_sum=want.abs().max().item())
        log(f"int8dot {key}: {plan.nks} K slices on {plan.ctas} CTAs, rel err {rel_e:.3g}, "
            "two runs bit-equal")
    return out


def check_dma_probes(dev, w) -> list[dict]:
    """K19a-c against their plain versions on the [24, 4096, 4096] stacks at
    every (to) and (depth, ch) of the script, all exactly (values moved, or
    integer and chunk-ordered f32 sums as the plain version takes them); the
    row's times at to = 1024 and (depth, ch) = (4, 512)."""
    import torch

    from llamatpu_torch.bench import dma_sweep as ds

    L, O, I = (PROBE_DIMS[k] for k in ("L", "O", "I"))
    x, tt = w["x"], w["x"].shape[0]
    configs = {"probe_blockspec": [((to,), "qs") for to in (256, 1024, 2048)],
               "probe_manual_dma": [((d, c), "qs") for d, c in ((2, 512), (4, 512), (8, 256),
                                                                (4, 1024), (8, 512), (16, 256))]
               + [((4, 512), "bf16")],
               "int8dot_manual_dma": [((d, c), "qs") for d, c in ((4, 512), (8, 256), (8, 512))]}
    head = {"probe_blockspec": ((1024,), "qs"), "probe_manual_dma": ((4, 512), "qs"),
            "int8dot_manual_dma": ((4, 512), "qs")}
    line = {"probe_blockspec": 68, "probe_manual_dma": 120, "int8dot_manual_dma": 173}
    rows = []
    for name, cfgs in configs.items():
        factory, plain = getattr(ds, name), getattr(ds, name + "_plain")
        per = {}
        for args, key in cfgs:
            ws = (w[key],) if name != "int8dot_manual_dma" else (w[key], None)
            call = factory(*args)
            got, want = call(ws, x), plain(ws, x, *args)
            torch.cuda.synchronize()
            assert torch.equal(got, want), f"{name}{args} {key} not exact: {max_err(got, want)}"
            esize = w[key].element_size()
            nbytes = L * O * I * esize + x.numel() * 2 + tt * O * 4
            ops = 2 * tt * L * O * I if name == "int8dot_manual_dma" else 0
            b_ms, b_by = bound(nbytes, ops, INT8_OPS_S)
            ms = time_ms(lambda: call(ws, x), iters=4)
            per[f"{args}-{key}"] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by,
                                         gbs=nbytes / ms / 1e6)
            log(f"{name}{args} {key}: {ms:.4f} ms (bound {b_ms:.4f}; {nbytes / ms / 1e6:.1f} GB/s), "
                "exact")
            if (args, key) == head[name]:
                tm = timings(lambda: call(ws, x), STREAM, lambda: plain(ws, x, *args), None,
                             iters=4)
                hb = (b_ms, b_by, nbytes)
        rows.append(dict(
            name=name, route="cuda", source="llamatpu_torch/csrc/probes.cu",
            replaces=f"scripts/bench_dma_sweep.py:{line[name]}", max_abs_err=0.0, max_rel_err=0.0,
            tolerance="exact", **tm, library=None, bound_ms=hb[0], bound_by=hb[1],
            gbs=hb[2] / tm["ms"] / 1e6,
            shape=f"{head[name][0]} over the {head[name][1]} [{L}, {O}, {I}] stack",
            by_config=per))
    return rows


def check_slice6_kernels(dev) -> list[dict]:
    import torch

    rows = [check_tail_kt(dev), check_rowq_gemm(dev, bf16=True)]
    w = probe_weights(dev)
    rows += check_roofline_probes(dev, w) + check_dma_probes(dev, w)
    del w
    torch.cuda.empty_cache()
    return rows


def device_breakdown(fn) -> dict:
    """Run fn() once under torch.profiler (device activity only, so the host
    is barely slowed): device busy time, the traced window's host wall time,
    the idle share between them, and the kernels that take most of the time.
    Busy time is the union of the device activities' intervals, and each
    moment of it goes to the activity that started first: a kernel launched
    with programmatic dependent launch (rowq_tc.cuh's phases) starts while
    the one before it runs and waits for it, and that wait is the earlier
    kernel's time, counted once. `overlap_ms` is what a sum of the
    activities' own times would count twice."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start)
    own, count, reach = {}, {}, float("-inf")
    for start, end, name in spans:  # microseconds
        own[name] = own.get(name, 0.0) + max(0.0, end - max(start, reach)) / 1e3
        count[name] = count.get(name, 0) + 1
        reach = max(reach, end)
    assert spans, "the trace holds no device activity"
    busy = sum(own.values())
    rows = sorted(own.items(), key=lambda r: -r[1])
    return {"busy_ms": busy, "wall_ms": wall_ms, "idle_share": 1.0 - busy / wall_ms,
            "overlap_ms": sum(e - s for s, e, _ in spans) / 1e3 - busy,
            "kernels": [{"name": k[:120], "ms": ms, "count": count[k]} for k, ms in rows]}


# each kernel's launches as the profiler names them, and where they are read:
# (path, trace, kernel names, wrapper calls per table row). K4's row is one
# layer's four projections; K5's and K7's rows are one decode token (16 layers
# x 4 projections + the head: 65 calls; K7's path has 4 layers, 17 calls).
IN_PATH = {
    "rowq_gemv": ("main", "decode16_trace", K1_NAMES, 1),
    "qkv_norm_fused_rowq": ("main", "decode16_trace", K2_TC, 1),
    "layer_attn_tail_fused_rowq": ("main", "decode16_trace", K3_NAMES, 1),
    "rowq_gemm": ("main", "prefill_trace", K4_NAMES, 4),
    "block_matmul": ("gguf", "decode16_trace", K5_NAMES, 65),
    "decode_attention_fused_write": ("gguf", "decode16_trace", DENSE, 1),
    "packed4_matmul": ("pack4", "decode16_trace", K7_NAMES, 17),
    "decode_attention_paged": ("serve", "decode16_trace", PAGED, 1),
    # K9's three phases: rowq_tc.cuh in bf16, gemv.cuh's tiled GEMV in f32
    "layer_tail_fused_rowq": ("serve_rowq", "decode16_trace", K9_TC + tuple(
        f"float, {p}>" for p in ("0, 2", "1, 4", "0, 3")), 1),
    # K20 at the 24 lanes of a Phi-3-medium BatchEngine step
    "ffn_fused_rowq": ("phi3_b24", "decode16_trace", K20_TC, 1),
    # K10-K13's rows are one MoE layer of a decode token: the gate+up and the
    # down call (each path runs only its own grouped kernel)
    "grouped_block_matmul": ("moe", "decode16_trace", MOE_KERNELS, 2),
    "grouped_packed4_matmul": ("moe_pack4", "decode16_trace", MOE_KERNELS, 2),
    "grouped_rowq_matmul": ("moe_rowq", "decode16_trace", MOE_KERNELS, 2),
    "grouped_dense_matmul": ("moe_dense", "decode16_trace", MOE_KERNELS, 2),
    # slice 5: K14 on the 32k bf16 path, K15 on the f32 4000-row path, K6's
    # int8 variant at a 4000-row int8 cache, K8's in the int8 HTTP run
    "decode_attention_split_fused_write": ("longctx", "decode16_trace", STRIPE, 1),
    "decode_attention": ("k15", "decode16_trace", STRIPE, 1),
    "decode_attention_fused_write_q": ("k6_int8", "decode16_trace", DENSE, 1),
    "decode_attention_paged_q": ("serve_int8", "decode16_trace", PAGED, 1),
    # slice 23: the int8 mode's block dot, one decode token (65 calls) of the
    # int8-mode Engine on the Q8_0 GGUF
    "int8_dot": ("int8", "decode16_trace", INT8_NAMES, 65),
}


def in_path_ms(paths: dict, name: str, path: str | None = None) -> float:
    """Device ms per table row of a kernel inside its traced main path (or
    inside `path`'s trace of the same name)."""
    main, trace, keys, per_row = IN_PATH[name]
    tr = paths[path or main][trace]
    return per_row * sum(r["ms"] for r in tr["kernels"]
                         if any(k in r["name"] for k in keys)) / tr["launches"][name]


# K14's and K15's wrappers: one table row each, launches summed over them
K14_WRAPPERS = ("decode_attention_split_fused_write", "decode_attention_split_fused_write_q",
                "decode_attention_split", "decode_attention_split_q",
                "decode_attention_split_stats")
K15_WRAPPERS = ("decode_attention", "decode_attention_q")
ROW_WRAPPERS = {"decode_attention_split_fused_write": K14_WRAPPERS,
                "decode_attention": K15_WRAPPERS}


def counters():
    from llamatpu_torch.bench import dma_sweep, roofline
    from llamatpu_torch.ops import (attention, ffn_fused, gemm, int8_matmul, layer_fused,
                                    moe_grouped, quant_matmul)

    return {"rowq_gemv": quant_matmul.rowq_gemv, "rowq_gemm": gemm.rowq_gemm,
            "rowq_gemm_bf16": gemm.rowq_gemm_bf16,
            "layer_tail_kt_fused_rowq": layer_fused.layer_tail_kt_fused_rowq,
            **{f.__name__: f for f in roofline.KERNELS + dma_sweep.FACTORIES},
            "qkv_norm_fused_rowq": layer_fused.qkv_norm_fused_rowq,
            "layer_attn_tail_fused_rowq": layer_fused.layer_attn_tail_fused_rowq,
            "block_matmul": quant_matmul.block_matmul,
            "decode_attention_fused_write": attention.decode_attention_fused_write,
            "decode_attention_fused_write_q": attention.decode_attention_fused_write_q,
            "packed4_matmul": quant_matmul.packed4_matmul,
            "decode_attention_paged": attention.decode_attention_paged,
            "decode_attention_paged_q": attention.decode_attention_paged_q,
            "layer_tail_fused_rowq": layer_fused.layer_tail_fused_rowq,
            "ffn_fused_rowq": ffn_fused.ffn_fused_rowq,
            "grouped_block_matmul": moe_grouped.grouped_block_matmul,
            "grouped_packed4_matmul": moe_grouped.grouped_packed4_matmul,
            "grouped_rowq_matmul": moe_grouped.grouped_rowq_matmul,
            "grouped_dense_matmul": moe_grouped.grouped_dense_matmul,
            **{n: getattr(attention, n) for n in K14_WRAPPERS + K15_WRAPPERS},
            "int8_dot": int8_matmul.int8_dot}


def require_kernels(res: dict, label: str, want: dict) -> None:
    """Each trace of a path (want: {trace key: kernel names}) holds a launch
    of every named kernel."""
    for key, names in want.items():
        seen = [k["name"] for k in res[key]["kernels"]]
        for n in names:
            assert any(n in k for k in seen), f"{label}: {key} holds no {n}: {seen[:12]}"


def drive_engine(engine, prompt: list[int], tg: int, want_fn, label: str,
                 repeats: int = 3) -> dict:
    """The main-path run of an engine: every count set to 0, prefill of the
    whole prompt, then `tg` decode steps; the counts read just after and held
    to want_fn(decode steps). Then repeats of the same run (host-clock times
    vary run to run) and traces of one prefill and a 16-token decode window."""
    import torch

    cfg = engine.cfg
    pp = len(prompt)
    engine.reset()
    engine.generate(prompt, 8)  # warm-up: every kernel built and launched once
    engine.reset()
    torch.cuda.synchronize()

    fns = counters()
    for f in fns.values():
        f.launches = 0
    t0 = time.perf_counter()
    tok, logits = engine.prefill(prompt, 0)
    first = int(tok[0])
    pp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out, tok_v, pos, remaining = [], first, pp, tg
    while remaining > 0:
        window = engine.decode_window_run(tok_v, pos, remaining)
        if not window:
            break
        out += window
        tok_v, pos, remaining = window[-1], pos + len(window), remaining - len(window)
    tg_s = time.perf_counter() - t0
    launches = {k: f.launches for k, f in fns.items()}

    want = {k: 0 for k in fns}
    want.update(want_fn(len(out)))
    assert len(out) == tg, f"{label}: decoded {len(out)} of {tg} tokens"
    assert launches == want, f"{label}: launch counts {launches} != path {want}"
    assert bool(torch.isfinite(logits).all()) and logits.shape == (1, cfg.vocab_size)
    assert all(0 <= t < cfg.vocab_size for t in [first] + out)
    res = dict(prefill_tok_s=pp / pp_s, decode_tok_s=len(out) / tg_s, prefill_s=pp_s,
               decode_s=tg_s, pp=pp, tg=len(out), launches=launches,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"{label}: prefill {pp} tok in {pp_s:.4f} s ({res['prefill_tok_s']:.1f} tok/s), "
        f"decode {len(out)} tok in {tg_s:.4f} s ({res['decode_tok_s']:.2f} tok/s), "
        f"launches {launches}")
    runs = []
    for _ in range(repeats):
        engine.reset()
        t0 = time.perf_counter()
        tok, _ = engine.prefill(prompt, 0)
        t1 = (int(tok[0]), time.perf_counter())[1]
        window = engine.decode_window_run(first, pp, tg)
        runs.append((pp / (t1 - t0), len(window) / (time.perf_counter() - t1)))
    res["repeats_prefill_tok_s"] = [r[0] for r in runs]
    res["repeats_decode_tok_s"] = [r[1] for r in runs]
    log(f"{label}: repeats prefill tok/s {[round(r[0], 1) for r in runs]}, "
        f"decode tok/s {[round(r[1], 2) for r in runs]}")
    # where the time goes: device busy time of one prefill and of a 16-token
    # decode window (traced separately; the timed runs above are not)
    engine.reset()
    for key, fn in (("prefill_trace", lambda: engine.prefill(prompt, 0)),
                    ("decode16_trace", lambda: engine.decode_window_run(first, pp, 16))):
        for f in fns.values():
            f.launches = 0
        res[key] = device_breakdown(fn)
        res[key]["launches"] = {k: f.launches for k, f in fns.items()}
        tr = res[key]
        log(f"{label}: {key}: device busy {tr['busy_ms']:.3f} of {tr['wall_ms']:.3f} ms "
            f"(idle share {tr['idle_share']:.3f}); top "
            f"{[(t['name'][:40], round(t['ms'], 3)) for t in tr['kernels'][:6]]}")
    return res


def configure(engine, cache_len: int, cache_dtype, prefill_chunk: int, decode_window: int):
    """Point an Engine at another cache, its weights staying on the card: the
    fields its constructor sets from these arguments, then a fresh cache."""
    engine.cache_len, engine.cache_dtype = cache_len, cache_dtype
    engine.prefill_chunk, engine.decode_window = min(prefill_chunk, cache_len), decode_window
    engine.reset()


def drive_long(engine, prompt: list[int], tg: int, want_fn, label: str) -> dict:
    """One counted run of an engine at its cache: every count set to 0,
    prefill of the prompt, `tg` greedy decode steps, the counts read just
    after and held to want_fn(prefill chunks, decode steps); peak device
    memory over the run; then a traced 16-step decode window after it."""
    import torch

    cfg = engine.cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fns = counters()
    for f in fns.values():
        f.launches = 0
    t0 = time.perf_counter()
    tok, logits = engine.prefill(prompt, 0)
    first = int(tok[0])
    pp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out, tok_v, pos, remaining = [], first, len(prompt), tg
    while remaining > 0:
        window = engine.decode_window_run(tok_v, pos, remaining)
        if not window:
            break
        out += window
        tok_v, pos, remaining = window[-1], pos + len(window), remaining - len(window)
    tg_s = time.perf_counter() - t0
    launches = {k: f.launches for k, f in fns.items()}
    chunks = -(-len(prompt) // engine.prefill_chunk)
    want = {k: 0 for k in fns}
    want.update(want_fn(chunks, len(out)))
    assert len(out) == tg, f"{label}: decoded {len(out)} of {tg} tokens"
    assert launches == want, f"{label}: launch counts {launches} != path {want}"
    assert bool(torch.isfinite(logits).all()) and logits.shape == (1, cfg.vocab_size)
    assert all(0 <= t < cfg.vocab_size for t in [first] + out)
    res = dict(prefill_tok_s=len(prompt) / pp_s, decode_tok_s=len(out) / tg_s, prefill_s=pp_s,
               decode_s=tg_s, pp=len(prompt), tg=len(out), chunks=chunks, launches=launches,
               tokens=[first] + out, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               cache_gb=sum(t.numel() * t.element_size() for t in (engine.cache.kv,
                                                                   engine.cache.scale)
                            if t is not None) / 1e9)
    for f in fns.values():
        f.launches = 0
    res["decode16_trace"] = tr = device_breakdown(
        lambda: engine.decode_window_run(out[-1], pos, 16))
    tr["launches"] = {k: f.launches for k, f in fns.items()}
    res["next"] = [out[-1], pos]  # where the window after the run starts
    # the prompt's last chunk again (the same rows rewritten with the same
    # values): where a prefill chunk's time goes at the end of the cache
    c = engine.prefill_chunk
    last = (len(prompt) - 1) // c * c
    res["prefill_chunk_trace"] = pt = device_breakdown(lambda: engine.prefill(prompt[last:], last))
    log(f"{label}: cache {engine.cache_len} {str(engine.cache_dtype)[6:]} ({res['cache_gb']:.3f} "
        f"GB), prefill {len(prompt)} tok in {pp_s:.3f} s ({res['prefill_tok_s']:.1f} tok/s), "
        f"decode {len(out)} tok in {tg_s:.3f} s ({res['decode_tok_s']:.2f} tok/s), peak "
        f"{res['peak_mem_gb']:.2f} GB, launches {({k: v for k, v in launches.items() if v})}; "
        f"traced 16 steps at pos {pos}: busy {tr['busy_ms']:.3f} of {tr['wall_ms']:.3f} ms (idle "
        f"share {tr['idle_share']:.3f}); top "
        f"{[(t['name'][:40], round(t['ms'], 3)) for t in tr['kernels'][:5]]}; traced prefill "
        f"chunk at pos {last}: busy {pt['busy_ms']:.3f} of {pt['wall_ms']:.3f} ms (idle share "
        f"{pt['idle_share']:.3f}); top "
        f"{[(t['name'][:40], round(t['ms'], 3)) for t in pt['kernels'][:5]]}")
    return res


SPEC_K = 8


def spec_graph_decode(engine, prompt: list[int], window: int) -> dict:
    """Speculative windows from the captured verify step against the same
    windows run eagerly on the card, from one prefilled cache, id history
    and generator state (the history is put back before each window: its
    rows at and past pos feed the drafts), greedy and sampled (0.8 / 0.95):
    the graph's tokens equal the eager window's and a second graph window's,
    and each window's launches equal the forwards it ran x the capture's.
    Then a traced greedy window from the graph: busy ms, idle share, tok/s;
    the capture's seconds and the pool's bytes."""
    import torch

    from llamatpu_torch.runtime.decode_graph import switches

    engine.reset()
    tok0, pos0 = int(engine.prefill(prompt)[0][0]), len(prompt)
    ids0 = engine._ids.clone()
    fns = counters()

    def run(temp):
        engine._ids.copy_(ids0)
        for f in fns.values():
            f.launches = 0
        steps, rounds, parked = engine.decode_steps, engine.spec_rounds, engine.spec_parked
        out = engine.decode_window_run(tok0, pos0, window, temperature=temp, top_p=0.95)
        assert len(out) == window, f"spec: {len(out)} of {window} tokens"
        return dict(tokens=out, launches={k: f.launches for k, f in fns.items() if f.launches},
                    forwards_run=engine.decode_steps - steps,
                    rounds=engine.spec_rounds - rounds, parked=engine.spec_parked - parked)

    res = {"window": window}
    gen = engine.generator
    for mode, temp in (("greedy", 0.0), ("sampled", 0.8)):
        state = gen.get_state()
        graph = run(temp)  # captures the mode's verify step where it has none
        gen.set_state(state)
        again = run(temp)
        gen.set_state(state)
        with engine._graphs._eager_windows():
            eager = run(temp)
        cap = engine._graphs.graphs[(engine.spec_k, temp != 0.0, engine.impl, switches())]
        assert graph["tokens"] == eager["tokens"] == again["tokens"], \
            f"spec {mode}: graph {graph['tokens']} != eager {eager['tokens']} or again"
        for r in (graph, again, eager):
            want = {k: cap.counts[f] * r["forwards_run"] for k, f in fns.items()
                    if f in cap.counts}
            assert r["launches"] == want and want, \
                f"spec {mode}: launches {r['launches']} != forwards x captured {want}"
        res[mode] = dict(graph=graph, eager=eager, capture_s=cap.seconds,
                         captured={k: cap.counts[f] for k, f in fns.items() if f in cap.counts})
    res["pool_bytes"] = graph_pool_bytes(engine._graphs.pool)
    tr = res["trace"] = device_breakdown(lambda: run(0.0))
    tr["tok_s"] = window / (tr["wall_ms"] / 1e3)
    pool = res["pool_bytes"]
    log(f"spec: graph == eager (greedy and sampled) over {window}-token windows, launches = "
        f"forwards x captured {res['greedy']['captured']}; greedy {graph_line(res['greedy'])}, "
        f"sampled {graph_line(res['sampled'])}; capture {res['greedy']['capture_s']:.3f} s "
        f"(greedy) {res['sampled']['capture_s']:.3f} s (sampled), pool "
        f"{'not measured' if pool is None else f'{pool / 1e6:.1f} MB'}; traced greedy window: "
        f"busy {tr['busy_ms']:.3f} ms idle {tr['idle_share']:.3f} {tr['tok_s']:.1f} tok/s; top "
        f"{[(t['name'][:40], round(t['ms'], 3)) for t in tr['kernels'][:5]]}")
    engine.reset()
    return res


def graph_line(mode: dict) -> str:
    g = mode["graph"]
    return f"{g['forwards_run']} forwards in {g['rounds']} rounds, {g['parked']} parked"


def plain_gap(engine, prompt: list[int], tokens: list[int], i: int, other: int) -> dict:
    """Where a spec greedy stream parts from the plain one at decode index
    i (plain token tokens[i], spec token `other`): on the plain stream's
    cache after the prefill and tokens[:i], the plain step's logits (the
    decode step's forward_tokens at T = 1 on the device position) and the
    verify forward's (T = K + 1 rows from the same position, its row 0,
    which the later rows do not reach), both run eagerly: the plain
    top-1 - top-2 gap, the two paths' differences there (max |d| over the
    vocab, d at the two tokens) and the verify row's argmax."""
    import torch

    from llamatpu_torch.models.transformer import forward_tokens

    engine.reset()
    feed = int(engine.prefill(prompt)[0][0])
    if i:
        assert engine.decode_window_run(feed, len(prompt), i) == tokens[:i]
        feed = tokens[i - 1]
    dev = engine.device
    pos = torch.tensor([len(prompt) + i], dtype=torch.int32, device=dev)
    runs = []
    for t in (1, SPEC_K + 1):
        x = torch.full((1, t), feed, dtype=torch.int32, device=dev)
        logits, _ = forward_tokens(engine.cfg, engine.weights, x, engine.cache, pos,
                                   s_limit=engine.cache_len)
        runs.append(logits[0, 0])
    plain, verify = runs
    d = verify - plain
    top = torch.topk(plain, 2).values.tolist()
    engine.reset()
    return dict(index=i, argmax=int(plain.argmax()), gap=top[0] - top[1],
                std=float(plain.std()), max_abs_d=float(d.abs().max()),
                d_plain_token=float(d[tokens[i]]), d_spec_token=float(d[other]),
                verify_argmax=int(verify.argmax()))


def run_spec_paths(dev, model, engine) -> dict:
    """Slice 21's speculative decode on the main path's model (Llama-3.2-1B
    q8_row, full width and depth): `engine` is the plain main-path Engine
    (cache 1024, prefill chunk 512, window 128); a spec Engine of K = 8 on
    the same weights and geometry. bench/spec_bench.py's tiled 512-token
    prompt, tg128 greedy on each, counts set to 0 just before each run:
    - the spec run's launches: K2 = K9 = L x forwards run (the JAX fits
      take both at K + 1 = 9 rows), K1 = forwards run + prefill chunks, K4
      = 4L x chunks, no K3;
    - spec greedy tokens equal plain greedy's, or part at an argmax
      near-tie: the plain step's top-1 - top-2 gap there is at most twice
      the largest difference between the plain step's and the verify
      forward's logits on the same cache (`plain_gap`), all logged;
    - spec_graph_decode: graph == eager, greedy and sampled;
    - plain and spec tok/s, accept rate, forwards, rounds, parked, and a
      traced 128-token window of each;
    then the harness bench/spec_bench.py on the same Q8_0 weights served as
    block quants (K5): K5 = 65 x (chunks + forwards run), K6 only in the
    plain run."""
    import gc

    import torch

    from llamatpu_torch.bench import spec_bench
    from llamatpu_torch.ops import layer_fused
    from llamatpu_torch.runtime.engine import Engine

    cfg = model.cfg
    L, tg = cfg.n_layers, 128
    prompt = spec_bench.tiled_prompt(min(cfg.vocab_size, 128000))
    t0 = time.perf_counter()
    spec = Engine(model, cache_len=1024, prefill_chunk=512, decode_window=128, rowq=True,
                  device=dev, spec_decode=SPEC_K)
    log(f"spec: K = {SPEC_K} engine served in {time.perf_counter() - t0:.1f} s (capture "
        f"{spec.metrics.compile_s:.3f} s)")
    lw = spec.weights["layers"]
    assert layer_fused.qkv_fits(SPEC_K + 1, lw["wqkv"].qs.shape[-2], cfg.dim, 2)
    assert layer_fused.tail_fits(SPEC_K + 1, cfg.dim, lw["wo"].qs.shape[-1],
                                 lw["w2"].qs.shape[-1], 2)
    out = {}
    for label, eng in (("plain", engine), ("spec", spec)):
        r = spec_bench.timed_run(eng, prompt, tg)
        r["decode_tok_s"] = len(r["tokens"]) / r["seconds"]
        n, c = r["steps"], r["chunks"]
        # K3 a layer and step on the plain path; K2 + K9 at K + 1 rows on the spec one
        want = {"rowq_gemv": n + c, "qkv_norm_fused_rowq": L * n, "rowq_gemm": 4 * L * c,
                "layer_tail_fused_rowq" if eng is spec else "layer_attn_tail_fused_rowq": L * n}
        assert r["launches"] == want, f"spec: {label} launch counts {r['launches']} != {want}"
        if eng is spec:
            ex = spec.metrics.extra
            r.update(spec_accept_rate=ex["spec_accept_rate"], spec_forwards=ex["spec_forwards"],
                     rounds=spec.spec_rounds, parked=spec.spec_parked)
            assert r["steps"] == r["spec_forwards"] + r["parked"]
        assert len(r["tokens"]) == tg and all(0 <= t < cfg.vocab_size for t in r["tokens"])
        out[label] = r
    a, b = out["plain"]["tokens"], out["spec"]["tokens"]
    part = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    out["parting"] = None
    if part is not None:
        gap = out["parting"] = plain_gap(engine, prompt, a, part, b[part])
        assert gap["argmax"] == a[part], f"spec: the plain step's argmax {gap} != {a[part]}"
        # a near-tie: the two paths' logits differ by more than the plain gap
        assert gap["gap"] <= 2 * gap["max_abs_d"], \
            f"spec: greedy streams part at {part} where the plain gap is no near-tie: {gap}"
    s = out["spec"]
    log(f"spec: main path tg{tg}: plain {out['plain']['decode_tok_s']:.1f} tok/s, spec "
        f"{s['decode_tok_s']:.1f} tok/s (host clock, prefill included); accept rate "
        f"{s['spec_accept_rate']}, {s['spec_forwards']} forwards, {s['rounds']} rounds, "
        f"{s['parked']} parked; launches {s['launches']}; greedy streams "
        + ("equal" if part is None else f"part at index {part}: {json.dumps(out['parting'])}"))
    out["spec_graph"] = spec_graph_decode(spec, prompt, tg)
    engine.reset()
    tok0 = int(engine.prefill(prompt)[0][0])
    tr = out["plain_trace"] = device_breakdown(
        lambda: engine.decode_window_run(tok0, len(prompt), tg))
    tr["tok_s"] = tg / (tr["wall_ms"] / 1e3)
    st = out["spec_graph"]["trace"]
    fwd = out["spec_graph"]["greedy"]["graph"]["forwards_run"]
    log(f"spec: traced {tg}-token windows: plain busy {tr['busy_ms']:.3f} ms "
        f"({tr['busy_ms'] / tg:.4f} a step) idle {tr['idle_share']:.3f} {tr['tok_s']:.1f} "
        f"tok/s | spec busy {st['busy_ms']:.3f} ms ({st['busy_ms'] / fwd:.4f} a forward of "
        f"{fwd}) idle {st['idle_share']:.3f} {st['tok_s']:.1f} tok/s")
    engine.reset()
    del spec
    gc.collect()
    torch.cuda.empty_cache()
    # the harness: the same Q8_0 weights as block quants (K5 every projection and the head)
    rows = out["bench"] = spec_bench.bench_rows(model, SPEC_K, dev, "llama32-1b")
    for row in rows:
        n, c = row["forwards_run"], row["prefill_chunks"]
        want = {"block_matmul": (4 * L + 1) * (c + n)}
        if not row["K"]:
            want["decode_attention_fused_write"] = L * n
        assert row["launches"] == want, f"spec_bench K={row['K']}: {row['launches']} != {want}"
        assert row["tg"] == tg
    a, b = rows[0]["tokens"], rows[1]["tokens"]
    out["bench_parting"] = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    log("spec_bench: " + json.dumps([{k: v for k, v in r.items() if k != "tokens"}
                                     for r in rows])
        + f"; greedy streams first differ at {out['bench_parting']} (reported, not gated)")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_main_and_long_paths(dev, overrides=None) -> dict:
    """Slice 1's path (synthetic q8_0 served as q8_row, K1-K4), a one-lane
    BatchEngine on the same weights (`batch1`: K3 at the device positions of
    its decode step, as the JAX BatchEngine), then slice 5's on the same
    Engine, the weights built once with context_length 32768 and the cache
    swapped between runs:
    - longctx / longctx_int8: cache 32768 in bf16 and int8, prefill chunk
      512, a 32000-token seeded prompt, 128 greedy tokens (K14 fused, K2, K9
      and K1 per step; K4 in the prefill);
    - k15: f32 cache 4000 rows (4128 physical: a long cache whose tile is
      32 rows, so the JAX package's full-stripe kernel), a 3000-token prompt,
      32 tokens (K15);
    - k6_int8: the same at an int8 cache (K6-int8);
    - k15_int8 and k14_unfused_int8: LLAMATPU_NO_FUSED_ATTN=1 at int8 caches
      of 4000 and 16384 rows (K15-int8; K14 unfused int8), unset after."""
    import numpy as np
    import torch

    from llamatpu_torch.models.synthetic import build_synthetic_model
    from llamatpu_torch.runtime.batch_engine import BatchEngine
    from llamatpu_torch.runtime.engine import Engine

    pp, tg = 512, 128
    t0 = time.perf_counter()
    model = build_synthetic_model("llama32-1b", quant="q8_0", context_length=32768,
                                  overrides=overrides)
    engine = Engine(model, cache_len=1024, prefill_chunk=512, decode_window=128, rowq=True,
                    device=dev)
    log(f"main: model built and served in {time.perf_counter() - t0:.1f} s "
        f"(weight prep + upload {engine.metrics.weight_upload_s:.1f} s)")
    L, V = model.cfg.n_layers, model.cfg.vocab_size
    prompt = np.random.default_rng(42).integers(0, V, pp).tolist()
    out = {"main": drive_engine(engine, prompt, tg, lambda n: {
        "rowq_gemv": 1 + n, "qkv_norm_fused_rowq": L * n, "layer_attn_tail_fused_rowq": L * n,
        "rowq_gemm": 4 * L}, "main")}
    out["main"]["graph"] = graph_decode(engine, "main")
    out["spec"] = run_spec_paths(dev, model, engine)
    # a one-lane BatchEngine on the same weights: its positions live on the
    # device, and K3 reads them there, so it takes K3 every layer and step
    # where the JAX BatchEngine takes its megakernel
    lane = BatchEngine(model, batch_size=1, cache_len=1024, prefill_chunk=128, decode_window=16,
                       rowq=True, device=dev)
    out["batch1"] = drive_batch(lane, [prompt[:100]], 32, lambda steps, chunks: dict(
        rowq_gemv=steps + chunks, qkv_norm_fused_rowq=L * steps,
        layer_attn_tail_fused_rowq=L * steps, rowq_gemm=4 * L * chunks), "one-lane batch")
    out["batch1"]["graph"] = graph_decode(lane, "batch1")
    del lane

    def want(kernel):  # per decode step K2 = K9 = K14 (or K15, K6-int8) = L, K1 = 1
        return lambda chunks, n: {"rowq_gemv": chunks + n, "rowq_gemm": 4 * L * chunks,
                                  "qkv_norm_fused_rowq": L * n, "layer_tail_fused_rowq": L * n,
                                  kernel: L * n}

    # LLAMATPU_NO_ATTN_TAIL (read at each call): the main path's cache takes
    # K6 + K9 per layer and step instead of K3, as the JAX package does
    configure(engine, 1024, torch.bfloat16, 512, 32)
    os.environ["LLAMATPU_NO_ATTN_TAIL"] = "1"
    try:
        out["no_attn_tail"] = drive_long(engine, prompt, 32, want("decode_attention_fused_write"),
                                         "no_attn_tail")
    finally:
        os.environ.pop("LLAMATPU_NO_ATTN_TAIL", None)

    rng = np.random.default_rng(32)
    long_prompt = rng.integers(0, V, 32000).tolist()
    for label, cdt, kernel in (
            ("longctx", torch.bfloat16, "decode_attention_split_fused_write"),
            ("longctx_int8", torch.int8, "decode_attention_split_fused_write_q")):
        configure(engine, 32768, cdt, 512, 128)
        out[label] = drive_long(engine, long_prompt, 128, want(kernel), label)
        out[label]["graph"] = graph_decode(engine, label, start=out[label]["next"])
    a, b = out["longctx"]["tokens"], out["longctx_int8"]["tokens"]
    out["longctx_int8"]["first_diff_vs_bf16"] = next(
        (i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    log(f"longctx: bf16 and int8 greedy tokens first differ at index "
        f"{out['longctx_int8']['first_diff_vs_bf16']} of {len(a)} (reported, not gated)")
    prompt3k = rng.integers(0, V, 3000).tolist()
    for label, cdt, clen, switch, kernel in (
            ("k15", torch.float32, 4000, False, "decode_attention"),
            ("k6_int8", torch.int8, 4000, False, "decode_attention_fused_write_q"),
            ("k15_int8", torch.int8, 4000, True, "decode_attention_q"),
            ("k14_unfused_int8", torch.int8, 16384, True, "decode_attention_split_q")):
        configure(engine, clen, cdt, 512, 32)
        if switch:
            os.environ["LLAMATPU_NO_FUSED_ATTN"] = "1"
        try:
            out[label] = drive_long(engine, prompt3k, 32, want(kernel), label)
        finally:
            os.environ.pop("LLAMATPU_NO_FUSED_ATTN", None)
    del engine, model
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- GGUF path
# the Llama 3 chat specials at their ids in the published vocab
LLAMA3_SPECIALS = {128000: "<|begin_of_text|>", 128001: "<|end_of_text|>",
                   128006: "<|start_header_id|>", 128007: "<|end_header_id|>",
                   128009: "<|eot_id|>"}


def llama3_vocab(vocab_size: int) -> tuple[list[str], list[int], list[str]]:
    """(tokens, token types, merges) of a byte-level BPE vocab padded to
    `vocab_size`: the 256 byte tokens, a few merges, filler tokens up to
    128000, then the Llama 3 specials and reserved control tokens."""
    from llamatpu_torch.tokenizer.bpe import bytes_to_unicode

    enc = bytes_to_unicode()
    tokens = [enc[i] for i in range(256)]
    pairs = [("Ġ", "t"), ("h", "e"), ("Ġt", "he"), ("i", "n"), ("Ġ", "a"), ("e", "r"),
             ("o", "n"), ("Ġ", "s"), ("Ġ", "w"), ("r", "e"), ("Ġ", "b"), ("l", "u")]
    merges = [f"{a} {b}" for a, b in pairs]
    tokens += [a + b for a, b in pairs]
    tokens += [f"tok{i}" for i in range(len(tokens), 128000)]
    types = [1] * len(tokens)
    for i in range(128000, vocab_size):
        tokens.append(LLAMA3_SPECIALS.get(i, f"<|reserved_special_token_{i - 128000}|>"))
        types.append(3)
    return tokens, types, merges


def write_llama_gguf(model, path, quant: str = "q8_0") -> None:
    """A synthetic q8_0 model as a Llama 3 GGUF, through the port's writer:
    Q8_0 block values as they are with the scales rounded to f16 (Q4_0: the
    values >> 4, scales x 16), f32 norms, the vocab head tied to token_embd
    (no output.weight, as Llama-3.2-1B ships)."""
    import numpy as np

    from llamatpu_torch.gguf import GGMLType, GGUFWriter, quants

    cfg, w = model.cfg, model.weights
    lw = w["layers"]
    gw = GGUFWriter()
    gw.add("general.architecture", "llama")
    gw.add("general.name", "synthetic llama32-1b")
    for key, v in (("embedding_length", cfg.dim), ("feed_forward_length", cfg.hidden_dim),
                   ("block_count", cfg.n_layers), ("attention.head_count", cfg.n_heads),
                   ("attention.head_count_kv", cfg.n_kv_heads),
                   ("context_length", cfg.context_length),
                   ("attention.layer_norm_rms_epsilon", float(cfg.rms_norm_eps)),
                   ("rope.freq_base", float(cfg.rope_theta)), ("vocab_size", cfg.vocab_size)):
        gw.add("llama." + key, v)
    tokens, types, merges = llama3_vocab(cfg.vocab_size)
    gw.add("tokenizer.ggml.model", "gpt2")
    gw.add("tokenizer.ggml.pre", "llama-bpe")
    gw.add("tokenizer.ggml.tokens", tokens)
    gw.add("tokenizer.ggml.merges", merges)
    gw.add("tokenizer.ggml.token_type", np.array(types, dtype=np.int32))
    gw.add("tokenizer.ggml.bos_token_id", 128000)
    gw.add("tokenizer.ggml.eos_token_id", 128009)

    def qt(name, qs, scales):
        if quant == "q8_0":
            gw.add_tensor_raw(name, qs.shape, GGMLType.Q8_0, quants.q8_0_blocks(qs, scales))
        else:
            gw.add_tensor_raw(name, qs.shape, GGMLType.Q4_0,
                              quants.q4_0_blocks(qs >> 4, scales * 16.0))

    qt("token_embd.weight", w["wcls"].qs, w["wcls"].scales)
    gw.add_tensor("output_norm.weight", np.asarray(w["final_norm"], np.float32))
    names = {"wq": "attn_q", "wk": "attn_k", "wv": "attn_v", "wo": "attn_output",
             "w1": "ffn_gate", "w2": "ffn_down", "w3": "ffn_up"}
    for li in range(cfg.n_layers):
        b = f"blk.{li}."
        gw.add_tensor(b + "attn_norm.weight", np.asarray(lw["attn_norm"][li], np.float32))
        gw.add_tensor(b + "ffn_norm.weight", np.asarray(lw["ffn_norm"][li], np.float32))
        for k, n in names.items():
            qt(b + n + ".weight", lw[k].qs[li], lw[k].scales[li])
    gw.write(str(path))


def make_gguf(workdir: Path, quant: str, n_layers=None, overrides=None,
              context_length=None) -> Path:
    from llamatpu_torch.models.synthetic import build_synthetic_model

    t0 = time.perf_counter()
    model = build_synthetic_model("llama32-1b", quant="q8_0", seed=0, n_layers=n_layers,
                                  overrides=overrides, context_length=context_length)
    path = workdir / f"llama32-1b-{quant}-L{model.cfg.n_layers}.gguf"
    write_llama_gguf(model, path, quant)
    log(f"gguf: wrote {path.name} ({path.stat().st_size / 1e9:.3f} GB) in "
        f"{time.perf_counter() - t0:.1f} s")
    return path


def run_gguf_path(dev, workdir: Path, overrides=None) -> dict:
    """Slice 2's path: the full-width, full-depth Q8_0 GGUF through the port's
    CLI `run`, then Engine(rowq=False) pp512 + tg128 (K5 + K6), then a
    sampled generation run twice with one seed."""
    import contextlib
    import io

    import numpy as np
    import torch

    from llamatpu_torch import cli
    from llamatpu_torch.format import Message, Role
    from llamatpu_torch.models.loader import load_model
    from llamatpu_torch.runtime.engine import Engine

    # context 8192: the tools phase benches at depth 4096 (+ 512) on this file
    path = make_gguf(workdir, "q8_0", overrides=overrides, context_length=8192)
    res = {"gguf_file": path.name}
    # 1. the port's command line, in-process, greedy
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["run", "-m", str(path), "-p", "Why is the sky blue?", "-n", "256",
                       "--temperature", "0", "--metrics-format", "json", "--device", str(dev)])
    text = buf.getvalue()
    assert rc == 0 and text.strip(), f"cli run: rc {rc}, output {text[:200]!r}"
    res["cli"] = dict(rc=rc, seconds=time.perf_counter() - t0, chars=len(text))
    log(f"gguf: cli run rc {rc} in {res['cli']['seconds']:.1f} s, {len(text)} chars streamed: "
        f"{text[:80]!r}")
    # 2. the engine on the loaded checkpoint: block quants, K5 + K6
    t0 = time.perf_counter()
    model = load_model(str(path), max_tokens=1024)
    engine = Engine(model, cache_len=1024, prefill_chunk=512, decode_window=128, device=dev)
    log(f"gguf: loaded {model.quant_label} and served in {time.perf_counter() - t0:.1f} s "
        f"(upload {engine.metrics.weight_upload_s:.1f} s)")
    L = model.cfg.n_layers
    prompt = np.random.default_rng(42).integers(0, 128000, 512).tolist()
    res.update(drive_engine(engine, prompt, 128, lambda n: {
        "block_matmul": (4 * L + 1) * (1 + n), "decode_attention_fused_write": L * n}, "gguf"))
    require_kernels(res, "gguf", {"prefill_trace": ("bq_wgmma_kernel",),
                                  "decode16_trace": ("rtc::K5>",)})
    res["graph"] = graph_decode(engine, "gguf")
    del engine
    # 3. sampled at the family's defaults, twice with one seed
    ids = model.chat_format.build_prompt([Message(Role.USER, "Why is the sky blue?")])
    e2 = Engine(model, cache_len=1024, prefill_chunk=512, temperature=0.3, top_p=0.95,
                seed=42, device=dev)
    a = e2.generate(ids, 48).tokens
    e2.reset(seed=42)
    b = e2.generate(ids, 48).tokens
    assert a == b, f"sampled generations differ with one seed: {a} vs {b}"
    res["sampled"] = dict(tokens=len(a), identical=True, distinct_ids=len(set(a)))
    log(f"gguf: sampled (T 0.3, top-p 0.95, seed 42) twice: {len(a)} tokens, identical, "
        f"{len(set(a))} distinct ids")
    del e2, model
    torch.cuda.empty_cache()
    return res  # the GGUF stays on disk for the serving phases


def run_pack4_path(dev, workdir: Path, overrides=None) -> dict:
    """The Q4_0 GGUF at full width and 4 layers, loaded with pack4: prefill
    128 + 32 decode steps through K7, K5 at 0."""
    import numpy as np
    import torch

    from llamatpu_torch.models.loader import load_model
    from llamatpu_torch.runtime.engine import Engine

    path = make_gguf(workdir, "q4_0", n_layers=4, overrides=overrides)
    model = load_model(str(path), max_tokens=1024, pack4=True)
    assert model.weights["wcls"].layout == "packed4"
    engine = Engine(model, cache_len=1024, prefill_chunk=128, decode_window=32, device=dev)
    L = model.cfg.n_layers
    prompt = np.random.default_rng(7).integers(0, 128000, 128).tolist()
    res = drive_engine(engine, prompt, 32, lambda n: {
        "packed4_matmul": (4 * L + 1) * (1 + n), "decode_attention_fused_write": L * n},
        "pack4", repeats=1)
    require_kernels(res, "pack4", {"prefill_trace": ("bq_wgmma_kernel",),
                                   "decode16_trace": ("rtc::K7>",)})
    del engine, model
    torch.cuda.empty_cache()
    res["convert"] = convert_and_validate(dev, path, workdir)
    path.unlink()
    return res


def convert_and_validate(dev, path: Path, workdir: Path) -> dict:
    """`cli convert` of a GGUF to Q8_0, then `cli validate` on the converted
    file on the card (no golden fixture: tokenizer, chat format, a greedy
    sample and a finite ppl)."""
    import contextlib
    import io

    from llamatpu_torch import cli

    dst = workdir / (path.stem + "-converted-q8_0.gguf")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["convert", "-m", str(path), "-o", str(dst)])
    stats = json.loads(buf.getvalue())
    assert rc == 0 and stats["requantized"] > 0, f"cli convert: rc {rc}, {stats}"
    res = dict(convert_s=time.perf_counter() - t0, **stats)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["validate", "-m", str(dst), "--device", str(dev),
                       "--golden", str(workdir / "no-golden.json")])
    text = buf.getvalue()
    assert rc == 0 and "validation: OK" in text, f"cli validate: rc {rc}\n{text}"
    res["validate_s"] = time.perf_counter() - t0
    log(f"convert: {path.name} -> {dst.name} in {res['convert_s']:.1f} s ({stats}); validate "
        f"on the card rc 0 in {res['validate_s']:.1f} s: "
        f"{[ln for ln in text.splitlines() if ln.startswith('[')]}")
    dst.unlink()
    return res


# ------------------------------------------------------------- serving path
def http(url: str, body=None, timeout: float = 600.0):
    """(status, body bytes) of a GET (body None) or a JSON POST."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def sse_events(raw: bytes) -> list:
    """The JSON payloads of an SSE body up to `data: [DONE]` (asserted)."""
    frames = [f for f in raw.decode().split("\n\n") if f]
    assert frames and frames[-1] == "data: [DONE]", f"SSE does not end in [DONE]: {frames[-1:]}"
    assert all(f.startswith("data: ") for f in frames), "SSE frame without `data: `"
    return [json.loads(f[6:]) for f in frames[:-1]]


def serve_requests(url: str, max_tokens: int) -> dict:
    """Eight concurrent greedy chat completions (distinct prompts), then two
    streaming chats and one text completion together, then /health and
    /v1/models; every response checked. Returns the counts."""
    import threading

    topics = ["the sky", "tides", "volcanoes", "bread", "prime numbers", "glaciers", "comets",
              "bees"]
    chats = [{"messages": [{"role": "system", "content": "Answer briefly."},
                           {"role": "user", "content": f"Explain {t} to a child, step by step."}],
              "max_tokens": max_tokens, "temperature": 0} for t in topics]
    second = [("/v1/chat/completions", {"messages": [{"role": "user", "content": f"Tell me about "
                                                      f"{t}."}], "max_tokens": max_tokens // 2,
                                        "temperature": 0, "stream": True})
              for t in ("rivers", "owls")]
    second.append(("/v1/completions", {"prompt": "The history of the printing press",
                                       "max_tokens": max_tokens // 2}))
    results = {}

    def go(key, route, body):
        results[key] = http(url + route, body)

    def together(jobs):
        threads = [threading.Thread(target=go, args=job) for job in jobs]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)

    together([(i, "/v1/chat/completions", b) for i, b in enumerate(chats)])
    together([(f"s{i}", route, b) for i, (route, b) in enumerate(second)])
    completion_tokens = 0
    finish = {}
    for i, body in enumerate(chats):
        status, raw = results[i]
        assert status == 200, f"chat {i}: HTTP {status} {raw[:200]!r}"
        r = json.loads(raw)
        u, c = r["usage"], r["choices"][0]
        assert r["object"] == "chat.completion" and c["message"]["role"] == "assistant"
        assert u["prompt_tokens"] > 0 and 0 < u["completion_tokens"] <= max_tokens
        assert u["total_tokens"] == u["prompt_tokens"] + u["completion_tokens"]
        assert c["finish_reason"] in ("stop", "length")
        assert c["finish_reason"] == "stop" or u["completion_tokens"] == max_tokens
        completion_tokens += u["completion_tokens"]
        finish[c["finish_reason"]] = finish.get(c["finish_reason"], 0) + 1
    for i in range(2):
        status, raw = results[f"s{i}"]
        assert status == 200, f"stream {i}: HTTP {status}"
        events = sse_events(raw)
        assert events[0]["choices"][0]["delta"] == {"role": "assistant"}
        assert events[-1]["choices"][0]["finish_reason"] in ("stop", "length")
        assert all(e["object"] == "chat.completion.chunk" for e in events)
    status, raw = results["s2"]
    r = json.loads(raw)
    assert status == 200 and r["object"] == "text_completion"
    assert r["choices"][0]["finish_reason"] in ("stop", "length")
    assert http(url + "/health") == (200, b'{"status": "ok"}')
    status, raw = http(url + "/v1/models")
    assert status == 200 and json.loads(raw)["data"][0]["object"] == "model"
    assert http(url + "/v1/chat/completions", {"messages": []})[0] == 400
    return dict(chat_requests=len(chats), stream_requests=2, completion_requests=1,
                chat_completion_tokens=completion_tokens, chat_finish=finish)


def decode_window_trace(engine, prompt_len: int = 128, window: int = 16,
                        agg_tokens: int = 65) -> dict:
    """Traced decode window of a batched engine with every lane active after
    a `prompt_len`-token prefill, and the aggregate decode tok/s: of a
    generate_batch run of `agg_tokens` per lane (host clock), or with
    agg_tokens=0 of the traced window itself."""
    import numpy as np

    rng = np.random.default_rng(5)
    b = engine.batch_size
    prompts = [rng.integers(0, min(128000, engine.cfg.vocab_size), prompt_len).tolist()
               for _ in range(b)]
    agg = None
    if agg_tokens:
        engine.metrics.decode_s = engine.metrics.decode_tokens = 0
        engine.generate_batch(prompts, agg_tokens)
        agg = engine.metrics.decode_tokens / engine.metrics.decode_s
    engine.reset()
    toks = np.array([engine.prefill_lane(i, p) for i, p in enumerate(prompts)], np.int32)
    pos = np.full(b, prompt_len, np.int32)
    fns = counters()
    for f in fns.values():
        f.launches = 0
    tr = device_breakdown(lambda: engine.decode_window_run(toks, pos, np.ones(b, bool),
                                                          limit=window))
    tr["launches"] = {k: f.launches for k, f in fns.items()}
    tr["agg_decode_tok_s"] = agg if agg is not None else b * window / (tr["wall_ms"] / 1e3)
    engine.reset()
    return tr


def graph_pool_bytes(pool) -> int | None:
    """Bytes of the device segments of a CUDA graph memory pool (the
    allocator's snapshot), or None where the snapshot names no pools."""
    import torch

    segs = torch.cuda.memory_snapshot()
    if not segs or "segment_pool_id" not in segs[0]:
        return None
    return sum(s["total_size"] for s in segs if tuple(s["segment_pool_id"]) == tuple(pool))


def graph_table(paths: dict) -> dict:
    """Eager against graph windows of every path that ran graph_decode, one
    log line: device busy ms, idle share and tok/s of each traced window."""
    rows = {}
    for label, p in paths.items():
        g = p.get("graph") if isinstance(p, dict) else None
        if g:
            rows[label] = {f"{side}_{k}": g[f"{side}_trace"][k] for side in ("eager", "graph")
                           for k in ("busy_ms", "idle_share", "tok_s")}
            rows[label].update(lanes=g["lanes"], capture_s=g["greedy"]["capture_s"],
                               pool_bytes=g["pool_bytes"])
    log("graph_decode: " + json.dumps(rows))
    return rows


def graph_decode(engine, label: str, prompt_len: int = 128, window: int = 16,
                 start=None) -> dict:
    """Decode windows from a captured graph against the same windows run
    eagerly on the card (the engine's private `_graphs._eager_windows`), from
    one prefilled cache: every lane prefilled with `prompt_len` seeded tokens
    (or, for an Engine, `start` = (token, pos) on the cache as it is), then
    `window` steps from the same tokens and positions each time (a window
    rewrites the rows the one before it wrote, with the same values).
    - greedy: the graph's tokens equal the eager window's;
    - sampled (temperature 0.8, top-p 0.95): from one generator state, the
      graph window equals the eager window and a second graph window;
    - launches: each graph window counts `window` times the launches its
      capture recorded, and so does the eager window, launch by launch;
    - traced greedy windows, eager and graph: device busy ms, idle share,
      tok/s (B * window over the traced wall time); the capture's seconds
      and the graph pool's bytes."""
    import numpy as np
    import torch

    from llamatpu_torch.runtime.decode_graph import switches

    batched = hasattr(engine, "prefill_lane")
    b = engine.batch_size if batched else 1
    rng = np.random.default_rng(11)
    vocab = min(128000, engine.cfg.vocab_size)
    prompts = [rng.integers(0, vocab, prompt_len).tolist() for _ in range(b)]
    if batched:
        engine.reset()
        toks = np.array([engine.prefill_lane(i, p) for i, p in enumerate(prompts)], np.int32)
        pos = np.full(b, prompt_len, np.int32)
        assert engine.decode_window >= window, f"{label}: decode window {engine.decode_window}"

        def run(temp):
            t = None if temp == 0 else np.full(b, temp, np.float32)
            p = None if temp == 0 else np.full(b, 0.95, np.float32)
            return np.asarray(engine.decode_window_run(toks, pos, np.ones(b, bool), temps=t,
                                                       topps=p, limit=window))
    else:
        if start is None:
            engine.reset()
            start = (int(engine.prefill(prompts[0])[0][0]), prompt_len)
        tok0, pos0 = start

        def run(temp):
            out = engine.decode_window_run(tok0, pos0, window, temperature=temp, top_p=0.95)
            assert len(out) == window, f"{label}: {len(out)} of {window} tokens"
            return np.asarray(out)
    fns = counters()

    def counted(temp):
        for f in fns.values():
            f.launches = 0
        out = run(temp)
        return out, {k: f.launches for k, f in fns.items() if f.launches}

    res = {"lanes": b, "window": window}
    gen = engine.generator
    for mode, temp in (("greedy", 0.0), ("sampled", 0.8)):
        state = gen.get_state()
        graph, graph_n = counted(temp)  # captures the mode's step where it has none
        gen.set_state(state)
        again, _ = counted(temp)
        gen.set_state(state)
        with engine._graphs._eager_windows():
            eager, eager_n = counted(temp)
        cap = engine._graphs.graphs[(temp != 0.0, engine.impl, switches())]
        want = {k: cap.counts[f] * window for k, f in fns.items() if f in cap.counts}
        assert np.array_equal(graph, eager), f"{label} {mode}: graph {graph} != eager {eager}"
        assert np.array_equal(graph, again), f"{label} {mode}: graph windows differ"
        assert graph_n == want == eager_n, \
            f"{label} {mode}: launches graph {graph_n}, eager {eager_n}, captured x {window} {want}"
        assert want, f"{label} {mode}: the captured step counted no kernel launch"
        res[mode] = dict(tokens=graph.tolist(), launches=graph_n, capture_s=cap.seconds)
    res["pool_bytes"] = graph_pool_bytes(engine._graphs.pool)
    with engine._graphs._eager_windows():
        eager_tr = device_breakdown(lambda: run(0.0))
    graph_tr = device_breakdown(lambda: run(0.0))
    for key, tr in (("eager_trace", eager_tr), ("graph_trace", graph_tr)):
        tr["tok_s"] = b * window / (tr["wall_ms"] / 1e3)
        res[key] = tr
    pool = res["pool_bytes"]
    log(f"{label}: graph decode, {b} lane(s) x {window} steps: graph == eager (greedy and "
        f"sampled), launches {res['greedy']['launches']} = {window} x captured; capture "
        f"{res['greedy']['capture_s']:.3f} s (greedy) {res['sampled']['capture_s']:.3f} s "
        f"(sampled), pool {'not measured' if pool is None else f'{pool / 1e6:.1f} MB'}")
    log(f"{label}: traced {window}-step window: eager busy {eager_tr['busy_ms']:.3f} ms idle "
        f"{eager_tr['idle_share']:.3f} {eager_tr['tok_s']:.1f} tok/s | graph busy "
        f"{graph_tr['busy_ms']:.3f} ms idle {graph_tr['idle_share']:.3f} "
        f"{graph_tr['tok_s']:.1f} tok/s")
    engine.reset()
    return res


def run_serving_path(dev, path: Path, rowq: bool, latency: bool, label: str | None = None,
                     want_fn=None, extra=()) -> dict:
    """`llamatpu_torch.cli serve -m <gguf> --batch-size 8 --paged -n 2048
    --prefill-chunk 128 [--rowq] [extra flags]` in-process: the service that
    command line builds (the full-width, full-depth Q8_0 GGUF, PagedBatchEngine
    with 8 lanes, block 16, max_len 2048, window 16, behind
    BatchedInferenceService) and make_server on 127.0.0.1. The HTTP run's
    launch counts are held to the engine's own counts of decode steps and
    prefill chunks; then a traced decode window, and (latency=True) the
    serving-latency benchmark on the same engine. want_fn(steps, chunks):
    the path's launch counts (default: the Llama 3 GGUF's)."""
    import threading

    import torch

    from llamatpu_torch import cli
    from llamatpu_torch.bench.serving_latency import run_latency_bench
    from llamatpu_torch.models.loader import load_model
    from llamatpu_torch.server.openai_server import build_service, make_server

    label = label or ("serve_rowq" if rowq else "serve")
    t0 = time.perf_counter()
    args = cli.build_parser().parse_args(
        ["serve", "-m", str(path), "--batch-size", "8", "--paged", "-n", "2048",
         "--prefill-chunk", "128", "--device", str(dev), *(["--rowq"] if rowq else []), *extra])
    model = load_model(str(path), max_tokens=args.max_tokens)
    svc = build_service(args, model)
    engine = svc.engine
    srv = make_server(svc, "127.0.0.1", 0, model_id=model.metadata.get("general.name", label))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    pool_mb = sum(t.numel() * t.element_size() for t in (engine.cache.kv_pool, engine.cache.scale)
                  if t is not None) / 1e6
    log(f"{label}: {model.quant_label}{' -> q8_row' if rowq else ''} served on {url} in "
        f"{time.perf_counter() - t0:.1f} s (pool {engine.n_blocks} blocks of "
        f"{engine.block_size}, {str(engine.cache_dtype)[6:]}, {pool_mb:.0f} MB)")
    L = model.cfg.n_layers
    try:
        # warm-up: the kernels' first launches and the allocator's first blocks
        assert http(url + "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "hi"}], "max_tokens": 4})[0] == 200
        torch.cuda.synchronize()
        fns = counters()
        for f in fns.values():
            f.launches = 0
        steps0, chunks0 = engine.decode_steps, engine.prefill_chunks
        t0 = time.perf_counter()
        res = serve_requests(url, 64)
        res["wall_s"] = time.perf_counter() - t0
        launches = {k: f.launches for k, f in fns.items()}
        steps, chunks = engine.decode_steps - steps0, engine.prefill_chunks - chunks0
        assert svc.batcher.errors == [], f"{label}: scheduler errors {svc.batcher.errors}"
    finally:
        srv.shutdown()
        srv.server_close()
        svc.batcher.shutdown()
    want = {k: 0 for k in fns}
    if want_fn is not None:
        want.update(want_fn(steps, chunks))
    elif rowq:  # K2 + K8 + K9 per layer and step; chunks of 128 rows take K4
        want.update(rowq_gemv=steps + chunks, qkv_norm_fused_rowq=L * steps,
                    decode_attention_paged=L * steps, layer_tail_fused_rowq=L * steps,
                    rowq_gemm=4 * L * chunks)
    else:  # K5 for the 4 projections of every layer and the head; K8 per layer
        want.update(block_matmul=(4 * L + 1) * (steps + chunks),
                    decode_attention_paged=L * steps)
    assert launches == want, f"{label}: launch counts {launches} != {want} " \
                             f"({steps} steps, {chunks} chunks)"
    res.update(launches=launches, decode_steps=steps, prefill_chunks=chunks,
               completion_tok_s=res["chat_completion_tokens"] / res["wall_s"])
    log(f"{label}: HTTP run {res['wall_s']:.2f} s, {steps} decode steps, {chunks} prefill "
        f"chunks, launches {launches}, chat finish {res['chat_finish']}, no scheduler error")
    res["decode16_trace"] = decode_window_trace(engine)
    tr = res["decode16_trace"]
    if want_fn is None and not rowq:  # K5 at the 8 lanes' rows
        require_kernels(res, label, {"decode16_trace": ("rtc::K5>",)})
    log(f"{label}: traced 16-step window at B=8: device busy {tr['busy_ms']:.3f} of "
        f"{tr['wall_ms']:.3f} ms (idle share {tr['idle_share']:.3f}); generate_batch "
        f"aggregate decode {tr['agg_decode_tok_s']:.1f} tok/s; top "
        f"{[(t['name'][:40], round(t['ms'], 3)) for t in tr['kernels'][:6]]}")
    if label == "serve":  # the graph against the eager window at the 8 lanes
        res["graph"] = graph_decode(engine, label)
    if latency:
        t0 = time.perf_counter()
        lat = run_latency_bench(engine, n_requests=16, prompt_len=128, max_new=64,
                                adversary_prompt_len=1024)
        assert lat["scheduler_errors"] == [], f"latency bench: {lat['scheduler_errors']}"
        lat["seconds"] = time.perf_counter() - t0
        res["latency"] = lat
        log("latency: " + json.dumps({k: v for k, v in lat.items() if not isinstance(v, list)}))
    del engine, svc, model
    torch.cuda.empty_cache()
    return res


def run_int8_serving_paths(dev, path: Path) -> dict:
    """The int8 KV cache on the full-width, full-depth Q8_0 GGUF: `cli run
    --kv-dtype int8` (K5 per projection, K6-int8 per layer and step, held to
    the Engine's forwards), then `cli serve --kv-dtype int8 --batch-size 8
    --paged` over HTTP (K5, and K8-int8 per layer and step)."""
    import torch

    from llamatpu_torch.gguf.reader import GGUFReader

    with GGUFReader(path) as r:
        L = int(r.metadata["llama.block_count"])
    res = cli_run(dev, path, ["--kv-dtype", "int8"])
    want = {k: 0 for k in res["launches"]}
    want.update(block_matmul=(4 * L + 1) * (res["chunks"] + res["steps"]),
                decode_attention_fused_write_q=L * res["steps"])
    assert res["launches"] == want, f"cli run --kv-dtype int8: {res['launches']} != {want}"
    log(f"int8: cli run --kv-dtype int8 rc 0 in {res['seconds']:.1f} s, {res['chunks']} chunks + "
        f"{res['steps']} steps, {res['chars']} chars streamed: {res['text']!r}")
    out = {"cli_int8": res}
    out["serve_int8"] = run_serving_path(
        dev, path, rowq=False, latency=False, label="serve_int8", extra=("--kv-dtype", "int8"),
        want_fn=lambda steps, chunks: dict(block_matmul=(4 * L + 1) * (steps + chunks),
                                           decode_attention_paged_q=L * steps))
    torch.cuda.empty_cache()
    return out


def run_dense_batch_path(dev, overrides=None) -> dict:
    """BatchEngine over the dense batched cache, q8_row, full width and 4
    layers, 8 lanes: generate_batch of 8 prompts of different lengths, 32
    tokens each; K6 at each lane's position and K2 + K9 at 8 rows per layer
    and step (`drive_batch`)."""
    import numpy as np
    import torch

    from llamatpu_torch.models.synthetic import build_synthetic_model
    from llamatpu_torch.runtime.batch_engine import BatchEngine

    model = build_synthetic_model("llama32-1b", quant="q8_0", context_length=1024, n_layers=4,
                                  overrides=overrides)
    engine = BatchEngine(model, batch_size=8, cache_len=1024, prefill_chunk=128,
                         decode_window=16, rowq=True, device=dev)
    L = model.cfg.n_layers
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, model.cfg.vocab_size, n).tolist()
               for n in (20, 57, 128, 129, 200, 31, 300, 90)]
    res = drive_batch(engine, prompts, 32, lambda steps, chunks: dict(
        rowq_gemv=steps + chunks, qkv_norm_fused_rowq=L * steps,
        decode_attention_fused_write=L * steps, layer_tail_fused_rowq=L * steps,
        rowq_gemm=4 * L * chunks), "dense batch")
    res["graph"] = graph_decode(engine, "dense_batch")
    del engine, model
    torch.cuda.empty_cache()
    return res


def paged_prefill_logits(engine, prompt: list[int]):
    """Last-token logits of a one-chunk prefill of lane 0 of a paged engine."""
    import torch

    from llamatpu_torch.models.transformer import forward_tokens, pad_chunk_len

    n = len(prompt)
    assert engine.alloc.ensure(0, n, engine.block_size)
    arr = torch.tensor([prompt + [0] * (pad_chunk_len(n, engine.prefill_chunk) - n)],
                       device=engine.device)
    logits, _ = forward_tokens(engine.cfg, engine.weights, arr, engine.cache, 0,
                               logit_index=n - 1, tables=engine._tables(slice(0, 1)))
    return logits.float().cpu()


def compare_paged(dev, model) -> dict:
    """PagedBatchEngine on the card against the CPU, f32: a 64-token
    prefill's logits, and generate_batch on 3 prompts, 16 tokens."""
    import numpy as np
    import torch

    from llamatpu_torch.runtime.paged_engine import PagedBatchEngine

    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 128000, n).tolist() for n in (64, 37, 100)]
    res = {}
    for where in (dev, "cpu"):
        e = PagedBatchEngine(model, batch_size=3, block_size=16, max_len=1024, prefill_chunk=128,
                             decode_window=16, cache_dtype=torch.float32, device=where)
        lg = paged_prefill_logits(e, prompts[0])
        e.reset()
        res[str(where)] = (lg, e.generate_batch(prompts, 16))
        del e
    (lg, tg), (lc, tc) = res[str(dev)], res["cpu"]
    d = (lg - lc).abs().max().item()
    agree = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b), len(y))
             for x, y in zip(tg, tc)]
    out = dict(logits_max_abs=d, logits_rel=d / lc.abs().max().item(), greedy_agree=agree,
               greedy_n=[len(y) for y in tc])
    log(f"cpu paged f32: 64-token prefill logits card vs cpu max abs {d:.4g} "
        f"(rel {out['logits_rel']:.3g}); generate_batch greedy agreement per lane {agree} of 16")
    return out


def compare_engines(dev, model, n: int, cdt, label: str, cache_len: int = 1024, **kw) -> dict:
    """Prefill logits and 16 greedy tokens of one model on the card and on
    the CPU (plain versions). With an int8 cache, also the prefill's cache
    rows of the two: how many int8 values differ, by how many steps, and the
    largest difference of their scales."""
    import numpy as np
    import torch

    from llamatpu_torch.runtime.engine import Engine

    prompt = np.random.default_rng(7).integers(0, min(model.cfg.vocab_size, 128000), n).tolist()
    res = {}
    for where in (dev, "cpu"):
        e = Engine(model, cache_len=cache_len, prefill_chunk=n, decode_window=16, cache_dtype=cdt,
                   device=where, **kw)
        _, logits = e.prefill(prompt, 0)
        rows = (e.cache.kv[:, :, :, :n].cpu(),
                None if e.cache.scale is None else e.cache.scale[..., :n].cpu())
        e.reset()
        res[str(where)] = (logits.float().cpu(), e.generate(prompt, 16).tokens, rows)
        del e
    (lg, tg, (kg, sg)), (lc, tc, (kc, sc)) = res[str(dev)], res["cpu"]
    d = (lg - lc).abs().max().item()
    agree = next((i for i, (a, b) in enumerate(zip(tg, tc)) if a != b), len(tc))
    out = dict(prompt=n, cache_len=cache_len, cache_dtype=str(cdt)[6:], logits_max_abs=d,
               logits_rel=d / lc.abs().max().item(), greedy_agree=agree, greedy_n=len(tc))
    flips = ""
    if cdt == torch.int8:
        step = (kg.to(torch.int32) - kc.to(torch.int32)).abs()
        rel = [((sg[li] - sc[li]).abs().max() / sc[li].abs().max()).item()
               for li in range(sc.shape[0])]
        out.update(int8_differ=int((step > 0).sum()), int8_values=step.numel(),
                   int8_max_step=int(step.max()), scale_rel_by_layer=rel)
        flips = (f"; int8 rows: {out['int8_differ']} of {out['int8_values']} values differ, by "
                 f"<= {out['int8_max_step']} step, scales per layer within "
                 f"{[float(f'{r:.3g}') for r in rel]}")
    log(f"cpu {label}: {n}-token prefill logits card vs cpu max abs {d:.4g} "
        f"(rel {out['logits_rel']:.3g}); greedy tokens agree for the first {agree} "
        f"of {len(tc)}{flips}")
    return out


def run_cpu_compare(dev, workdir: Path, overrides=None) -> dict:
    """The port on the card against the port on the CPU (plain versions), on
    full-width 2-layer models.

    Slice 1 (q8_row): f32, a 64-token prompt in one 64-row chunk (K1 for
    every projection) and 16 greedy tokens (K1-K3), held to a tolerance;
    bf16, a 128-token prompt (the K4 path), reported only: the per-token int8
    activation rounding of the w8a8 path is discontinuous, so rounding-level
    differences upstream flip int8 values and move these logits by percents
    even on one device. Slice 2 (the Q8_0 GGUF, block quants): f32, a
    64-token prompt (K5's tiled path) and 16 greedy tokens (K5 + K6), held to
    the same tolerance. Slice 5, on the f32 q8_row model: int8 KV at cache
    1024 (K6-int8) and 16384 (K14 int8) and f32 KV at 8192 (K14 f32), all 16
    greedy ids equal; f32 held to the same tolerance, int8 to its rounding
    (below)."""
    import torch

    from llamatpu_torch.models.loader import load_model
    from llamatpu_torch.models.synthetic import build_synthetic_model

    out = {}
    for dt, cdt, n in (("f32", torch.float32, 64), ("bf16", torch.bfloat16, 128)):
        model = build_synthetic_model("llama32-1b", quant="q8_0", context_length=16384,
                                      n_layers=2, dtype=dt, overrides=overrides)
        out[dt] = compare_engines(dev, model, n, cdt, f"q8_row {dt}", rowq=True)
        if dt != "f32":
            continue
        # slice 5 on the f32 model: int8 KV short (K6-int8) and long (K14
        # int8), f32 KV long (K14 f32); the greedy ids must agree in full
        for key, kv_dt, clen, kernel in (("int8_1024", torch.int8, 1024, "K6-int8"),
                                         ("int8_16384", torch.int8, 16384, "K14 int8"),
                                         ("f32_8192", torch.float32, 8192, "K14 f32")):
            out[key] = compare_engines(dev, model, 64, kv_dt, f"q8_row f32, {key} KV ({kernel})",
                                       cache_len=clen, rowq=True)
    path = make_gguf(workdir, "q8_0", n_layers=2, overrides=overrides)
    model = load_model(str(path), max_tokens=1024, param_dtype=torch.float32)
    out["gguf_f32"] = compare_engines(dev, model, 64, torch.float32, "gguf q8_0 f32")
    out["paged_f32"] = compare_paged(dev, model)
    path.unlink()
    # f32 sums in another order than the CPU's, over two layers and the head
    for k in ("f32", "gguf_f32", "paged_f32", "f32_8192"):
        assert out[k]["logits_rel"] <= 1e-4, f"card and CPU disagree ({k}): {out[k]}"
    # int8 KV: layer 0's K and V differ by f32 rounding before quantize_kv
    # (bit-equal on both), so its scales agree to ~1e-7 and a value at a
    # rounding tie lands one step apart; a step is max|x| / 127 of a row,
    # and the next layer's inputs, scales and values move with it. Held: layer
    # 0's scales within 1e-5, no value more than one step apart, at most 1 %
    # of them, the logits within 1e-2 of the largest (one step moves them by
    # ~1e-3)
    for k in ("int8_1024", "int8_16384"):
        r = out[k]
        assert r["int8_max_step"] <= 1 and r["int8_differ"] <= 1e-2 * r["int8_values"] \
            and r["scale_rel_by_layer"][0] <= 1e-5 and r["logits_rel"] <= 1e-2, \
            f"card and CPU disagree ({k}): {r}"
    for k in ("int8_1024", "int8_16384", "f32_8192"):
        assert out[k]["greedy_agree"] == out[k]["greedy_n"], f"greedy ids differ ({k}): {out[k]}"
    return out


# ------------------------------------------------------------------ MoE slice
# Qwen1.5-MoE-A2.7B main-path shapes: layers, dim, experts of the folded
# stacks (60 routed + the shared expert as 4 chunks), expert hidden, experts
# per token (4 routed + 4 shared chunks), kv heads, groups, head dim,
# physical cache length (cache_len 1024 + one 128-row granule), vocab,
# prefill rows, and the shared expert's hidden size
QWEN15 = dict(L=24, D=2048, E=64, MH=1408, K=8, KV=16, G=1, HD=128, S=1152, V=151936, T=512,
              F=5632)


def moe_top(n: int, k: int, e: int, seed: int, dev):
    """[n, k] distinct expert ids per token (as top-k gives) over e experts,
    never expert 5: a group of zero rows."""
    import torch

    g = torch.Generator().manual_seed(seed)
    ids = torch.rand((n, e - 1), generator=g).argsort(dim=1)[:, :k]
    return torch.where(ids >= 5, ids + 1, ids).to(dev)


def moe_stacks(kind: str, e: int, o: int, i: int, dev, gen):
    """One projection's expert stack [E, O, I] for a kernel: (wrapper, plain,
    weight arguments, the bf16 dequantized stack, bytes of one expert)."""
    import torch

    from llamatpu_torch.ops import moe_grouped as mg
    from llamatpu_torch.ops.quant_matmul import dequant_blocks

    bf = torch.bfloat16
    if kind == "dense":
        w = (torch.randn((e, o, i), device=dev, generator=gen) * i ** -0.5).to(bf)
        return mg.grouped_dense_matmul, mg.grouped_dense_matmul_plain, (w,), w, o * i * 2
    sc = torch.rand((e, o, i // 32), device=dev, generator=gen) * 0.001 + 0.0005
    nb = o * (i // 32) * 4
    if kind == "packed4":
        q = torch.randint(-8, 8, (e, o, i), dtype=torch.int8, device=dev, generator=gen)
        lo, hi = q[..., 0::2].to(torch.int32) & 0xF, q[..., 1::2].to(torch.int32) & 0xF
        qp = (lo | (hi << 4)).to(torch.uint8).view(torch.int8).contiguous()
        return (mg.grouped_packed4_matmul, mg.grouped_packed4_matmul_plain, (qp, sc * 16),
                dequant_blocks(q, sc * 16, bf), o * i // 2 + nb)
    q = torch.randint(-127, 128, (e, o, i), dtype=torch.int8, device=dev, generator=gen)
    if kind == "rowq":
        rs = (torch.rand((e, o, 1), device=dev, generator=gen) + 0.5) / (73.6 * i ** 0.5)
        return (mg.grouped_rowq_matmul, mg.grouped_rowq_matmul_plain, (q, rs),
                (q.float() * rs).to(bf), o * i + o * 4)
    return (mg.grouped_block_matmul, mg.grouped_block_matmul_plain, (q, sc),
            dequant_blocks(q, sc, bf), o * i + nb)


def events_ms(fn, iters: int = 4) -> float:
    """Time of one fn() call between CUDA events, host gaps included (for
    functions that read the device on the host, which a CUDA graph cannot
    capture)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def grouped_yardstick(x, top, wbf):
    """One PyTorch call over the same rows: torch._grouped_mm (bf16) on the
    token rows sorted by expert with per-expert offsets, against the bf16
    dequantized stack (not timed); where this torch has none, a loop of
    bf16 torch.matmul over the used experts. Returns (fn, label)."""
    import torch

    n, k = top.shape
    flat = top.reshape(-1)
    order = torch.argsort(flat, stable=True)
    xg = x[order // k].to(torch.bfloat16).contiguous()
    counts = torch.bincount(flat, minlength=wbf.shape[0])
    offs = torch.cumsum(counts, 0).to(torch.int32)
    wt = wbf.transpose(-2, -1)
    try:
        torch._grouped_mm(xg, wt, offs=offs)
        torch.cuda.synchronize()
        return (lambda: torch._grouped_mm(xg, wt, offs=offs)), \
            "torch._grouped_mm (bf16, rows sorted by expert, per-expert offsets)"
    except (AttributeError, RuntimeError, TypeError):
        bounds = [0] + offs.tolist()
        used = [(e, bounds[e], bounds[e + 1]) for e in range(wbf.shape[0])
                if bounds[e + 1] > bounds[e]]

        def loop():
            return [xg[a:b] @ wbf[e].T for e, a, b in used]
        return loop, "loop of bf16 torch.matmul over the used experts"


def check_moe_kernels(dev, dims=QWEN15) -> list[dict]:
    """K10-K13 against their plain versions at full width: one layer's folded
    stacks (E = 64), gate+up (O = 2816, I = 2048) and down (O = 2048, I =
    1408), N in {1, 8, 512} tokens of 8 experts each at the JAX package's tile
    rule (8, 8, 128), bf16 and f32 activations; expert 5 routed to by no
    token, and the -1 tail tiles of the static row bound. Tolerance relative
    to the largest plain |value|: f32 <= 1e-5, bf16 <= 1e-3 (sums in another
    order). Timed in bf16; the table row is one decode token's MoE layer
    (both calls at N = 1), with N = 8 and 512 beside it."""
    import torch

    from llamatpu_torch.ops import moe_grouped as mg

    E, D, MH, K, T = (dims[k] for k in ("E", "D", "MH", "K", "T"))
    shapes = {"gu": (2 * MH, D), "down": (D, MH)}
    rows = []
    for kind, source in (("block", "llamatpu/ops/moe_grouped.py:110"),
                         ("packed4", "llamatpu/ops/moe_grouped.py:148"),
                         ("rowq", "llamatpu/ops/moe_grouped.py:176"),
                         ("dense", "llamatpu/ops/moe_grouped.py:202")):
        gen = torch.Generator(device=dev).manual_seed(10 + len(rows))
        worst = {"bf16": 0.0, "f32": 0.0}
        abs_max = 0.0
        per = {}
        for proj, (o, i) in shapes.items():
            kern, plain, w, wbf, ebytes = moe_stacks(kind, E, o, i, dev, gen)
            for n in (1, 8, T):
                top = moe_top(n, K, E, seed=n, dev=dev)
                tm = mg.tile_rows(n, K)
                rt, _, te = mg.sort_by_expert(top, E, tm)
                used = te[te >= 0].unique().numel()
                assert bool((te != 5).all()), "expert 5 has rows"
                for dt in (torch.bfloat16, torch.float32):
                    x = torch.randn((n, i), device=dev, generator=gen).to(dt)
                    xs = torch.cat([x, x.new_zeros((1, i))])[rt.long()]
                    got = kern(xs, *w, te, tm, row_token=rt, n_tokens=n)
                    want = plain(xs, *w, te, tm)
                    torch.cuda.synchronize()
                    abs_e, rel_e = max_err(got, want)
                    key = "f32" if dt == torch.float32 else "bf16"
                    tol = 1e-5 if key == "f32" else 1e-3
                    assert rel_e <= tol, \
                        f"{kern.__name__} {proj} N={n} {key}: max abs {abs_e} rel {rel_e}"
                    assert not bool(got[(te == -1).repeat_interleave(tm)].any())
                    worst[key] = max(worst[key], rel_e)
                    abs_max = max(abs_max, abs_e)
                x = torch.randn((n, i), device=dev, generator=gen).to(torch.bfloat16)
                xs = torch.cat([x, x.new_zeros((1, i))])[rt.long()]
                # each used expert's weights once, the token rows and the out rows
                nbytes = used * ebytes + n * K * i * 2 + xs.shape[0] * o * 4
                b_ms, b_by = bound(nbytes, 2 * n * K * o * i, BF16_OPS_S)
                lib, lib_name = grouped_yardstick(x, top, wbf)
                wrapper = time_ms(lambda: kern(xs, *w, te, tm, row_token=rt, n_tokens=n))
                own = kernel_ms(lambda: kern(xs, *w, te, tm, row_token=rt, n_tokens=n),
                                MOE_KERNELS)
                per[f"{proj} N={n}"] = dict(
                    ms=own if own is not None else wrapper,
                    ms_source="profiler" if own is not None else "cuda graph",
                    wrapper_ms=wrapper, plain_ms=events_ms(lambda: plain(xs, *w, te, tm)),
                    library_ms=time_ms(lib), library=lib_name, bound_ms=b_ms, bound_by=b_by,
                    used_experts=used, tm=tm, rows=xs.shape[0], shape=f"N={n} O={o} I={i}")
                log(f"{kern.__name__} {proj} N={n} tm={tm} ({used} experts): "
                    f"{per[f'{proj} N={n}']['ms']:.4f} ms (bound {b_ms:.4f} by {b_by}, plain "
                    f"{per[f'{proj} N={n}']['plain_ms']:.3f}, library "
                    f"{per[f'{proj} N={n}']['library_ms']:.4f})")
            del w, wbf
            torch.cuda.empty_cache()
        one = [per[f"{p} N=1"] for p in shapes]
        rows.append(dict(
            name=kern.__name__, route="cuda", source="llamatpu_torch/csrc/moe_grouped.cu",
            replaces=source, max_abs_err=abs_max, max_rel_err=max(worst.values()),
            max_rel_err_by_dtype=worst,
            tolerance="rel to max|plain|: f32 <= 1e-5, bf16 <= 1e-3 (gu and down, N in 1, 8, "
                      "512; an expert of zero rows, -1 tail tiles)",
            **{k: sum(r[k] for r in one) for k in ("ms", "wrapper_ms", "plain_ms", "library_ms",
                                                   "bound_ms")},
            ms_source=one[0]["ms_source"], library=one[0]["library"], bound_by="bytes",
            shape=f"one decode token's MoE layer: gu + down at N=1 (E={E}, {K} experts)",
            per_shape=per))
    return rows


# check_moe_edges: (O, I) of the stacks (Qwen1.5-MoE's gate/up and down,
# ragged O, and I past the GEMV form's 4096 columns) and the real rows of each
# group at each tile size (groups of more than tm rows span tiles)
MOE_EDGE_SHAPES = ((2816, 2048), (2048, 1408), (200, 1408), (136, 2048), (64, 4608))
MOE_EDGE_ROWS = {8: (1, 7, 8, 9, 3), 32: (1, 7, 8, 9, 16, 17, 32, 33),
                 128: (1, 7, 8, 9, 16, 17, 65, 127, 128)}


def moe_edge_tables(tm: int, counts, n_experts: int, dev):
    """Expert-sorted routing tables as sort_by_expert lays them out: a group
    of counts[g] real rows for each expert in order (expert 5 gets none),
    each padded to whole tiles, then two -1 tail tiles. Returns (row_token,
    tile_expert, n_tokens, real-row mask)."""
    import torch

    experts = [e for e in range(n_experts) if e != 5][:len(counts)]
    te, rt, n = [], [], 0
    for e, c in zip(experts, counts):
        nt = -(-c // tm)
        te += [e] * nt
        rt += list(range(n, n + c)) + [-1] * (nt * tm - c)
        n += c
    te += [-1, -1]
    rt += [-1] * (2 * tm)
    rt = torch.tensor([n if r < 0 else r for r in rt], dtype=torch.int32, device=dev)
    return rt, torch.tensor(te, dtype=torch.int32, device=dev), n, rt < n


def check_moe_edges(dev) -> dict:
    """K10-K13's kernel against the plain versions on the card: every front
    end (Q8_0, packed4, q8_row, dense bf16 and f32 weights) with bf16 and f32
    x, tm 8, 32 and 128, groups of 1-128 real rows (MOE_EDGE_ROWS), an
    expert of no rows and -1 tail tiles, the MOE_EDGE_SHAPES stacks (I 1408,
    2048 and 4608, O ragged); the pad rows of x hold noise. Real rows within
    1e-3 (bf16) / 1e-5 (f32) of the largest plain value; pad rows and tail
    tiles exactly zero; two runs bit-equal."""
    import torch

    from llamatpu_torch.ops import moe_grouped as mg

    E = 12
    gen = torch.Generator(device=dev).manual_seed(31)
    out, cases = {}, 0
    for kind in ("block", "packed4", "rowq", "dense", "dense_f32"):
        worst = {"bf16": 0.0, "f32": 0.0}
        for o, i in MOE_EDGE_SHAPES:
            kern, plain, w, _, _ = moe_stacks(kind.split("_")[0], E, o, i, dev, gen)
            if kind == "dense_f32":
                w = (w[0].float(),)
            for tm, counts in MOE_EDGE_ROWS.items():
                rt, te, n, real = moe_edge_tables(tm, counts, E, dev)
                for dt in (torch.bfloat16, torch.float32):
                    x = torch.randn((rt.shape[0], i), device=dev, generator=gen).to(dt)
                    got = kern(x, *w, te, tm, row_token=rt, n_tokens=n)
                    again = kern(x, *w, te, tm, row_token=rt, n_tokens=n)
                    want = plain(torch.where(real[:, None], x, 0), *w, te, tm)
                    torch.cuda.synchronize()
                    plan = mg.plan_grouped(x.shape[0], tm, o, i, dt == torch.float32)
                    key = f"{kind} O={o} I={i} tm={tm} {'f32' if dt == torch.float32 else 'bf16'}"
                    assert torch.equal(got, again), f"{key}: two runs differ"
                    assert not bool(got[~real].any()), f"{key}: a pad row or tail tile is not zero"
                    abs_e, rel_e = max_err(got[real], want[real])
                    tol = 1e-5 if dt == torch.float32 else 1e-3
                    assert rel_e <= tol, f"{key}: max abs {abs_e} rel {rel_e} ({plan})"
                    worst[key.split()[-1]] = max(worst[key.split()[-1]], rel_e)
                    cases += 1
            del w
        out[kind] = worst
        log(f"moe edges {kind}: rel err bf16 {worst['bf16']:.3g}, f32 {worst['f32']:.3g}, "
            "pad rows and tail tiles zero, two runs bit-equal")
    torch.cuda.empty_cache()
    out["cases"] = cases
    return out


def check_qwen_geometry(dev, dims=QWEN15) -> dict:
    """Earlier slices' kernels at the Qwen1.5-MoE geometry: K6 and K8 at
    hd 128, G 1 (row width 256, their stated maximum), K2 at O = 6144 with 1
    and 8 rows, K5 on the 151936-row head at T = 1 and 8; and the q8_row
    conversion on the card bit-equal to the CPU's. Returns a sub-row per
    kernel name."""
    import torch

    from llamatpu_torch.models.weights import QTensor, rowq_requant
    from llamatpu_torch.ops import layer_fused
    from llamatpu_torch.ops import quant_matmul as qm

    out = {"decode_attention_fused_write": check_attention(dev, dims, sweep=False),
           "decode_attention_paged": check_paged_attention(dev, dims)}
    gen = torch.Generator(device=dev).manual_seed(21)
    D, V = dims["D"], dims["V"]
    O = (dims["G"] * dims["KV"] + 2 * dims["KV"]) * dims["HD"]
    wqkv = rand_rowq(2, O, D, dev, gen)
    norm = torch.rand((2, D), device=dev, generator=gen) + 0.5
    k2 = {}
    for t in (1, 8):
        x = torch.randn((t, 1, D), device=dev, generator=gen).to(torch.bfloat16)
        got = layer_fused.qkv_norm_fused_rowq(wqkv, norm, x, 1, 1e-6)
        want = layer_fused.qkv_norm_plain(wqkv, norm, x, 1, 1e-6)
        torch.cuda.synchronize()
        abs_e, rel_e = max_err(got, want)
        assert rel_e <= 1e-2, f"K2 at O={O}, {t} rows: max abs {abs_e} rel {rel_e}"
        b_ms, b_by = bound(O * D + O * 4 + t * D * 2 + D * 4 + t * O * 2, 2 * t * O * D,
                           BF16_OPS_S)
        k2[t] = dict(max_abs_err=abs_e, max_rel_err=rel_e, bound_ms=b_ms, bound_by=b_by,
                     **timings(lambda: layer_fused.qkv_norm_fused_rowq(wqkv, norm, x, 1, 1e-6),
                               K2_TC,
                               lambda: layer_fused.qkv_norm_plain(wqkv, norm, x, 1, 1e-6), None,
                               graph=True))
        log(f"K2 at O={O}, {t} rows: {k2[t]['ms']:.4f} ms (bound {b_ms:.4f}), rel err {rel_e:.3g}")
    out["qkv_norm_fused_rowq"] = dict(shape=f"O={O} D={D}", by_rows=k2)
    del wqkv
    q = torch.randint(-127, 128, (V, D), dtype=torch.int8, device=dev, generator=gen)
    s = torch.rand((V, D // 32), device=dev, generator=gen) * 0.001 + 0.0005
    w_bf = qm.dequant_blocks(q, s, torch.bfloat16)
    k5 = {}
    for t in (1, 8):
        for dt, tol in ((torch.bfloat16, 1e-3), (torch.float32, 1e-5)):
            x = torch.randn((t, D), device=dev, generator=gen).to(dt)
            abs_e, rel_e = max_err(qm.block_matmul(x, q, s), qm.block_matmul_plain(x, q, s))
            assert rel_e <= tol, f"K5 head O={V} T={t} {dt}: max abs {abs_e} rel {rel_e}"
        xb = torch.randn((t, D), device=dev, generator=gen).to(torch.bfloat16)
        b_ms, b_by = bound(V * D + V * (D // 32) * 4 + t * D * 2 + t * V * 4, 2 * t * V * D,
                           BF16_OPS_S)
        k5[t] = dict(max_rel_err=rel_e, bound_ms=b_ms, bound_by=b_by,
                     **timings(lambda: qm.block_matmul(xb, q, s), K5_NAMES,
                               lambda: qm.block_matmul_plain(xb, q, s),
                               lambda: torch.matmul(xb, w_bf.T), iters=4, graph=True))
        log(f"K5 head O={V} T={t}: {k5[t]['ms']:.4f} ms (bound {b_ms:.4f})")
    out["block_matmul"] = dict(shape=f"head O={V} I={D}", by_rows=k5)
    del q, s, w_bf
    # the q8_row conversion on the card (an MoE model's expert stacks) is
    # bit-equal to the CPU's
    q = torch.randint(-127, 128, (2, 2 * dims["MH"], D), dtype=torch.int8)
    s = torch.rand((2, 2 * dims["MH"], D // 32)) * 0.001 + 0.0005
    card = rowq_requant(QTensor(q, s, "q8_0"), dev)
    host = rowq_requant(QTensor(q.numpy(), s.numpy(), "q8_0"))
    assert torch.equal(card.qs.cpu(), torch.from_numpy(host.qs)) and \
        torch.equal(card.scales.cpu(), torch.from_numpy(host.scales)), \
        "rowq_requant on the card differs from the CPU's"
    log(f"rowq_requant of a [2, {2 * dims['MH']}, {D}] Q8_0 stack: card and CPU bit-equal")
    torch.cuda.empty_cache()
    return out


def host_rss_gb() -> float:
    """Peak resident host memory of this process so far (GB)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def experts_per_layer(engine, toks, pos) -> list[int]:
    """Distinct experts each layer's grouped calls use in one 8-lane decode
    step (the tile tables read on the host, outside every timed run, in an
    eager step: a graph replay runs no host code)."""
    import numpy as np

    from llamatpu_torch.ops import moe_grouped as mg

    seen = []
    inner = mg.sort_by_expert

    def spy(top_i, n_experts, tm):
        out = inner(top_i, n_experts, tm)
        seen.append(len(set(out[2].tolist()) - {-1}))
        return out
    mg.sort_by_expert = spy
    try:
        with engine._graphs._eager_windows():
            engine.decode_window_run(toks, pos, np.ones(len(toks), bool), limit=1)
    finally:
        mg.sort_by_expert = inner
    return seen


def first_layers(model, n: int):
    """The model cut to its first n layers: the layer stacks sliced and the
    config's depth set."""
    import dataclasses

    from llamatpu_torch.models.weights import QTensor

    def cut(v):
        if isinstance(v, QTensor):
            return dataclasses.replace(v, qs=v.qs[:n], scales=v.scales[:n],
                                       offs=None if v.offs is None else v.offs[:n])
        return v[:n]
    layers = {k: cut(v) for k, v in model.weights["layers"].items()}
    return dataclasses.replace(model, cfg=dataclasses.replace(model.cfg, n_layers=n),
                               weights={**model.weights, "layers": layers})


def run_moe_paths(dev, overrides=None, n_layers=None) -> dict:
    """Full-width Qwen1.5-MoE-A2.7B (synthetic Q8_0, seed 0) at `n_layers`
    (default all 24) through Engine (cache 1024, prefill chunk 512, 128 greedy
    tokens: K10 + K5 + K6), then with rowq at its first 8 layers (K12 + K1 +
    K2 + K4 + K6), then PagedBatchEngine with 8 lanes (K10 + K5 + K8)."""
    import numpy as np
    import torch

    from llamatpu_torch.models.synthetic import build_synthetic_model
    from llamatpu_torch.runtime.engine import Engine
    from llamatpu_torch.runtime.paged_engine import PagedBatchEngine

    out = {}
    t0 = time.perf_counter()
    model = build_synthetic_model("qwen15-moe-a2.7b", quant="q8_0", seed=0, context_length=1024,
                                  n_layers=n_layers, overrides=overrides)
    build_s = time.perf_counter() - t0
    V = model.cfg.vocab_size
    prompt = np.random.default_rng(42).integers(0, V, 512).tolist()
    for label, rowq in (("moe", False), ("moe_rowq", True)):
        t0 = time.perf_counter()
        # the rowq path at 8 layers: the depth cut that keeps the whole script
        # inside its time limit (its decode is host-bound, ~10 s per 24 layers)
        m = first_layers(model, min(8, model.cfg.n_layers)) if rowq else model
        L = m.cfg.n_layers
        engine = Engine(m, cache_len=1024, prefill_chunk=512, decode_window=128, rowq=rowq,
                        device=dev)
        load_s = time.perf_counter() - t0
        kind = engine.weights["layers"]["gu_exps"].kind
        assert kind == ("q8_row" if rowq else "q8_0") and "shared_g13" not in \
            engine.weights["layers"], "the shared expert did not fold"
        log(f"{label}: {L} layers, experts {kind}, synthetic build "
            f"{build_s:.1f} s, fold + fuse{' + rowq' if rowq else ''} + upload {load_s:.1f} s, "
            f"device {torch.cuda.memory_allocated() / 1e9:.2f} GB, peak host RSS "
            f"{host_rss_gb():.1f} GB")
        if rowq:  # K2 + K1 (wo, head) per step, K4 for wqkv/wo in the 512-row chunk
            want = lambda n: {  # noqa: E731
                "grouped_rowq_matmul": 2 * L * (n + 1), "qkv_norm_fused_rowq": L * n,
                "rowq_gemv": (L + 1) * n + 1, "rowq_gemm": 2 * L,
                "decode_attention_fused_write": L * n}
        else:  # K5 for wqkv, wo and the head
            want = lambda n: {  # noqa: E731
                "grouped_block_matmul": 2 * L * (n + 1), "block_matmul": (2 * L + 1) * (n + 1),
                "decode_attention_fused_write": L * n}
        out[label] = drive_engine(engine, prompt, 128, want, label)
        if not rowq:
            require_kernels(out[label], label, {"prefill_trace": ("bq_wgmma_kernel",),
                                                "decode16_trace": ("rtc::K5>",)})
        out[label].update(build_s=build_s, load_s=load_s, host_rss_gb=host_rss_gb(), layers=L)
        del engine, m
        torch.cuda.empty_cache()
    L = model.cfg.n_layers
    # batched decode: 8 lanes over the paged pool
    t0 = time.perf_counter()
    engine = PagedBatchEngine(model, batch_size=8, block_size=16, max_len=1024,
                              prefill_chunk=128, decode_window=16, device=dev)
    load_s = time.perf_counter() - t0
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, V, n).tolist() for n in (20, 57, 128, 129, 200, 31, 300, 90)]
    engine.generate_batch(prompts[:2], 4)  # warm-up
    fns = counters()
    for f in fns.values():
        f.launches = 0
    steps0, chunks0 = engine.decode_steps, engine.prefill_chunks
    t0 = time.perf_counter()
    outs = engine.generate_batch(prompts, 32)
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in fns.items()}
    steps, chunks = engine.decode_steps - steps0, engine.prefill_chunks - chunks0
    assert [len(o) for o in outs] == [32] * 8 and all(0 <= t < V for o in outs for t in o)
    want = {k: 0 for k in fns}
    want.update(grouped_block_matmul=2 * L * (steps + chunks),
                block_matmul=(2 * L + 1) * (steps + chunks), decode_attention_paged=L * steps)
    assert launches == want, f"moe paged: launch counts {launches} != {want}"
    res = dict(wall_s=wall, decode_steps=steps, prefill_chunks=chunks, launches=launches,
               load_s=load_s, tok_s=8 * 32 / wall)
    res["decode16_trace"] = tr = decode_window_trace(engine)
    require_kernels(res, "moe paged", {"decode16_trace": ("rtc::K5>",)})
    toks = np.array([engine.prefill_lane(i, p) for i, p in enumerate(prompts)], np.int32)
    res["experts_per_layer"] = experts_per_layer(engine, toks,
                                                 np.array([len(p) for p in prompts], np.int32))
    log(f"moe paged: 8 lanes x 32 tokens in {wall:.2f} s ({res['tok_s']:.1f} tok/s), {steps} "
        f"steps, {chunks} chunks, launches {launches}; traced 16-step window: device busy "
        f"{tr['busy_ms']:.3f} of {tr['wall_ms']:.3f} ms (idle share {tr['idle_share']:.3f}), "
        f"aggregate decode {tr['agg_decode_tok_s']:.1f} tok/s; distinct experts per layer at "
        f"8 lanes {res['experts_per_layer']}")
    res["graph"] = graph_decode(engine, "moe_paged")
    out["moe_paged"] = res
    del engine, model
    torch.cuda.empty_cache()
    return out


# the ChatML specials at their ids in Qwen's published 151936-id vocab
QWEN_SPECIALS = {151643: "<|endoftext|>", 151644: "<|im_start|>", 151645: "<|im_end|>"}


def qwen_vocab(vocab_size: int) -> tuple[list[str], list[int], list[str]]:
    """(tokens, token types, merges) of a byte-level BPE vocab padded to
    `vocab_size`: the 256 byte tokens, a few merges, filler tokens up to
    151643, then the ChatML specials and reserved control tokens."""
    tokens, types, merges = llama3_vocab(151643)
    for i in range(151643, vocab_size):
        tokens.append(QWEN_SPECIALS.get(i, f"<|extra_{i - 151643}|>"))
        types.append(3)
    return tokens, types, merges


def write_qwen_moe_gguf(model, path, quant: str = "q8_0") -> None:
    """A synthetic q8_0 Qwen2-MoE model as a qwen2moe GGUF, through the
    port's writer (the llama writer's conventions: Q8_0 values as they are,
    Q4_0 the values >> 4 with scales x 16, the head tied to token_embd), with
    the router, the shared expert's gate and the qkv biases in f32."""
    import numpy as np

    from llamatpu_torch.gguf import GGMLType, GGUFWriter, quants

    cfg, w = model.cfg, model.weights
    lw = w["layers"]
    gw = GGUFWriter()
    gw.add("general.architecture", "qwen2moe")
    gw.add("general.name", "synthetic Qwen1.5-MoE-A2.7B")
    for key, v in (("embedding_length", cfg.dim), ("feed_forward_length", cfg.hidden_dim),
                   ("block_count", cfg.n_layers), ("attention.head_count", cfg.n_heads),
                   ("attention.head_count_kv", cfg.n_kv_heads),
                   ("context_length", cfg.context_length),
                   ("attention.layer_norm_rms_epsilon", float(cfg.rms_norm_eps)),
                   ("rope.freq_base", float(cfg.rope_theta)), ("vocab_size", cfg.vocab_size),
                   ("expert_count", cfg.n_experts), ("expert_used_count", cfg.n_experts_used)):
        gw.add("qwen2moe." + key, v)
    tokens, types, merges = qwen_vocab(cfg.vocab_size)
    gw.add("tokenizer.ggml.model", "gpt2")
    gw.add("tokenizer.ggml.pre", "qwen2")
    gw.add("tokenizer.ggml.tokens", tokens)
    gw.add("tokenizer.ggml.merges", merges)
    gw.add("tokenizer.ggml.token_type", np.array(types, dtype=np.int32))
    gw.add("tokenizer.ggml.bos_token_id", 151643)
    gw.add("tokenizer.ggml.eos_token_id", 151645)

    def qt(name, t, li):
        qs, scales = np.asarray(t.qs[li]), np.asarray(t.scales[li])
        if quant == "q8_0":
            gw.add_tensor_raw(name, qs.shape, GGMLType.Q8_0, quants.q8_0_blocks(qs, scales))
        else:
            gw.add_tensor_raw(name, qs.shape, GGMLType.Q4_0,
                              quants.q4_0_blocks(qs >> 4, scales * 16.0))

    def f32(name, a):
        gw.add_tensor(name, np.ascontiguousarray(np.asarray(a, np.float32)))

    qt("token_embd.weight", w["wcls"], slice(None))
    f32("output_norm.weight", w["final_norm"])
    names = {"wq": "attn_q", "wk": "attn_k", "wv": "attn_v", "wo": "attn_output",
             "gate_exps": "ffn_gate_exps", "up_exps": "ffn_up_exps",
             "down_exps": "ffn_down_exps", "shared_gate": "ffn_gate_shexp",
             "shared_up": "ffn_up_shexp", "shared_down": "ffn_down_shexp"}
    for li in range(cfg.n_layers):
        b = f"blk.{li}."
        f32(b + "attn_norm.weight", lw["attn_norm"][li])
        f32(b + "ffn_norm.weight", lw["ffn_norm"][li])
        for k, n in names.items():
            qt(b + n + ".weight", lw[k], li)
        for k, n in (("q_bias", "attn_q.bias"), ("k_bias", "attn_k.bias"),
                     ("v_bias", "attn_v.bias")):
            f32(b + n, lw[k][li])
        f32(b + "ffn_gate_inp.weight", lw["router"][li])
        f32(b + "ffn_gate_inp_shexp.weight", lw["shared_gate_inp"][li])
    gw.write(str(path))


def count_forwards():
    """Wrap the Engine's forward_tokens and decode_window_run to count its
    prefill windows and its decode steps (a window's graph replays, read
    from `Engine.decode_steps`): (restore, counts {"chunks", "steps"})."""
    from llamatpu_torch.runtime import engine as engine_mod

    inner, inner_window = engine_mod.forward_tokens, engine_mod.Engine.decode_window_run
    counts = {"chunks": 0, "steps": 0}

    def counted(cfg, weights, tokens, *a, **kw):
        if tokens.shape[1] > 1:
            counts["chunks"] += 1
        return inner(cfg, weights, tokens, *a, **kw)

    def window(self, *a, **kw):
        before = self.decode_steps
        out = inner_window(self, *a, **kw)
        counts["steps"] += self.decode_steps - before
        return out

    def restore():
        engine_mod.forward_tokens = inner
        engine_mod.Engine.decode_window_run = inner_window
    engine_mod.forward_tokens = counted
    engine_mod.Engine.decode_window_run = window
    return restore, counts


def cli_run(dev, path, extra=()) -> dict:
    """`llamatpu_torch.cli run` in-process, greedy, with every launch and the
    Engine's forwards counted over the run."""
    import contextlib
    import io

    from llamatpu_torch import cli
    from llamatpu_torch.gguf import native

    fns = counters()
    for f in fns.values():
        f.launches = 0
    restore, fw = count_forwards()
    calls = native.calls
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["run", "-m", str(path), "-p", "Why is the sky blue?", "-n", "256",
                           "--temperature", "0", "--metrics-format", "none", "--device", str(dev),
                           *extra])
    finally:
        restore()
    text = buf.getvalue()
    assert rc == 0 and text.strip(), f"cli run: rc {rc}, output {text[:200]!r}"
    return dict(rc=rc, seconds=time.perf_counter() - t0, chars=len(text), text=text[:80],
                launches={k: f.launches for k, f in fns.items()},
                native_calls=native.calls - calls, **fw)


def run_moe_gguf_paths(dev, workdir: Path, overrides=None) -> dict:
    """The synthetic model at full width and 4 layers (the depth cut keeps the
    written file ~3 GB) as a qwen2moe Q8_0 GGUF: `cli run`; `cli serve
    --batch-size 8 --paged` in-process (8 concurrent chats, 2 streamed, a
    text completion, /health, /v1/models; K10 + K5 + K8 held to the engine's
    steps and chunks); then a Q4_0 copy through `cli run --pack4` (K11 + K7
    held to the Engine's forwards) and Engine with pack4 (the traced K11
    path)."""
    import numpy as np
    import torch

    from llamatpu_torch.models.loader import load_model
    from llamatpu_torch.models.synthetic import build_synthetic_model
    from llamatpu_torch.runtime.engine import Engine

    out = {}
    model = build_synthetic_model("qwen15-moe-a2.7b", quant="q8_0", seed=0, n_layers=4,
                                  overrides=overrides)
    L = model.cfg.n_layers
    paths = {}
    for quant in ("q8_0", "q4_0"):
        t0 = time.perf_counter()
        paths[quant] = workdir / f"qwen15-moe-{quant}-L{L}.gguf"
        write_qwen_moe_gguf(model, paths[quant], quant)
        log(f"moe gguf: wrote {paths[quant].name} ({paths[quant].stat().st_size / 1e9:.3f} GB) "
            f"in {time.perf_counter() - t0:.1f} s")
    del model
    res = cli_run(dev, paths["q8_0"])
    want = {k: 0 for k in res["launches"]}
    fwd = res["chunks"] + res["steps"]
    want.update(grouped_block_matmul=2 * L * fwd, block_matmul=(2 * L + 1) * fwd,
                decode_attention_fused_write=L * res["steps"])
    assert res["launches"] == want, f"moe cli run: {res['launches']} != {want}"
    log(f"moe gguf: cli run rc 0 in {res['seconds']:.1f} s, {res['chunks']} chunks + "
        f"{res['steps']} steps, {res['chars']} chars streamed: {res['text']!r}")
    out["moe_cli"] = res
    out["moe_serve"] = run_serving_path(
        dev, paths["q8_0"], rowq=False, latency=False, label="moe_serve",
        want_fn=lambda steps, chunks: dict(
            grouped_block_matmul=2 * L * (steps + chunks),
            block_matmul=(2 * L + 1) * (steps + chunks), decode_attention_paged=L * steps))
    paths["q8_0"].unlink()
    res = cli_run(dev, paths["q4_0"], ["--pack4"])
    want = {k: 0 for k in res["launches"]}
    fwd = res["chunks"] + res["steps"]
    want.update(grouped_packed4_matmul=2 * L * fwd, packed4_matmul=(2 * L + 1) * fwd,
                decode_attention_fused_write=L * res["steps"])
    assert res["launches"] == want, f"moe cli run --pack4: {res['launches']} != {want}"
    log(f"moe pack4: cli run --pack4 rc 0, {res['chunks']} chunks + {res['steps']} steps, "
        f"launches {res['launches']}")
    out["moe_cli_pack4"] = res
    model = load_model(str(paths["q4_0"]), max_tokens=1024, pack4=True)
    assert model.weights["layers"]["gate_exps"].layout == "packed4"
    engine = Engine(model, cache_len=1024, prefill_chunk=128, decode_window=32, device=dev)
    prompt = np.random.default_rng(7).integers(0, 151643, 128).tolist()
    out["moe_pack4"] = drive_engine(engine, prompt, 32, lambda n: {
        "grouped_packed4_matmul": 2 * L * (n + 1), "packed4_matmul": (2 * L + 1) * (n + 1),
        "decode_attention_fused_write": L * n}, "moe_pack4", repeats=1)
    del engine, model
    paths["q4_0"].unlink()
    torch.cuda.empty_cache()
    return out


def dense_experts(model):
    """The same model with its routed expert stacks dequantized to f32 dense
    weights (as an F32 checkpoint loads): served unfolded, through K13."""
    import numpy as np

    lw = dict(model.weights["layers"])
    for k in ("gate_exps", "up_exps", "down_exps"):
        t = lw[k]
        lw[k] = np.asarray(t.qs, np.float32) * np.repeat(np.asarray(t.scales), 32, axis=-1)
    return type(model)(cfg=model.cfg, weights={**model.weights, "layers": lw},
                       metadata=model.metadata, family=model.family)


def run_moe_cpu_and_dense(dev, overrides=None) -> dict:
    """Full width, 2 layers, f32: the synthetic Q8_0 MoE model on the card
    (K10) against the CPU (plain versions), a 32-token prompt's prefill
    logits within 1e-4 of the largest and 16 greedy tokens reported; then
    the same model with dense f32 experts (unfolded, K13) driven on the card
    (prefill 128 + 32 steps, counted and traced) and its 32-token prefill
    logits held to the CPU's."""
    import numpy as np
    import torch

    from llamatpu_torch.models.synthetic import build_synthetic_model
    from llamatpu_torch.runtime.engine import Engine

    out = {}
    model = build_synthetic_model("qwen15-moe-a2.7b", quant="q8_0", seed=0, n_layers=2,
                                  dtype="f32", context_length=1024, overrides=overrides)
    out["cpu_q8_0_f32"] = compare_engines(dev, model, 32, torch.float32, "moe q8_0 f32")
    dense = dense_experts(model)
    del model
    L = dense.cfg.n_layers
    engine = Engine(dense, cache_len=1024, prefill_chunk=128, decode_window=32,
                    cache_dtype=torch.float32, device=dev)
    assert "shared_g13" in engine.weights["layers"], "dense experts are served unfolded"
    prompt = np.random.default_rng(9).integers(0, 151643, 128).tolist()
    # K5: wqkv, wo and the shared expert's two projections per layer, the head
    out["moe_dense"] = drive_engine(engine, prompt, 32, lambda n: {
        "grouped_dense_matmul": 2 * L * (n + 1), "block_matmul": (4 * L + 1) * (n + 1),
        "decode_attention_fused_write": L * n}, "moe_dense", repeats=1)
    del engine
    lg = {}
    for where in (dev, "cpu"):
        e = Engine(dense, cache_len=1024, prefill_chunk=32, cache_dtype=torch.float32,
                   device=where)
        lg[str(where)] = e.prefill(prompt[:32], 0)[1].float().cpu()
        del e
    d = (lg[str(dev)] - lg["cpu"]).abs().max().item()
    out["cpu_dense_f32"] = dict(logits_max_abs=d, logits_rel=d / lg["cpu"].abs().max().item())
    log(f"cpu moe dense f32: 32-token prefill logits card vs cpu max abs {d:.4g} "
        f"(rel {out['cpu_dense_f32']['logits_rel']:.3g})")
    for k in ("cpu_q8_0_f32", "cpu_dense_f32"):
        assert out[k]["logits_rel"] <= 1e-4, f"card and CPU disagree ({k}): {out[k]}"
    del dense
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ slice 6 paths
# slice 6's kernel rows: the harness whose run holds the row's launches, and
# the harness row timed per call for it
SLICE6 = {
    "layer_tail_kt_fused_rowq": ("sweep_tail", "w2_ktile T=8"),
    "rowq_gemm_bf16": ("bench_gemm", None),  # a layer: the four shapes' k17_ms
    "step_pallas_bf16": ("roofline", "pallas_bf16"),
    "step_q8_current": ("roofline", "q8_current"),
    "step_q8_bf16mul": ("roofline", "q8_bf16mul"),
    "step_q8_int8dot": ("roofline", "q8_int8dot"),
    "step_q8_int8dot_blockscale": ("roofline", "q8_int8dot_blockscale"),
    "step_dma_probe": ("roofline", "dma_probe_bf16"),
    "call3_q8_current": ("roofline", "3d_q8_current"),
    "call3_q8_int8dot": ("roofline", "3d_q8_int8dot"),
    "call3_bf16": ("roofline", "3d_bf16"),
    "call3_dma_probe": ("roofline", "3d_dma_probe_bf16"),
    "probe_blockspec": ("dma_sweep", "blockspec_probe_int8 to=1024"),
    "probe_manual_dma": ("dma_sweep", "manual_probe_int8 d=4 ch=512"),
    "int8dot_manual_dma": ("dma_sweep", "manual_int8dot d=4 ch=512"),
}


def run_harness_paths(dev, dims=LLAMA32_1B) -> dict:
    """Slice 6's harnesses at full size, each its own path: every count set to
    0 just before and read just after; each harness times its repeated
    launches as one CUDA-graph replay and asserts that each kernel's count
    grew by the launches it issued; their JSON rows are printed here.
    - sweep_tail: K9 against K16 over the 16 llama32-1b layers, T = 1 and 8;
    - bench_gemm: torch._int_mm + epilogue, K4, K17 and bf16 torch.matmul at
      the four prefill projections, T = 512 and 128;
    - roofline: K18's rows (and the library rows) on [24, 4096, 4096] stacks;
    - dma_sweep: K19's rows on the same stacks."""
    import torch

    import gc

    from llamatpu_torch.bench import bench_gemm, dma_sweep, roofline, sweep_tail

    # the earlier phases' engines left in reference cycles (services, their
    # threads) hold decode graphs: free them now, not by a collection during a
    # harness's capture (global mode), which destroying a graph invalidates
    gc.collect()
    fns = counters()
    out = {}

    def run(label, fn, key):
        for f in fns.values():
            f.launches = 0
        t0 = time.perf_counter()
        rows = fn()
        launches = {k: f.launches for k, f in fns.items()}
        for r in rows:
            log(f"{label}: {json.dumps(r)}")
        out[label] = dict(rows=rows, launches=launches, seconds=time.perf_counter() - t0,
                          by_key={key(r): r for r in rows})

    L, D, F, KV, G, HD = (dims[k] for k in ("L", "D", "F", "KV", "G", "HD"))

    def tails():
        rows = []
        for t in (1, 8):
            st = sweep_tail.make_tail(L, D, KV * G * HD, F, t, dev)
            rows += sweep_tail.sweep(st, 32, dev)
            del st
        return rows
    run("sweep_tail", tails, lambda r: f"{r['variant']} T={r['T']}")
    run("bench_gemm", lambda: bench_gemm.bench(dims["T"], 32, dev) + bench_gemm.bench(128, 32, dev),
        lambda r: f"{r['shape']} T={r['T']}")
    w = probe_weights(dev)
    run("roofline", lambda: roofline.bench(w, 24, dev), lambda r: r["variant"])
    run("dma_sweep", lambda: dma_sweep.bench(w, 24, dev), lambda r: r["probe"])
    del w
    torch.cuda.empty_cache()
    for label, res in out.items():
        log(f"{label}: {res['seconds']:.1f} s, launches "
            f"{({k: v for k, v in res['launches'].items() if v})}")
    return out


def slice6_in_path_ms(harness: dict, name: str) -> float:
    """Device ms per call of a slice-6 kernel in its harness's graph replay."""
    label, key = SLICE6[name]
    h = harness[label]
    if label == "sweep_tail":
        return h["by_key"][key]["ms_per_layer"]
    if label == "bench_gemm":  # one layer's four projections at the prefill chunk, as the row
        return sum(r["k17_ms"] for r in h["rows"] if r["T"] == LLAMA32_1B["T"])
    return h["by_key"][key]["ms_per_call"]


PPL_TEXT = ("The capital of France is Paris. It lies on the Seine, and its museums hold "
            "paintings from every century. ") * 6


def run_tool_paths(dev, gguf: Path, workdir: Path) -> dict:
    """The measuring tools on the full-width Q8_0 GGUF (context 8192), in
    process, each with its counts set to 0 just before and read after:
    - `cli bench --rowq --pp 512 --tg 128 --pg 512+128 -d 0 4096 -r 2 -o jsonl
      --batch 8 --prefill-chunk 512`: the llama-bench rows (names and token counts held), q8_row
      through K4 (prefill), K1, K2 and K3 (B = 1 decode), K2, K6 and K9 (8
      lanes);
    - `cli ppl` on a short text: finite ppl, the scored tokens;
    - `cli run --rowq --profile-dir`: the Chrome trace names K1's kernel."""
    import contextlib
    import io

    from llamatpu_torch import cli

    fns = counters()
    out = {}

    def invoke(label, argv):
        for f in fns.values():
            f.launches = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        res = dict(rc=rc, seconds=time.perf_counter() - t0,
                   launches={k: f.launches for k, f in fns.items() if f.launches})
        assert rc == 0, f"cli {label}: rc {rc}, output {buf.getvalue()[:400]!r}"
        out[label] = res
        return buf.getvalue()

    # the main path's 512-row prefill chunk (the CLI's default is 128): the
    # batched row ingests 8 prompts of 4096 tokens per repeat
    text = invoke("bench", ["bench", "-m", str(gguf), "--device", str(dev), "--rowq",
                            "--pp", "512", "--tg", "128", "--pg", "512+128", "-d", "0", "4096",
                            "-r", "2", "-o", "jsonl", "--batch", "8", "--prefill-chunk", "512"])
    rows = [json.loads(line) for line in text.splitlines()]
    for r in rows:
        log(f"cli bench: {json.dumps(r)}")
    want = [("pp512", 512), ("tg128", 128), ("pp512@d4096", 512), ("tg128@d4096", 128),
            ("pg512+128", 640), ("tg128@b8", 1024)]
    assert [(r["test"], r["n"]) for r in rows] == want, rows
    assert all(r["tok_s"] > 0 for r in rows)
    got = out["bench"]["launches"]
    for k in ("rowq_gemm", "rowq_gemv", "qkv_norm_fused_rowq", "layer_attn_tail_fused_rowq",
              "layer_tail_fused_rowq", "decode_attention_fused_write"):
        assert got.get(k, 0) > 0, f"cli bench: {k} never launched ({got})"
    out["bench"]["rows"] = rows
    log(f"cli bench: {out['bench']['seconds']:.1f} s, launches {got}")

    res = json.loads(invoke("ppl", ["ppl", "-m", str(gguf), "--device", str(dev),
                                    "--text", PPL_TEXT]))
    assert res["tokens"] > 64 and 1.0 < res["ppl"] < float("inf"), res
    assert out["ppl"]["launches"].get("block_matmul", 0) > 0, out["ppl"]
    out["ppl"].update(res)
    log(f"cli ppl: {res} in {out['ppl']['seconds']:.1f} s, launches {out['ppl']['launches']}")

    prof = workdir / "profile"
    invoke("profile", ["run", "-m", str(gguf), "--device", str(dev), "--rowq", "-p",
                       "Why is the sky blue?", "-n", "64", "--temperature", "0",
                       "--metrics-format", "none", "--profile-dir", str(prof)])
    trace = json.loads((prof / "trace.json").read_text())
    names = [e.get("name", "") for e in trace["traceEvents"]]
    k1 = [n for n in names if any(k in n for k in K1_NAMES)]
    assert k1, f"cli run --profile-dir: K1's kernel ({K1_NAMES}) not in the trace"
    out["profile"].update(trace_events=len(names), k1_events=len(k1),
                          trace_mb=(prof / "trace.json").stat().st_size / 1e6)
    log(f"cli run --profile-dir: {len(names)} trace events, {len(k1)} of K1 ({k1[0][:60]!r})")
    shutil.rmtree(prof, ignore_errors=True)
    return out


# ------------------------------------------------------------ slice 7


def check_ffn_fused(dev, dims=PHI3_MEDIUM, wide=QWEN25_14B) -> dict:
    """K20 against its plain version: at Phi-3-medium widths with T = 17 and
    24 bf16 rows (its path's rows; rowq_tc.cuh), within 1e-2 of the largest
    plain output (act rounds to bf16, so a sum taken in another order can
    move an act value one bf16 ulp), two runs bit-equal, and at Qwen2.5-14B
    widths with T = 32 f32 rows (gemv.cuh) within 1e-5 (f32 sums in another
    order); None at 25 bf16 rows (the fit declines) and at 33. Timed at T =
    17 and 24 bf16 over the stack's layers in turn, beside its bound, the
    plain version and the library yardstick: two bf16 torch.matmul on the
    dequantized layer with the silu glue. The row's numbers are T = 24's."""
    import torch
    import torch.nn.functional as F_

    from llamatpu_torch.ops import ffn_fused

    gen = torch.Generator(device=dev).manual_seed(17)
    L, D, F = dims["L"], dims["D"], dims["F"]
    w13, w2 = rand_rowq(L, 2 * F, D, dev, gen), rand_rowq(L, D, F, dev, gen)
    errs = {}
    for t in (17, 24):
        x = torch.randn((t, 1, D), device=dev, generator=gen).to(torch.bfloat16)
        got = ffn_fused.ffn_fused_rowq(w13, w2, x, 1)
        again = ffn_fused.ffn_fused_rowq(w13, w2, x, 1)
        want = ffn_fused.ffn_fused_plain(w13, w2, x, 1)
        torch.cuda.synchronize()
        assert got.dtype == x.dtype and got.shape == x.shape
        assert torch.equal(got, again), f"K20 T={t} bf16: two runs differ"
        errs[f"bf16 T={t}"] = abs_e, rel_e = max_err(got, want)
        assert rel_e <= 1e-2, f"K20 disagrees at T={t} bf16: max abs {abs_e} rel {rel_e}"
        log(f"K20 Phi-3-medium T={t} bf16: max abs {abs_e:.3g} rel {rel_e:.3g}, two runs "
            "bit-equal")
    for t in (25, 33):
        assert ffn_fused.ffn_fused_rowq(w13, w2, torch.zeros((t, D), device=dev,
                                                             dtype=torch.bfloat16), 0) is None
    li = iter(range(10**9))
    w13_bf = (w13.qs[0].float() * w13.scales[0]).to(torch.bfloat16)
    w2_bf = (w2.qs[0].float() * w2.scales[0]).to(torch.bfloat16)
    by_rows = {}
    for t in (17, 24):
        x = torch.randn((t, D), device=dev, generator=gen).to(torch.bfloat16)

        def library(x=x):
            g13 = torch.matmul(x, w13_bf.T)
            return torch.matmul(F_.silu(g13[:, :F]) * g13[:, F:], w2_bf.T)
        b_ms, b_by = bound(3 * F * D + (2 * F + D) * 4 + 2 * t * D * 2, 2 * t * 3 * F * D,
                           BF16_OPS_S)
        by_rows[t] = dict(bound_ms=b_ms, bound_by=b_by, **timings(
            lambda x=x: ffn_fused.ffn_fused_rowq(w13, w2, x, next(li) % L), K20_TC,
            lambda x=x: ffn_fused.ffn_fused_plain(w13, w2, x, next(li) % L), library,
            graph=True))
        tm = by_rows[t]
        log(f"K20 Phi-3-medium T={t} bf16: {tm['ms']:.4f} ms (bound {b_ms:.4f} by {b_by}, plain "
            f"{tm['plain_ms']:.4f}, library {tm['library_ms']:.4f})")
    del w13, w2, w13_bf, w2_bf
    torch.cuda.empty_cache()
    L, D, F = wide["L"], wide["D"], wide["F"]
    w13, w2 = rand_rowq(L, 2 * F, D, dev, gen), rand_rowq(L, D, F, dev, gen)
    x = torch.randn((32, D), device=dev, generator=gen)
    got = ffn_fused.ffn_fused_rowq(w13, w2, x, 1)
    want = ffn_fused.ffn_fused_plain(w13, w2, x, 1)
    torch.cuda.synchronize()
    assert got is not None and got.dtype == torch.float32
    errs["f32 T=32 Qwen2.5-14B"] = abs_f, rel_f = max_err(got, want)
    assert rel_f <= 1e-5, f"K20 disagrees at T=32 f32: max abs {abs_f} rel {rel_f}"
    f32_ms = kernel_ms(lambda: ffn_fused.ffn_fused_rowq(w13, w2, x, 1), ("gemv_tiled_kernel",))
    log(f"K20 Qwen2.5-14B T=32 f32: max abs {abs_f:.3g} rel {rel_f:.3g}, {f32_ms} ms")
    del w13, w2
    torch.cuda.empty_cache()
    return dict(
        name="ffn_fused_rowq", route="cuda", source="llamatpu_torch/csrc/rowq_tc.cuh",
        replaces="llamatpu/ops/ffn_fused.py:64", max_abs_err=max(e[0] for e in errs.values()),
        max_rel_err=max(e[1] for e in errs.values()), errors=errs,
        tolerance="rel to max|plain|: bf16 <= 1e-2 (T 17, 24; two runs bit-equal), "
                  "f32 <= 1e-5 (T 32)",
        **by_rows[24], library="two bf16 torch.matmul on the dequantized layer + silu glue",
        f32_t32_ms=f32_ms, by_rows=by_rows,
        shape=f"T=24 bf16 D={dims['D']} F={dims['F']} (Phi-3-medium)")


def check_phi3_geometry(dev, dims=PHI3_MEDIUM) -> dict:
    """K9 and K2 at Phi-3-medium widths, their first use there: K9 at T = 1,
    8 and 16 rows in bf16 (within 1e-2 of the largest plain output) and f32
    (1e-5), None at 17 bf16 rows (its fit declines); K9 timed at T = 1, 8 and
    16 bf16 (checked again at rs 0.5, two runs bit-equal); K2 at O = 7680
    with 1, 8 and 24 rows (1e-2), timed beside bf16 torch.matmul on the
    dequantized weight.
    Then the equalized q8_row conversion of one layer on the card against
    the CPU's, bit for bit. Returns a sub-row per kernel name."""
    import torch

    from llamatpu_torch.ops import layer_fused

    gen = torch.Generator(device=dev).manual_seed(23)
    L, D, F, KV, G, HD = (dims[k] for k in ("L", "D", "F", "KV", "G", "HD"))
    H, O = KV * G * HD, (KV * G + 2 * KV) * HD
    wo, w13, w2 = rand_rowq(L, D, H, dev, gen), rand_rowq(L, 2 * F, D, dev, gen), \
        rand_rowq(L, D, F, dev, gen)
    nw = torch.rand((L, D), device=dev, generator=gen) + 0.5
    k9 = {}
    for dt, key, tol in ((torch.float32, "f32", 1e-5), (torch.bfloat16, "bf16", 1e-2)):
        for t in (1, 8, 16):
            attn = torch.randn((t, H), device=dev, generator=gen).to(dt)
            x = torch.randn((t, D), device=dev, generator=gen).to(dt)
            got = layer_fused.layer_tail_fused_rowq(wo, w13, w2, nw, attn, x, 1, 1e-5)
            want = layer_fused.layer_tail_plain(wo, w13, w2, nw, attn, x, 1, 1e-5)
            torch.cuda.synchronize()
            abs_e, rel_e = max_err(got, want)
            assert rel_e <= tol, f"K9 at Phi-3-medium T={t} {key}: max abs {abs_e} rel {rel_e}"
            k9[f"{key} T={t}"] = dict(max_abs_err=abs_e, max_rel_err=rel_e)
    z = torch.zeros((17, D), device=dev, dtype=torch.bfloat16)
    assert layer_fused.layer_tail_fused_rowq(wo, w13, w2, nw, z[:, :1].expand(17, H).contiguous(),
                                             z, 0, 1e-5) is None
    li = iter(range(10**9))
    for t in (1, 8, 16):
        attn = torch.randn((t, H), device=dev, generator=gen).to(torch.bfloat16)
        x = torch.randn((t, D), device=dev, generator=gen).to(torch.bfloat16)
        got = layer_fused.layer_tail_fused_rowq(wo, w13, w2, nw, attn, x, L - 1, 1e-5, 0.5)
        again = layer_fused.layer_tail_fused_rowq(wo, w13, w2, nw, attn, x, L - 1, 1e-5, 0.5)
        want = layer_fused.layer_tail_plain(wo, w13, w2, nw, attn, x, L - 1, 1e-5, 0.5)
        torch.cuda.synchronize()
        assert torch.equal(got, again), f"K9 at Phi-3-medium T={t}: two runs differ"
        abs_e, rel_e = max_err(got, want)
        assert rel_e <= 1e-2, f"K9 at Phi-3-medium T={t} rs 0.5: max abs {abs_e} rel {rel_e}"
        b_ms, b_by = bound(D * H + 3 * F * D + (2 * D + 2 * F) * 4 + t * (H + 2 * D) * 2,
                           2 * t * (D * H + 3 * F * D), BF16_OPS_S)
        k9[f"timed T={t}"] = dict(bound_ms=b_ms, bound_by=b_by, max_rel_err=rel_e, **timings(
            lambda: layer_fused.layer_tail_fused_rowq(wo, w13, w2, nw, attn, x, next(li) % L,
                                                      1e-5), K9_TC,
            lambda: layer_fused.layer_tail_plain(wo, w13, w2, nw, attn, x, next(li) % L, 1e-5),
            None, graph=True))
        log(f"K9 Phi-3-medium T={t}: {k9[f'timed T={t}']['ms']:.4f} ms (bound {b_ms:.4f}), "
            f"rs 0.5 rel err {rel_e:.3g}, two runs bit-equal")
    del wo, w13, w2
    wqkv = rand_rowq(L, O, D, dev, gen)
    wqkv_bf = (wqkv.qs[0].float() * wqkv.scales[0]).to(torch.bfloat16)
    k2 = {}
    for t in (1, 8, 24, 32):
        x = torch.randn((t, 1, D), device=dev, generator=gen).to(torch.bfloat16)
        got = layer_fused.qkv_norm_fused_rowq(wqkv, nw, x, 1, 1e-5)
        again = layer_fused.qkv_norm_fused_rowq(wqkv, nw, x, 1, 1e-5)
        want = layer_fused.qkv_norm_plain(wqkv, nw, x, 1, 1e-5)
        torch.cuda.synchronize()
        assert torch.equal(got, again), f"K2 at O={O}, {t} rows: two runs differ"
        abs_e, rel_e = max_err(got, want)
        assert rel_e <= 1e-2, f"K2 at O={O}, {t} rows: max abs {abs_e} rel {rel_e}"
        b_ms, b_by = bound(O * D + O * 4 + t * D * 2 + D * 4 + t * O * 2, 2 * t * O * D,
                           BF16_OPS_S)
        xb = x.reshape(t, D)
        k2[t] = dict(max_abs_err=abs_e, max_rel_err=rel_e, bound_ms=b_ms, bound_by=b_by,
                     library="bf16 torch.matmul on the dequantized weight (no norm)",
                     **timings(lambda: layer_fused.qkv_norm_fused_rowq(wqkv, nw, x,
                                                                       next(li) % L, 1e-5),
                               K2_TC,
                               lambda: layer_fused.qkv_norm_plain(wqkv, nw, x, next(li) % L,
                                                                  1e-5),
                               lambda xb=xb: torch.matmul(xb, wqkv_bf.T), graph=True))
        log(f"K2 at O={O}, {t} rows: {k2[t]['ms']:.4f} ms (bound {b_ms:.4f}, library "
            f"{k2[t]['library_ms']:.4f}), rel err {rel_e:.3g}")
    del wqkv, wqkv_bf
    torch.cuda.empty_cache()
    k1 = check_phi3_k1(dev, gen, D, H, F)
    # the equalized q8_row conversion of a Phi-3-medium layer on the card is
    # bit-equal to the CPU's (the engines convert on their device)
    import numpy as np

    from llamatpu_torch.models.weights import QTensor, equalize_rowq_layers

    rng = np.random.default_rng(29)

    def q8(o, i):
        qs = np.maximum(rng.integers(-128, 128, (1, o, i), dtype=np.int8), -127)
        return QTensor(qs, rng.random((1, o, i // 32), dtype=np.float32) * 0.001 + 0.0005)
    layers = {"wqkv": q8(O, D), "w13": q8(2 * F, D), "w2": q8(D, F),
              "attn_norm": np.ones((1, D), np.float32), "ffn_norm": np.ones((1, D), np.float32)}
    t0 = time.perf_counter()
    host = equalize_rowq_layers(layers)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    card = equalize_rowq_layers(layers, dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    for k in ("wqkv", "w13", "w2"):
        assert card[k].kind == host[k].kind == "q8_row", k
        assert torch.equal(card[k].qs.cpu(), torch.from_numpy(host[k].qs)) and \
            torch.equal(card[k].scales.cpu(), torch.from_numpy(host[k].scales)), k
    for k in ("attn_norm", "ffn_norm"):
        assert np.array_equal(card[k], host[k]), k
    log(f"equalize_rowq_layers of a Phi-3-medium layer: card and CPU bit-equal ({card_s:.2f} s "
        f"on the card, {host_s:.2f} s on the host)")
    del card, host, layers
    torch.cuda.empty_cache()
    return {"layer_tail_fused_rowq": dict(shape=f"D={D} H={H} F={F}", by_rows=k9),
            "qkv_norm_fused_rowq": dict(shape=f"O={O} D={D}", by_rows=k2),
            "rowq_gemv": dict(shape=f"wo [{D}, {H}], w13 [{2 * F}, {D}], w2 [{D}, {F}]",
                              by_rows=k1)}


def check_phi3_k1(dev, gen, D, H, F) -> dict:
    """K1 on Phi-3-medium's wo, w13 and w2 at 24 and 32 bf16 rows (the
    batched step's projections where the fused tails decline): within 1e-5
    of the largest plain output, two runs bit-equal, timed over a stack's
    layers in turn beside its bound and bf16 torch.matmul on the weight as
    bf16 (the same raw sums)."""
    import torch

    from llamatpu_torch.ops import quant_matmul

    out = {}
    for name, (o, i, n) in (("wo", (D, H, 3)), ("w13", (2 * F, D, 2)), ("w2", (D, F, 2))):
        qs = torch.randint(-127, 128, (n, o, i), dtype=torch.int8, device=dev, generator=gen)
        w_bf = qs[0].to(torch.bfloat16)
        li = iter(range(10**9))
        for t in (24, 32):
            x = torch.randn((t, i), device=dev, generator=gen).to(torch.bfloat16)
            got, want = quant_matmul.rowq_gemv(x, qs[1]), quant_matmul.rowq_gemv_plain(x, qs[1])
            again = quant_matmul.rowq_gemv(x, qs[1])
            torch.cuda.synchronize()
            assert torch.equal(got, again), f"K1 {name} T={t}: two runs differ"
            abs_e, rel_e = max_err(got, want)
            assert rel_e <= 1e-5, f"K1 {name} [{o}, {i}] T={t}: max abs {abs_e} rel {rel_e}"
            b_ms, b_by = bound(o * i + t * i * 2 + t * o * 4, 2 * t * o * i, BF16_OPS_S)
            r = out[f"{name} T={t}"] = dict(
                shape=f"[{o}, {i}]", max_abs_err=abs_e, max_rel_err=rel_e, bound_ms=b_ms,
                bound_by=b_by, library="bf16 torch.matmul on the weight as bf16", **timings(
                    lambda x=x: quant_matmul.rowq_gemv(x, qs[next(li) % n]), K1_NAMES,
                    lambda x=x: quant_matmul.rowq_gemv_plain(x, qs[next(li) % n]),
                    lambda x=x: torch.matmul(x, w_bf.T), iters=8, graph=True))
            log(f"K1 Phi-3-medium {name} [{o}, {i}] T={t}: {r['ms']:.4f} ms (bound {b_ms:.4f}, "
                f"library {r['library_ms']:.4f}), rel err {rel_e:.3g}, two runs bit-equal")
        del qs, w_bf
        torch.cuda.empty_cache()
    return out


def drive_batch(engine, prompts: list[list[int]], n: int, want_fn, label: str) -> dict:
    """One counted generate_batch run of a batched engine: every count set to
    0 just before, `n` greedy tokens per prompt, the counts read just after
    and held to want_fn(decode steps, prefill chunks); then a traced 16-step
    window with every lane active and its aggregate decode tok/s."""
    import torch

    V = engine.cfg.vocab_size
    engine.generate_batch(prompts[:2], 4)  # warm-up
    torch.cuda.synchronize()
    fns = counters()
    for f in fns.values():
        f.launches = 0
    steps0, chunks0 = engine.decode_steps, engine.prefill_chunks
    t0 = time.perf_counter()
    outs = engine.generate_batch(prompts, n)
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in fns.items()}
    steps, chunks = engine.decode_steps - steps0, engine.prefill_chunks - chunks0
    assert [len(o) for o in outs] == [n] * len(prompts) and all(
        0 <= t < V for o in outs for t in o), f"{label}: outputs"
    want = {k: 0 for k in fns}
    want.update(want_fn(steps, chunks))
    assert launches == want, f"{label}: launch counts {launches} != {want}"
    res = dict(lanes=len(prompts), wall_s=wall, decode_steps=steps, prefill_chunks=chunks,
               launches=launches, tok_s=len(prompts) * n / wall)
    res["decode16_trace"] = tr = decode_window_trace(engine, agg_tokens=0)
    log(f"{label}: {len(prompts)} lanes x {n} tokens in {wall:.2f} s ({res['tok_s']:.1f} tok/s), "
        f"{steps} steps, {chunks} chunks, launches {({k: v for k, v in launches.items() if v})}; "
        f"traced 16-step window: busy {tr['busy_ms']:.3f} of {tr['wall_ms']:.3f} ms (idle share "
        f"{tr['idle_share']:.3f}), aggregate decode {tr['agg_decode_tok_s']:.1f} tok/s; top "
        f"{[(t['name'][:40], round(t['ms'], 3)) for t in tr['kernels'][:5]]}")
    return res


def tail_share(res: dict, label: str) -> None:
    """The shares of a traced decode window's device busy time taken by K1,
    K2 and K9 or K20 (each Phi-3 window runs at most one of the two), beside
    its idle share. All are read from `device_breakdown`'s union of
    intervals, so a phase's wait for the phase before it is not counted
    twice."""
    tr = res["decode16_trace"]

    def share(names):
        ms = sum(k["ms"] for k in tr["kernels"] if any(n in k["name"] for n in names))
        return ms, ms / tr["busy_ms"]
    res["tail_tc_ms"], res["tail_tc_share"] = share(K9_TC + K20_TC)
    res["k1_ms"], res["k1_share"] = share(K1_NAMES)
    res["k2_ms"], res["k2_share"] = share(K2_TC)
    which = ("K20" if tr["launches"].get("ffn_fused_rowq") else
             "K9" if tr["launches"].get("layer_tail_fused_rowq") else "no tail")
    log(f"{label}: {which} {res['tail_tc_ms']:.3f}, K1 {res['k1_ms']:.3f}, K2 {res['k2_ms']:.3f} "
        f"of {tr['busy_ms']:.3f} ms busy (shares {res['tail_tc_share']:.3f}, "
        f"{res['k1_share']:.3f}, {res['k2_share']:.3f}); idle share {tr['idle_share']:.3f}; "
        f"overlap counted once {tr['overlap_ms']:.3f} ms")


def run_phi3_paths(dev, n_layers=None) -> dict:
    """Slice 7's path: Phi-3-medium-4k at full width (synthetic Q8_0, seed 0,
    served as q8_row) at `n_layers` (default all 40), where the JAX package's
    fits decline K3 at one lane and K9 at 17-24:
    - phi3_b1: Engine, cache 1024, a 128-token prompt (one chunk, K4) then
      32 greedy tokens: K2, K6 and K9 per layer and step, K3 = 0, K1 for
      the head;
    - phi3_b8 / phi3_b24 / phi3_b32: BatchEngine over 8, 24 and 32 lanes:
      K2 and K6 per layer and step, then K9 (8 lanes), K20 with K1 for wo
      (24 lanes, K9 = 0), or the two-call FFN, K1 for wo, w13 and w2 (32
      lanes, K9 = K20 = 0);
    - phi3_paged24: PagedBatchEngine over 24 lanes: K2, K8 and K20.
    The Engine converts the weights once (fuse, equalize, requantize,
    upload); the batch engines serve that tree. Load s and peak host RSS
    are kept beside each path's tok/s and idle share."""
    import dataclasses

    import numpy as np
    import torch

    from llamatpu_torch.models.synthetic import build_synthetic_model
    from llamatpu_torch.runtime.batch_engine import BatchEngine
    from llamatpu_torch.runtime.engine import Engine
    from llamatpu_torch.runtime.paged_engine import PagedBatchEngine

    out = {}
    t0 = time.perf_counter()
    model = build_synthetic_model("phi3-mini", quant="q8_0", seed=0, overrides=dict(
        PHI3_OVERRIDES, n_layers=n_layers or PHI3_OVERRIDES["n_layers"]))
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine = Engine(model, cache_len=1024, prefill_chunk=128, decode_window=32, rowq=True,
                    device=dev)
    load_s = time.perf_counter() - t0
    L, V = model.cfg.n_layers, model.cfg.vocab_size
    log(f"phi3: {L} layers, synthetic build {build_s:.1f} s, fuse + rowq + upload {load_s:.1f} s, "
        f"device {torch.cuda.memory_allocated() / 1e9:.2f} GB, peak host RSS "
        f"{host_rss_gb():.1f} GB")
    prompt = np.random.default_rng(42).integers(0, V, 128).tolist()
    out["phi3_b1"] = drive_engine(engine, prompt, 32, lambda n: {
        "rowq_gemv": 1 + n, "qkv_norm_fused_rowq": L * n, "decode_attention_fused_write": L * n,
        "layer_tail_fused_rowq": L * n, "rowq_gemm": 4 * L}, "phi3_b1", repeats=1)
    out["phi3_b1"].update(build_s=build_s, load_s=load_s, host_rss_gb=host_rss_gb(), layers=L)
    tail_share(out["phi3_b1"], "phi3_b1")
    served = dataclasses.replace(model, weights=engine.weights)  # fused q8_row, on the card
    del engine, model
    torch.cuda.empty_cache()
    rng = np.random.default_rng(3)

    def common(steps, chunks):  # K2 per layer and step; K4 per layer in each 128-row chunk
        return dict(qkv_norm_fused_rowq=L * steps, rowq_gemm=4 * L * chunks)
    for label, lanes, paged, ffn in (("phi3_b8", 8, False, "k9"), ("phi3_b24", 24, False, "k20"),
                                     ("phi3_paged24", 24, True, "k20"),
                                     ("phi3_b32", 32, False, "two calls")):
        kw = dict(batch_size=lanes, prefill_chunk=128, decode_window=16, device=dev)
        engine = (PagedBatchEngine(served, block_size=16, max_len=1024, **kw) if paged
                  else BatchEngine(served, cache_len=1024, **kw))
        attn = "decode_attention_paged" if paged else "decode_attention_fused_write"

        def want(steps, chunks, ffn=ffn, attn=attn):
            w = dict(common(steps, chunks), **{attn: L * steps})
            if ffn == "k9":
                w.update(layer_tail_fused_rowq=L * steps, rowq_gemv=steps + chunks)
            elif ffn == "k20":  # wo through K1, then the FFN as one K20 call
                w.update(ffn_fused_rowq=L * steps, rowq_gemv=(L + 1) * steps + chunks)
            else:  # wo, w13 and w2 through K1
                w.update(rowq_gemv=(3 * L + 1) * steps + chunks)
            return w
        prompts = [rng.integers(0, V, int(n)).tolist() for n in rng.integers(33, 128, lanes)]
        out[label] = drive_batch(engine, prompts, 16, want, label)
        tail_share(out[label], label)
        if label in ("phi3_b24", "phi3_b32"):
            out[label]["graph"] = graph_decode(engine, label, prompt_len=64)
        del engine
        torch.cuda.empty_cache()
    del served
    torch.cuda.empty_cache()
    return out


PHI3_SPECIALS = {32000: "<|endoftext|>", 32001: "<|assistant|>", 32006: "<|system|>",
                 32007: "<|end|>", 32010: "<|user|>"}


def phi3_vocab(vocab_size: int) -> tuple[list[str], list[float], list[int]]:
    """(tokens, scores, token types) of a SentencePiece vocab padded to
    `vocab_size` as Phi-3's is laid out: <unk>, <s>, </s>, the 256 <0xNN>
    byte-fallback pieces, single characters and a few scored merges, filler
    pieces up to 32000, then the chat specials at their published ids and
    placeholders."""
    import string

    tokens, scores, types = ["<unk>", "<s>", "</s>"], [0.0, 0.0, 0.0], [2, 3, 3]
    tokens += [f"<0x{b:02X}>" for b in range(256)]
    scores += [0.0] * 256
    types += [6] * 256
    chars = ["▁"] + list(string.ascii_letters + string.digits + string.punctuation)
    pieces = ["▁the", "▁a", "▁is", "he", "in", "er", "an", "on", "▁t",
              "▁s", "▁w", "re", "at", "en"]
    tokens += chars + pieces
    scores += [-1.0] * len(chars) + [-2.0 - 0.1 * i for i in range(len(pieces))]
    types += [1] * (len(chars) + len(pieces))
    for i in range(len(tokens), 32000):
        tokens.append(f"▁filler{i}")
        scores.append(-1000.0)
        types.append(1)
    for i in range(32000, vocab_size):
        tokens.append(PHI3_SPECIALS.get(i, f"<|placeholder{i - 32000}|>"))
        scores.append(0.0)
        types.append(3)
    return tokens, scores, types


def write_phi3_gguf(model, path) -> None:
    """A synthetic q8_0 Phi-3 model as a phi3 Q8_0 GGUF through the port's
    writer: fused attn_qkv (q, k, v rows) and ffn_up (gate rows, then up
    rows), f32 norms, the head tied to token_embd, the SPM vocab above."""
    import numpy as np

    from llamatpu_torch.gguf import GGMLType, GGUFWriter, quants

    cfg, w = model.cfg, model.weights
    lw = w["layers"]
    gw = GGUFWriter()
    gw.add("general.architecture", "phi3")
    gw.add("general.name", "synthetic Phi-3-medium-4k")
    for key, v in (("embedding_length", cfg.dim), ("feed_forward_length", cfg.hidden_dim),
                   ("block_count", cfg.n_layers), ("attention.head_count", cfg.n_heads),
                   ("attention.head_count_kv", cfg.n_kv_heads),
                   ("context_length", cfg.context_length),
                   ("attention.layer_norm_rms_epsilon", float(cfg.rms_norm_eps)),
                   ("rope.freq_base", float(cfg.rope_theta)), ("vocab_size", cfg.vocab_size)):
        gw.add("phi3." + key, v)
    tokens, scores, types = phi3_vocab(cfg.vocab_size)
    gw.add("tokenizer.ggml.model", "llama")
    gw.add("tokenizer.ggml.tokens", tokens)
    gw.add("tokenizer.ggml.scores", np.array(scores, dtype=np.float32))
    gw.add("tokenizer.ggml.token_type", np.array(types, dtype=np.int32))
    gw.add("tokenizer.ggml.bos_token_id", 1)
    gw.add("tokenizer.ggml.eos_token_id", 32000)

    def qt(name, parts, li):
        qs = np.concatenate([np.asarray(lw[k].qs[li]) for k in parts])
        sc = np.concatenate([np.asarray(lw[k].scales[li]) for k in parts])
        gw.add_tensor_raw(name, qs.shape, GGMLType.Q8_0, quants.q8_0_blocks(qs, sc))

    gw.add_tensor_raw("token_embd.weight", w["wcls"].qs.shape, GGMLType.Q8_0,
                      quants.q8_0_blocks(np.asarray(w["wcls"].qs), np.asarray(w["wcls"].scales)))
    gw.add_tensor("output_norm.weight", np.asarray(w["final_norm"], np.float32))
    for li in range(cfg.n_layers):
        b = f"blk.{li}."
        gw.add_tensor(b + "attn_norm.weight", np.asarray(lw["attn_norm"][li], np.float32))
        gw.add_tensor(b + "ffn_norm.weight", np.asarray(lw["ffn_norm"][li], np.float32))
        qt(b + "attn_qkv.weight", ("wq", "wk", "wv"), li)
        qt(b + "attn_output.weight", ("wo",), li)
        qt(b + "ffn_up.weight", ("w1", "w3"), li)
        qt(b + "ffn_down.weight", ("w2",), li)
    gw.write(str(path))


def run_phi3_gguf_paths(dev, workdir: Path, n_layers: int = 4) -> dict:
    """Phi-3-medium at full width and `n_layers` layers (a depth cut: the
    file stays ~1.8 GB) as a phi3 Q8_0 GGUF with an SPM vocab: `cli run`
    (K5 for the projections and the head, K6 per layer and step, held to
    the Engine's forwards), then `cli serve --batch-size 8 --paged` over
    HTTP (K5 and K8 held to the engine's steps and chunks)."""
    from llamatpu_torch.models.synthetic import build_synthetic_model

    model = build_synthetic_model("phi3-mini", quant="q8_0", seed=1,
                                  overrides=dict(PHI3_OVERRIDES, n_layers=n_layers))
    L = model.cfg.n_layers
    path = workdir / f"phi3-medium-q8_0-L{L}.gguf"
    t0 = time.perf_counter()
    write_phi3_gguf(model, path)
    del model
    log(f"phi3 gguf: wrote {path.name} ({path.stat().st_size / 1e9:.3f} GB) in "
        f"{time.perf_counter() - t0:.1f} s")
    out = {}
    res = cli_run(dev, path)
    want = {k: 0 for k in res["launches"]}
    fwd = res["chunks"] + res["steps"]
    want.update(block_matmul=(4 * L + 1) * fwd, decode_attention_fused_write=L * res["steps"])
    assert res["launches"] == want, f"phi3 cli run: {res['launches']} != {want}"
    log(f"phi3 gguf: cli run rc 0 in {res['seconds']:.1f} s, {res['chunks']} chunks + "
        f"{res['steps']} steps, {res['chars']} chars streamed: {res['text']!r}")
    out["phi3_cli"] = res
    out["phi3_serve"] = run_serving_path(dev, path, rowq=False, latency=False,
                                         label="phi3_serve")
    path.unlink()
    return out


# ---------------------------------------------------------------- slice 22
# Qwen3-0.6B's geometry (the qwen3-0.6b preset): q width 16 x 128 = 2048 is
# not the dim 1024; physical cache 1152 (cache 1024 + one 128-row granule)
QWEN3_06B = dict(L=28, D=1024, F=3072, KV=8, G=2, HD=128, S=1152, V=151936, T=512)
# Granite-3.2-2b's (the granite-3.2-2b preset) with its µP scales: residual
# 0.22, attention 1/64; L: the layers of the kernel checks' weight stacks
GRANITE_2B = dict(L=8, D=2048, F=8192, KV=8, G=4, HD=64, S=1152, V=49155, T=512)
GRANITE_SCALES = dict(scale=0.015625, rs=0.22)
# Qwen3's <think> / </think> at their ids in the published vocab
QWEN3_THINK = {151667: "<think>", 151668: "</think>"}
KQUANT_T = (1, 8, 512)
TINY_FAMILIES = ("deepseek", "qwen3", "mistral", "devstral", "granite")


def check_family_kernels(dev) -> dict:
    """K2 and K3 at Qwen3-0.6B's shapes (D 1024, q width 2048, head 128, G
    2) and at Granite-3.2-2b's with its µP scales (attention 1/64, residual
    0.22), through check_k2 / check_k3's holds and timings; K6 at Qwen3's
    (check_attention: the Q4_K_M GGUF's decode attention); K1 on Qwen3's
    151936-row and Granite's 49155-row heads (check_k1, no edges); K5 on
    Granite's head (49155 rows: not a multiple of 16) at T = 1, 8 and 512,
    bf16 and f32 (hold_block). Returns {kernel row name: {geometry: row}}."""
    import torch

    from llamatpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device=dev).manual_seed(22)
    out = {"qkv_norm_fused_rowq": {}, "layer_attn_tail_fused_rowq": {}, "rowq_gemv": {},
           "block_matmul": {}, "decode_attention_fused_write": {}}
    log(f"family kernels: K6 at qwen3 {QWEN3_06B}")
    out["decode_attention_fused_write"]["qwen3"] = check_attention(dev, QWEN3_06B, sweep=False)
    for key, dims, scales in (("qwen3", QWEN3_06B, {}), ("granite", GRANITE_2B, GRANITE_SCALES)):
        log(f"family kernels: {key} {dims} {scales}")
        out["qkv_norm_fused_rowq"][key] = check_k2(dev, gen, dims)
        out["layer_attn_tail_fused_rowq"][key] = check_k3(dev, gen, dims, **scales)
        out["rowq_gemv"][key + "_head"] = check_k1(dev, gen, dims, edges=False)
        torch.cuda.empty_cache()
    D, V = GRANITE_2B["D"], GRANITE_2B["V"]
    w, s, q = block_weight(V, D, False, dev, gen)
    w, s = w[0], s[0]
    w_bf = qm.dequant_blocks(q[0], s, torch.bfloat16)
    per = {}
    for t in KQUANT_T:
        errs = [hold_block(qm.block_matmul, qm.block_matmul_plain,
                           torch.randn((t, D), device=dev, generator=gen).to(dt), w, s,
                           f"block_matmul granite head T={t} {dt}")
                for dt in (torch.bfloat16, torch.float32)]
        abs_e, rel_e = max(e[0] for e in errs), max(e[1] for e in errs)
        xb = torch.randn((t, D), device=dev, generator=gen).to(torch.bfloat16)
        b_ms, b_by = bound(V * D + V * (D // 32) * 4 + t * D * 2 + t * V * 4, 2 * t * V * D,
                           BF16_OPS_S)
        route = qm.block_route(t, D, xb.dtype, False)
        per[t] = dict(max_abs_err=abs_e, max_rel_err=rel_e, bound_ms=b_ms, bound_by=b_by,
                      route=route, shape=f"T={t} O={V} I={D}",
                      **timings(lambda: qm.block_matmul(xb, w, s), K5_NAMES,
                                lambda: qm.block_matmul_plain(xb, w, s),
                                lambda: torch.matmul(xb, w_bf.T), iters=4,
                                graph=route == "tc"))
        log(f"block_matmul granite head T={t} ({route}): {per[t]['ms']:.4f} ms (bound "
            f"{b_ms:.4f}, plain {per[t]['plain_ms']:.4f}, bf16 matmul "
            f"{per[t]['library_ms']:.4f})")
    out["block_matmul"]["granite_head"] = per
    del w, s, q, w_bf
    torch.cuda.empty_cache()
    return out


def kquant_weight(o: int, i: int, kind: str, packed: bool, dev, gen):
    """Random native K-quant weights [O, I]: values of the kind's range
    (Q4_K [-8, 7], packed two a byte under `packed`; Q5_K [-16, 15]), f32
    per-32 scales and offsets of the size a checkpoint's d * sc and dmin * m
    give. Returns (qs as the kernel takes it, scales, offsets, the int8
    values)."""
    import torch

    lo, hi = (-8, 8) if kind == "q4_k" else (-16, 16)
    q = torch.randint(lo, hi, (o, i), dtype=torch.int8, device=dev, generator=gen)
    w = q
    if packed:
        lo4, hi4 = q[..., 0::2].to(torch.int32) & 0xF, q[..., 1::2].to(torch.int32) & 0xF
        w = (lo4 | (hi4 << 4)).to(torch.uint8).view(torch.int8).contiguous()
    s = torch.rand((o, i // 32), device=dev, generator=gen) * 0.002 + 0.001
    offs = (torch.rand((o, i // 32), device=dev, generator=gen) - 0.5) * 0.02
    return w, s, offs, q


def check_kquant_kernels(dev, dims=QWEN3_06B) -> dict:
    """K5 on Q4_K and Q5_K values and K7 on packed Q4_K values, f32 scales,
    at Qwen3-0.6B's four projection shapes (and, for Q4_K, wq and wk apart,
    as the Q4_K_M GGUF runs them beside its Q6_K wv) and T = 1, 8 and 512,
    bf16 and f32, against the plain versions (hold_block); then the whole projection
    through ops/matmul.matmul (the kernel, then the offset epilogue
    xbsum @ offs^T) against the dense product of the reconstructed weight
    (q * scale + offset, f32: rel <= 1e-5). Timed in bf16: the kernel beside
    its plain version, bf16 torch.matmul on the dequantized values and the
    bound of the values and scales; `with_offsets_ms` is the whole
    projection's time. K5 on the Q8_0 values the load makes of Q6_K
    (check_q6k_values) and K13 on the experts' offset term at Qwen1.5-MoE's
    expert widths (check_grouped_offsets) follow. Returns {kernel row name:
    {kind: per (shape, T)}}."""
    import torch

    from llamatpu_torch.models.weights import QTensor
    from llamatpu_torch.ops import quant_matmul as qm
    from llamatpu_torch.ops.matmul import matmul

    gen = torch.Generator(device=dev).manual_seed(23)
    shapes = block_shapes(dims)
    shapes.pop("head")
    apart = {"wq": (dims["KV"] * dims["G"] * dims["HD"], dims["D"]),
             "wk": (dims["KV"] * dims["HD"], dims["D"])}
    out = {"block_matmul": {}, "packed4_matmul": {}}
    for kind, packed in (("q4_k", False), ("q5_k", False), ("q4_k", True)):
        kern = qm.packed4_matmul if packed else qm.block_matmul
        plain = qm.packed4_matmul_plain if packed else qm.block_matmul_plain
        names = K7_NAMES if packed else K5_NAMES
        per = {}
        for name, (o, i) in {**shapes, **(apart if kind == "q4_k" else {})}.items():
            w, s, offs, q = kquant_weight(o, i, kind, packed, dev, gen)
            qt = QTensor(w, s, kind, layout="packed4" if packed else "canonical", offs=offs)
            dense = q.float() * s.repeat_interleave(32, -1) + offs.repeat_interleave(32, -1)
            w_bf = (q.float() * s.repeat_interleave(32, -1)).to(torch.bfloat16)
            for t in KQUANT_T:
                errs = [hold_block(kern, plain,
                                   torch.randn((t, i), device=dev, generator=gen).to(dt), w, s,
                                   f"{kern.__name__} {kind} {name} T={t} {dt}")
                        for dt in (torch.bfloat16, torch.float32)]
                abs_e, rel_e = max(e[0] for e in errs), max(e[1] for e in errs)
                xf = torch.randn((t, i), device=dev, generator=gen)
                got, want = matmul(qt, xf), xf @ dense.T
                torch.cuda.synchronize()
                m_abs, m_rel = max_err(got, want)
                assert m_rel <= 1e-5, f"{kind} {name} T={t} with offsets: {m_abs} rel {m_rel}"
                xb = xf.to(torch.bfloat16)
                wbytes = o * (i // 2 if packed else i) + o * (i // 32) * 4
                b_ms, b_by = bound(wbytes + t * i * 2 + t * o * 4, 2 * t * o * i, BF16_OPS_S)
                route = qm.block_route(t, i, xb.dtype, packed)
                tm = timings(lambda: kern(xb, w, s), names, lambda: plain(xb, w, s),
                             lambda: torch.matmul(xb, w_bf.T), iters=8, graph=route == "tc")
                per[f"{name} T={t}"] = dict(
                    **tm, bound_ms=b_ms, bound_by=b_by, route=route, max_abs_err=abs_e,
                    max_rel_err=rel_e, offsets_max_rel_err=m_rel,
                    with_offsets_ms=time_ms(lambda: matmul(qt, xb), iters=8),
                    shape=f"T={t} O={o} I={i}")
                log(f"{kern.__name__} {kind} {name} T={t} ({route}): {tm['ms']:.4f} ms (bound "
                    f"{b_ms:.4f}, plain {tm['plain_ms']:.4f}, bf16 matmul "
                    f"{tm['library_ms']:.4f}; with the offset epilogue "
                    f"{per[f'{name} T={t}']['with_offsets_ms']:.4f}), rel err {rel_e:.3g}, "
                    f"offsets rel {m_rel:.3g}")
            del w, s, offs, q, dense, w_bf
        for t in KQUANT_T:  # one layer's four projections
            row = [per[f"{n} T={t}"] for n in shapes]
            per[f"layer T={t}"] = {k: sum(r[k] for r in row)
                                   for k in ("ms", "library_ms", "bound_ms", "plain_ms",
                                             "with_offsets_ms")}
        out[kern.__name__][kind] = per
        torch.cuda.empty_cache()
    out["block_matmul"]["q8_0_from_q6_k"] = check_q6k_values(dev, dims)
    out["grouped_dense_matmul"] = {"offsets": check_grouped_offsets(dev)}
    return out


def q6k_as_q8_0(o: int, i: int, dev, seed: int):
    """The Q8_0 values and f32 block scales [O, I], [O, I/32] the loader
    makes of a Q6_K tensor (`quants.requantize_to_q8_0`, as `_load_matmul`),
    from seeded raw superblocks (kquant_raw), on `dev`."""
    import numpy as np
    import torch

    from llamatpu_torch.gguf import GGMLType, quants

    raw = kquant_raw(np.random.default_rng(seed), GGMLType.Q6_K, (o, i))
    q8 = quants.requantize_to_q8_0(GGMLType.Q6_K, raw, o * i)
    qs, sc = quants.q8_0_views(np.asarray(q8, np.uint8), o * i)
    return (torch.from_numpy(np.ascontiguousarray(qs).reshape(o, i)).to(dev),
            torch.from_numpy(np.asarray(sc, np.float32).reshape(o, i // 32)).to(dev))


def check_q6k_values(dev, dims=QWEN3_06B) -> dict:
    """K5 on the Q8_0 values of the Q4_K_M GGUF's Q6_K tensors, at the
    shapes its forward runs them: attn_v, ffn_down and the tied head
    (token_embd, 151936 rows), T = 1, 8 and 512, bf16 and f32, against the
    plain version (hold_block); timed in bf16 beside bf16 torch.matmul on
    the dequantized weight. Returns {(shape, T): row}."""
    import torch

    from llamatpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device=dev).manual_seed(26)
    shapes = {"wv": (dims["KV"] * dims["HD"], dims["D"]), "w2": (dims["D"], dims["F"]),
              "head": (dims["V"], dims["D"])}
    per = {}
    for seed, (name, (o, i)) in enumerate(shapes.items()):
        w, s = q6k_as_q8_0(o, i, dev, seed)
        w_bf = qm.dequant_blocks(w, s, torch.bfloat16)
        for t in KQUANT_T:
            errs = [hold_block(qm.block_matmul, qm.block_matmul_plain,
                               torch.randn((t, i), device=dev, generator=gen).to(dt), w, s,
                               f"block_matmul q8_0 (from Q6_K) {name} T={t} {dt}")
                    for dt in (torch.bfloat16, torch.float32)]
            xb = torch.randn((t, i), device=dev, generator=gen).to(torch.bfloat16)
            b_ms, b_by = bound(o * i + o * (i // 32) * 4 + t * i * 2 + t * o * 4, 2 * t * o * i,
                               BF16_OPS_S)
            route = qm.block_route(t, i, xb.dtype, False)
            per[f"{name} T={t}"] = row = dict(
                **timings(lambda: qm.block_matmul(xb, w, s), K5_NAMES,
                          lambda: qm.block_matmul_plain(xb, w, s),
                          lambda: torch.matmul(xb, w_bf.T), iters=4, graph=route == "tc"),
                bound_ms=b_ms, bound_by=b_by, route=route, shape=f"T={t} O={o} I={i}",
                max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs))
            log(f"block_matmul q8_0 (from Q6_K) {name} T={t} ({route}): {row['ms']:.4f} ms "
                f"(bound {b_ms:.4f}, plain {row['plain_ms']:.4f}, bf16 matmul "
                f"{row['library_ms']:.4f}), rel err {row['max_rel_err']:.3g}")
        del w, s, w_bf
        torch.cuda.empty_cache()
    return per


def check_grouped_offsets(dev, dims=QWEN15) -> dict:
    """K13 on the Q4_K experts' offset term (grouped_offset_term) at
    Qwen1.5-MoE's folded expert widths: gate+up offs [E, 2816, 64] and down
    offs [E, 2048, 44] (zero-padded to 64 for K13 as the load pads them,
    weights.pad_offsets), N in {1, 8, 512} tokens
    at the tile rule, bf16 and f32 activations: against the plain version on
    the same padded operands (f32 <= 1e-5 of the largest |value|) and
    against the unpadded product (the padding adds nothing). Timed with the
    f32 xbsum; no PyTorch call computes this grouped f32 product."""
    import torch
    import torch.nn.functional as F

    from llamatpu_torch.ops import moe_grouped as mg

    E, D, MH, K = (dims[k] for k in ("E", "D", "MH", "K"))
    gen = torch.Generator(device=dev).manual_seed(24)
    per = {}
    for proj, (o, i) in {"gu": (2 * MH, D), "down": (D, MH)}.items():
        nb = i // 32
        pad = -nb % 32
        offs = (torch.rand((E, o, nb), device=dev, generator=gen) - 0.5) * 0.02
        offp = F.pad(offs, (0, pad)).contiguous()
        for n in (1, 8, dims["T"]):
            top = moe_top(n, K, E, seed=n, dev=dev)
            tm = mg.tile_rows(n, K)
            rt, _, te = mg.sort_by_expert(top, E, tm)
            used = te[te >= 0].unique().numel()
            worst = 0.0
            for dt in (torch.bfloat16, torch.float32):
                x = torch.randn((n, i), device=dev, generator=gen).to(dt)
                xs = torch.cat([x, x.new_zeros((1, i))])[rt.long()]
                got = mg.grouped_offset_term(xs, offp, te, tm, row_token=rt, n_tokens=n)
                xb = xs.float().reshape(-1, nb, 32).sum(-1)
                want = mg.grouped_dense_matmul_plain(F.pad(xb, (0, pad)), offp, te, tm)
                unpadded = mg.grouped_dense_matmul_plain(xb, offs, te, tm)
                torch.cuda.synchronize()
                abs_e, rel_e = max_err(got, want)
                assert rel_e <= 1e-5, f"K13 offsets {proj} N={n} {dt}: {abs_e} rel {rel_e}"
                assert max_err(want, unpadded)[1] <= 1e-6, f"K13 offsets {proj}: padding"
                worst = max(worst, rel_e)
            xbp = F.pad(xs.float().reshape(-1, nb, 32).sum(-1), (0, pad)).contiguous()
            kp = nb + pad
            nbytes = used * o * kp * 4 + xbp.shape[0] * kp * 4 + xbp.shape[0] * o * 4
            b_ms, b_by = bound(nbytes, 2 * n * K * o * nb, F32_OPS_S)  # f32 FMAs
            own = kernel_ms(lambda: mg.grouped_dense_matmul(xbp, offp, te, tm, rt, n), MOE_KERNELS)
            wrapper = time_ms(lambda: mg.grouped_dense_matmul(xbp, offp, te, tm, rt, n))
            per[f"{proj} N={n}"] = dict(
                ms=own if own is not None else wrapper,
                ms_source="profiler" if own is not None else "cuda graph", wrapper_ms=wrapper,
                plain_ms=events_ms(lambda: mg.grouped_dense_matmul_plain(xbp, offp, te, tm)),
                library_ms=None, bound_ms=b_ms, bound_by=b_by, used_experts=used, tm=tm,
                term_ms=time_ms(lambda: mg.grouped_offset_term(xs, offp, te, tm, rt, n)),
                shape=f"N={n} O={o} I/32={nb} (padded {kp})", max_rel_err=worst)
            log(f"grouped_dense_matmul offsets {proj} N={n} tm={tm} ({used} experts): "
                f"{per[f'{proj} N={n}']['ms']:.4f} ms (bound {b_ms:.5f} by {b_by}, plain "
                f"{per[f'{proj} N={n}']['plain_ms']:.3f}; the term with its sums "
                f"{per[f'{proj} N={n}']['term_ms']:.4f})")
        del offs, offp
    return per


# ---- slice 22's GGUFs
def kquant_raw(rng, ggml_type, shape) -> "np.ndarray":
    """Seeded raw superblocks of a K-quant tensor of `shape`: random bytes,
    with every f16 d (and Q4_K / Q5_K's dmin) set to a small finite value
    (random bytes there could encode inf or NaN), sized so the weights have
    the spread of a checkpoint's (|w| ~ 0.01-0.03)."""
    import numpy as np

    from llamatpu_torch.gguf import GGMLType

    n = int(np.prod(shape))
    nb = n // 256
    size = {GGMLType.Q4_K: 144, GGMLType.Q5_K: 176, GGMLType.Q6_K: 210}[ggml_type]
    raw = np.frombuffer(rng.bytes(nb * size), np.uint8).reshape(nb, size).copy()
    if ggml_type == GGMLType.Q6_K:
        d = (rng.random(nb, dtype=np.float32) * 2e-5 + 1e-5).astype(np.float16)
        raw[:, 208:210] = d[:, None].view(np.uint8)
    else:
        top = 3e-5 if ggml_type == GGMLType.Q4_K else 1.5e-5  # q in [0, 15] or [0, 31]
        d = (rng.random(nb, dtype=np.float32) * top + top / 2).astype(np.float16)
        dmin = (rng.random(nb, dtype=np.float32) * 2e-5).astype(np.float16)
        raw[:, 0:2] = d[:, None].view(np.uint8)
        raw[:, 2:4] = dmin[:, None].view(np.uint8)
    return raw.reshape(-1)


def write_qwen3_gguf(cfg, path, main, seed: int = 0) -> None:
    """A Qwen3 GGUF of `cfg`'s geometry through the port's writer, from
    seeded raw superblocks (kquant_raw): the projections in `main` (Q4_K or
    Q5_K), attn_v and ffn_down in Q6_K where main is Q4_K (as llama.cpp's
    Q4_K_M; else main too), token_embd (the tied head) in Q6_K, norms f32
    (q/k norm near 1); a ChatML vocab of 151936 ids with <think> / </think>
    at Qwen3's ids."""
    import numpy as np

    from llamatpu_torch.gguf import GGMLType, GGUFWriter

    rng = np.random.default_rng(seed)
    gw = GGUFWriter()
    gw.add("general.architecture", "qwen3")
    gw.add("general.name", f"synthetic Qwen3-0.6B {main.name}")
    for key, v in (("embedding_length", cfg.dim), ("feed_forward_length", cfg.hidden_dim),
                   ("block_count", cfg.n_layers), ("attention.head_count", cfg.n_heads),
                   ("attention.head_count_kv", cfg.n_kv_heads),
                   ("attention.key_length", cfg.head_dim),
                   ("attention.value_length", cfg.head_dim),
                   ("context_length", cfg.context_length),
                   ("attention.layer_norm_rms_epsilon", float(cfg.rms_norm_eps)),
                   ("rope.freq_base", float(cfg.rope_theta)), ("vocab_size", cfg.vocab_size)):
        gw.add("qwen3." + key, v)
    tokens, types, merges = qwen_vocab(cfg.vocab_size)
    for i, t in QWEN3_THINK.items():
        tokens[i] = t
    gw.add("tokenizer.ggml.model", "gpt2")
    gw.add("tokenizer.ggml.pre", "qwen2")
    gw.add("tokenizer.ggml.tokens", tokens)
    gw.add("tokenizer.ggml.merges", merges)
    gw.add("tokenizer.ggml.token_type", np.array(types, dtype=np.int32))
    gw.add("tokenizer.ggml.bos_token_id", 151643)
    gw.add("tokenizer.ggml.eos_token_id", 151645)
    side = GGMLType.Q6_K if main == GGMLType.Q4_K else main

    def kq(name, t, shape):
        gw.add_tensor_raw(name, shape, t, kquant_raw(rng, t, shape))

    def norm(name, n, spread=0.0):
        gw.add_tensor(name, (1.0 + spread * rng.standard_normal(n)).astype(np.float32))

    d, q, kv, f = cfg.dim, cfg.q_dim, cfg.kv_dim, cfg.hidden_dim
    kq("token_embd.weight", GGMLType.Q6_K, (cfg.vocab_size, d))
    norm("output_norm.weight", d)
    for li in range(cfg.n_layers):
        b = f"blk.{li}."
        norm(b + "attn_norm.weight", d)
        norm(b + "ffn_norm.weight", d)
        norm(b + "attn_q_norm.weight", cfg.head_dim, 0.1)
        norm(b + "attn_k_norm.weight", cfg.head_dim, 0.1)
        kq(b + "attn_q.weight", main, (q, d))
        kq(b + "attn_k.weight", main, (kv, d))
        kq(b + "attn_v.weight", side, (kv, d))
        kq(b + "attn_output.weight", main, (d, q))
        kq(b + "ffn_gate.weight", main, (f, d))
        kq(b + "ffn_up.weight", main, (f, d))
        kq(b + "ffn_down.weight", side, (d, f))
    gw.write(str(path))


def tiny_family_gguf(path, family: str, quant, seed: int = 0) -> None:
    """The tiny GGUF of tests/tiny_models.py `build_tiny_gguf(path, family,
    quant, seed, with_tokenizer=True)`, byte for byte (the same numpy draws
    in the same order), written by the port's writer: dim 64, 2 layers, 4
    heads of 16 over 2 KV heads, FFN 96, context 64, the family's keys,
    tokenizer (byte-level BPE with its specials; SentencePiece for Mistral
    and Phi-3) and tensors. For the dense families."""
    import string

    import numpy as np

    from llamatpu_torch.gguf import GGUFWriter
    from llamatpu_torch.gguf.ggml_type import GGMLType
    from llamatpu_torch.tokenizer.bpe import bytes_to_unicode

    rng = np.random.default_rng(seed)
    dim, heads, kv_heads, hd, hidden, layers, ctx = 64, 4, 2, 16, 96, 2, 64
    arch = {"llama": "llama", "mistral": "llama", "devstral": "llama", "qwen2": "qwen2",
            "deepseek": "qwen2", "qwen3": "qwen3", "phi3": "phi3", "granite": "granite"}[family]
    name = {"llama": "Llama Tiny", "mistral": "Mistral Tiny", "devstral": "Devstral Tiny",
            "qwen2": "Qwen2 Tiny", "deepseek": "DeepSeek R1 Distill Tiny", "qwen3": "Qwen3 Tiny",
            "phi3": "Phi3 Tiny", "granite": "Granite Tiny"}[family]
    p = arch + "."
    w = GGUFWriter()
    w.add("general.architecture", arch)
    w.add("general.name", name)
    if family == "deepseek":
        w.add("general.basename", "DeepSeek-R1-Distill-Qwen")
    for key, v in (("embedding_length", dim), ("feed_forward_length", hidden),
                   ("block_count", layers), ("attention.head_count", heads),
                   ("attention.head_count_kv", kv_heads), ("context_length", ctx),
                   ("attention.layer_norm_rms_epsilon", 1e-5), ("rope.freq_base", 10000.0)):
        w.add(p + key, v)
    if family in ("mistral", "phi3"):  # SentencePiece: <unk> <s> </s>, bytes, chars, pieces
        tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
        scores, types = [0.0] * 3 + [0.0] * 256, [2, 3, 3] + [6] * 256
        chars = "▁" + string.ascii_letters + string.digits + string.punctuation
        tokens += list(chars)
        scores += [-1.0] * len(chars)
        types += [1] * len(chars)
        pieces = ["▁the", "▁hello", "▁world", "he", "ll", "lo", "th", "er", "in", "ing", "ion"]
        tokens += pieces
        scores += [-2.0 - 0.1 * i for i in range(len(pieces))]
        types += [1] * len(pieces)
        if family == "phi3":
            specials = ["<|end|>", "<|user|>", "<|assistant|>", "<|system|>"]
            tokens += specials
            scores += [0.0] * len(specials)
            types += [3] * len(specials)
        w.add("tokenizer.ggml.model", "llama")
        w.add("tokenizer.ggml.tokens", tokens)
        w.add("tokenizer.ggml.scores", np.array(scores, dtype=np.float32))
        w.add("tokenizer.ggml.token_type", np.array(types, dtype=np.int32))
        w.add("tokenizer.ggml.bos_token_id", 1)
        w.add("tokenizer.ggml.eos_token_id", 2)
        w.add("tokenizer.ggml.add_bos_token", True)
    else:  # byte-level BPE: the 256 byte chars, nine merges, the family's specials
        if family == "devstral":
            w.add("tokenizer.ggml.pre", "tekken")
        enc = bytes_to_unicode()
        tokens = [enc[i] for i in range(256)]
        pairs = [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o"), ("Ġ", "w"),
                 ("Ġw", "o"), ("Ġwo", "r"), ("Ġwor", "l"), ("Ġworl", "d")]
        merges = [f"{a} {b}" for a, b in pairs]
        tokens += [a + b for a, b in pairs]
        specials = ["<|begin_of_text|>", "<|end_of_text|>", "<|start_header_id|>",
                    "<|end_header_id|>", "<|eot_id|>"]
        if family in ("qwen2", "qwen3"):
            specials += ["<|im_start|>", "<|im_end|>"] + (
                ["<think>", "</think>"] if family == "qwen3" else [])
        elif family == "deepseek":
            specials += ["<｜User｜>", "<｜Assistant｜>", "<think>", "</think>"]
        tokens += specials
        w.add("tokenizer.ggml.model", "gpt2")
        w.add("tokenizer.ggml.tokens", tokens)
        w.add("tokenizer.ggml.merges", merges)
        w.add("tokenizer.ggml.token_type",
              np.array([1] * (256 + len(pairs)) + [3] * len(specials), dtype=np.int32))
        w.add("tokenizer.ggml.bos_token_id", 256 + len(pairs))
        w.add("tokenizer.ggml.eos_token_id", 256 + len(pairs) + 1)
    vocab = len(tokens)
    w.add(p + "vocab_size", vocab)
    if family == "qwen3":
        w.add(p + "attention.key_length", hd)
        w.add(p + "attention.value_length", hd)
    if family == "devstral":
        w.add(p + "attention.key_length", hd)
        for key, v in (("type", "yarn"), ("factor", 2.0), ("yarn_beta_fast", 32.0),
                       ("yarn_beta_slow", 1.0), ("yarn_log_multiplier", 1.0),
                       ("original_context_length", ctx // 2)):
            w.add(p + "rope.scaling." + key, v)
    if family == "granite":
        for key, v in (("embedding_scale", 12.0), ("residual_scale", 0.22),
                       ("attention.scale", 0.0078125), ("logit_scale", 16.0)):
            w.add("granite." + key, v)

    def mat(out, inp, scale=None):
        scale = scale if scale is not None else 1.0 / np.sqrt(inp)
        return (rng.normal(size=(out, inp)) * scale).astype(np.float32)

    def norm(n):
        return (1.0 + 0.1 * rng.normal(size=n)).astype(np.float32)

    q_dim, kv_dim = heads * hd, kv_heads * hd
    w.add_tensor("token_embd.weight", mat(vocab, dim, scale=0.5), quant)
    w.add_tensor("output_norm.weight", norm(dim), GGMLType.F32)
    w.add_tensor("output.weight", mat(vocab, dim), quant)
    for i in range(layers):
        b = f"blk.{i}."
        w.add_tensor(b + "attn_norm.weight", norm(dim), GGMLType.F32)
        w.add_tensor(b + "ffn_norm.weight", norm(dim), GGMLType.F32)
        w.add_tensor(b + "attn_output.weight", mat(dim, q_dim), quant)
        if family == "phi3":
            w.add_tensor(b + "attn_qkv.weight", mat(q_dim + 2 * kv_dim, dim), quant)
            w.add_tensor(b + "ffn_up.weight", mat(2 * hidden, dim), quant)
            w.add_tensor(b + "ffn_down.weight", mat(dim, hidden), quant)
        else:
            w.add_tensor(b + "attn_q.weight", mat(q_dim, dim), quant)
            w.add_tensor(b + "attn_k.weight", mat(kv_dim, dim), quant)
            w.add_tensor(b + "attn_v.weight", mat(kv_dim, dim), quant)
            w.add_tensor(b + "ffn_gate.weight", mat(hidden, dim), quant)
            w.add_tensor(b + "ffn_up.weight", mat(hidden, dim), quant)
            w.add_tensor(b + "ffn_down.weight", mat(dim, hidden), quant)
        if family in ("qwen2", "deepseek"):
            for t, n in (("attn_q.bias", q_dim), ("attn_k.bias", kv_dim), ("attn_v.bias", kv_dim)):
                w.add_tensor(b + t, (rng.normal(size=n) * 0.1).astype(np.float32), GGMLType.F32)
        if family == "qwen3":
            w.add_tensor(b + "attn_q_norm.weight", norm(hd), GGMLType.F32)
            w.add_tensor(b + "attn_k_norm.weight", norm(hd), GGMLType.F32)
    w.write(str(path))


def compare_decode(dev, model, n: int, steps: int, label: str, **kw) -> dict:
    """Prefill logits of an n-token prompt and the logits of `steps` decode
    steps after it (T = 1 through the forward, fed the CPU's greedy ids on
    both sides), f32 on the card and on the CPU (plain versions): the largest
    difference relative to the largest CPU logit of each."""
    import numpy as np
    import torch

    from llamatpu_torch.models.transformer import forward_tokens
    from llamatpu_torch.runtime.engine import Engine

    prompt = np.random.default_rng(7).integers(0, min(model.cfg.vocab_size, 128000), n).tolist()
    res = {}
    feed = None
    for where in ("cpu", dev):
        e = Engine(model, cache_len=1024, prefill_chunk=n, cache_dtype=torch.float32,
                   device=where, **kw)
        tok, logits = e.prefill(prompt, 0)
        rows = [logits.float().cpu()]
        ids = feed or [int(tok[0])]
        for s in range(steps):
            t = torch.tensor([[ids[s]]], device=e.device)
            lg, _ = forward_tokens(e.cfg, e.weights, t, e.cache, n + s, last_logit_only=True)
            rows.append(lg.float().cpu())
            if feed is None:
                ids.append(int(lg.argmax()))
        feed = feed or ids
        res[str(where)] = rows
        del e
    rel = [((a - b).abs().max() / b.abs().max()).item()
           for a, b in zip(res[str(dev)], res["cpu"])]
    log(f"cpu {label}: {n}-token prefill and {steps} decode steps, logits card vs cpu rel "
        f"{[float(f'{r:.3g}') for r in rel]}")
    return dict(prompt=n, steps=steps, logits_rel=rel)


def run_qwen3_paths(dev, workdir: Path, overrides=None, n_layers=None) -> dict:
    """Slice 22's Qwen3-0.6B paths (q/k norm between K2 and K3; q width 2048
    on dim 1024):
    - qwen3: the qwen3-0.6b preset at full width and depth (synthetic Q8_0
      served as q8_row, seed 0) through Engine, pp512 then tg128 greedy (K4,
      K1, K2 and, where the JAX fit takes it, K3; else K6 + K9), the graph
      against the eager window;
    - qwen3_cpu / qwen3_q4k_cpu: the card against the CPU at 2 layers, f32:
      q8_row (K1 prefill, K2 + K3 decode) and native Q4_K weights (K5 + the
      offset epilogue, K6), prefill and decode-step logits within 1e-4;
    - qwen3_q4km_*: a Q4_K_M-style GGUF at full width and depth (Q4_K, Q6_K
      attn_v / ffn_down / token_embd, seeded raw superblocks) through `cli
      run` (K5 on Q4_K and Q8_0 values, the offsets, K6), `cli run
      --no-thinking`, `cli run --pack4` (K7) and `cli serve` (three HTTP
      requests);
    - qwen3_q5k_cli: a Q5_K copy at 4 layers through `cli run` (K5 on Q5_K
      values)."""
    import dataclasses

    import numpy as np
    import torch

    from llamatpu_torch.gguf import GGMLType
    from llamatpu_torch.models.synthetic import build_synthetic_model
    from llamatpu_torch.ops.layer_fused import attn_tail_fits
    from llamatpu_torch.runtime.engine import Engine

    out = {}
    t0 = time.perf_counter()
    model = build_synthetic_model("qwen3-0.6b", quant="q8_0", seed=0, context_length=4096,
                                  n_layers=n_layers, overrides=overrides)
    cfg = model.cfg
    engine = Engine(model, cache_len=1024, prefill_chunk=512, decode_window=128, rowq=True,
                    device=dev)
    L, V = cfg.n_layers, cfg.vocab_size
    s_phys = engine.cache.kv.shape[3]
    k3 = attn_tail_fits(cfg.dim, cfg.q_dim, cfg.hidden_dim, cfg.n_kv_heads, cfg.gqa_groups,
                        cfg.v_head_dim, s_phys, 2, 2)
    log(f"qwen3: {L} layers, dim {cfg.dim}, q width {cfg.q_dim}, built and served in "
        f"{time.perf_counter() - t0:.1f} s; decode takes {'K3' if k3 else 'K6 + K9'} "
        f"(the JAX fit at S = {s_phys}, bf16)")
    prompt = np.random.default_rng(42).integers(0, V, 512).tolist()
    attn = {"layer_attn_tail_fused_rowq": 1} if k3 else \
        {"decode_attention_fused_write": 1, "layer_tail_fused_rowq": 1}
    out["qwen3"] = drive_engine(engine, prompt, 128, lambda n: {
        "rowq_gemv": 1 + n, "qkv_norm_fused_rowq": L * n, "rowq_gemm": 4 * L,
        **{k: L * n * v for k, v in attn.items()}}, "qwen3")
    out["qwen3"]["decode_takes"] = "K3" if k3 else "K6 + K9"
    out["qwen3"]["graph"] = graph_decode(engine, "qwen3")
    del engine, model
    torch.cuda.empty_cache()
    for key, quant, kw in (("qwen3_cpu", "q8_0", dict(rowq=True)), ("qwen3_q4k_cpu", "q4_k", {})):
        small = build_synthetic_model("qwen3-0.6b", quant=quant, seed=1, n_layers=2, dtype="f32",
                                      context_length=1024, overrides=overrides)
        rng = np.random.default_rng(3)
        for k in ("q_norm", "k_norm"):  # the preset's are ones
            small.weights["layers"][k] = (1.0 + 0.1 * rng.standard_normal(
                small.weights["layers"][k].shape)).astype(np.float32)
        out[key] = compare_decode(dev, small, 64, 4, key, **kw)
        assert max(out[key]["logits_rel"]) <= 1e-4, f"card and CPU disagree ({key}): {out[key]}"
        del small
    # the Q4_K_M-style GGUF at full width and depth, and its Q5_K copy at 4 layers
    files = {}
    for main, depth in ((GGMLType.Q4_K, cfg.n_layers), (GGMLType.Q5_K, min(4, cfg.n_layers))):
        t0 = time.perf_counter()
        files[main] = workdir / f"qwen3-0.6b-{main.name.lower()}-L{depth}.gguf"
        write_qwen3_gguf(dataclasses.replace(cfg, n_layers=depth, context_length=4096),
                         files[main], main)
        log(f"qwen3 gguf: wrote {files[main].name} ({files[main].stat().st_size / 1e9:.3f} GB) "
            f"in {time.perf_counter() - t0:.1f} s")
    out["native"] = native_loads(files[GGMLType.Q4_K])
    for label, extra in (("qwen3_q4km_cli", ()), ("qwen3_q4km_no_thinking", ("--no-thinking",)),
                         ("qwen3_q4km_pack4", ("--pack4",))):
        res = cli_run(dev, files[GGMLType.Q4_K], extra)
        fwd = res["chunks"] + res["steps"]
        want = {k: 0 for k in res["launches"]}
        if extra == ("--pack4",):  # q, k, o, gate+up packed; v, down and the head Q8_0
            want.update(packed4_matmul=4 * L * fwd, block_matmul=(2 * L + 1) * fwd)
        else:  # q, k, v apart (v's kind differs), o, gate+up, down, the head
            want.update(block_matmul=(6 * L + 1) * fwd)
        want["decode_attention_fused_write"] = L * res["steps"]
        assert res["launches"] == want, f"{label}: {res['launches']} != {want}"
        assert res["native_calls"] > 0, f"{label}: the load decoded nothing natively"
        log(f"{label}: cli run rc 0 in {res['seconds']:.1f} s ({res['native_calls']} native "
            f"codec calls), {res['chunks']} chunks + {res['steps']} steps, {res['chars']} chars "
            f"streamed: {res['text']!r}")
        out[label] = res
    out["qwen3_q4km_serve"] = serve_kquant(dev, files[GGMLType.Q4_K], L)
    files[GGMLType.Q4_K].unlink()
    res = cli_run(dev, files[GGMLType.Q5_K])
    d5 = min(4, L)
    fwd = res["chunks"] + res["steps"]
    want = {k: 0 for k in res["launches"]}
    want.update(block_matmul=(4 * d5 + 1) * fwd, decode_attention_fused_write=d5 * res["steps"])
    assert res["launches"] == want, f"qwen3_q5k_cli: {res['launches']} != {want}"
    log(f"qwen3_q5k_cli: cli run rc 0, {res['chunks']} chunks + {res['steps']} steps, "
        f"launches {res['launches']}")
    out["qwen3_q5k_cli"] = res
    files[GGMLType.Q5_K].unlink()
    torch.cuda.empty_cache()
    return out


def serve_kquant(dev, path: Path, L: int) -> dict:
    """`llamatpu_torch.cli serve -m <gguf> -n 1024 --no-prefix-cache` in-process
    (one Engine behind a lock) on 127.0.0.1: a chat with a system turn, a
    streamed chat and a text completion, one after another; the launches held
    to the Engine's forwards (K5 per projection as in `cli run`, K6 per layer
    and step)."""
    import threading

    from llamatpu_torch import cli
    from llamatpu_torch.models.loader import load_model
    from llamatpu_torch.server.openai_server import build_service, make_server

    args = cli.build_parser().parse_args(["serve", "-m", str(path), "-n", "1024",
                                          "--no-prefix-cache", "--device", str(dev)])
    model = load_model(str(path), max_tokens=args.max_tokens)
    svc = build_service(args, model)
    srv = make_server(svc, "127.0.0.1", 0, model_id="qwen3-q4_k_m")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    fns = counters()
    restore, fw = count_forwards()
    for f in fns.values():
        f.launches = 0
    t0 = time.perf_counter()
    try:
        status, raw = http(url + "/v1/chat/completions", {
            "messages": [{"role": "system", "content": "Answer briefly."},
                         {"role": "user", "content": "Why is the sky blue?"}],
            "max_tokens": 32, "temperature": 0})
        assert status == 200, f"qwen3 serve chat: HTTP {status} {raw[:200]!r}"
        chat = json.loads(raw)
        assert chat["usage"]["completion_tokens"] > 0
        status, raw = http(url + "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "Tell me about rivers."}],
            "max_tokens": 16, "temperature": 0, "stream": True})
        assert status == 200
        events = sse_events(raw)
        assert events[-1]["choices"][0]["finish_reason"] in ("stop", "length")
        status, raw = http(url + "/v1/completions", {"prompt": "The printing press",
                                                     "max_tokens": 16})
        assert status == 200 and json.loads(raw)["object"] == "text_completion"
    finally:
        restore()
        srv.shutdown()
        srv.server_close()
    launches = {k: f.launches for k, f in fns.items()}
    fwd = fw["chunks"] + fw["steps"]
    want = {k: 0 for k in fns}
    want.update(block_matmul=(6 * L + 1) * fwd, decode_attention_fused_write=L * fw["steps"])
    assert launches == want, f"qwen3 serve: {launches} != {want} ({fw})"
    res = dict(requests=3, seconds=time.perf_counter() - t0, launches=launches, **fw,
               chat_tokens=chat["usage"]["completion_tokens"], stream_events=len(events))
    log(f"qwen3_q4km_serve: 3 HTTP requests in {res['seconds']:.1f} s, {fw['chunks']} chunks + "
        f"{fw['steps']} steps, launches {launches}")
    del svc, model
    return res


def run_family_runs(dev, workdir: Path) -> dict:
    """`cli run` on the tiny Q8_0 GGUF of each of the five families of slice
    22 (tiny_family_gguf: tests/tiny_models.py's files): exit 0 and streamed
    text, DeepSeek's opening with its <think> primer; K5 on every projection
    and the head, K6 per layer and step."""
    from llamatpu_torch.gguf.ggml_type import GGMLType

    out = {}
    for fam in TINY_FAMILIES:
        path = workdir / f"tiny-{fam}-q8_0.gguf"
        tiny_family_gguf(path, fam, GGMLType.Q8_0)
        res = cli_run(dev, path)
        fwd = res["chunks"] + res["steps"]
        want = {k: 0 for k in res["launches"]}
        want.update(block_matmul=(4 * 2 + 1) * fwd, decode_attention_fused_write=2 * res["steps"])
        assert res["launches"] == want, f"{fam} cli run: {res['launches']} != {want}"
        if fam == "deepseek":
            assert res["text"].startswith("<think>\n"), f"deepseek: {res['text']!r}"
        log(f"family {fam}: cli run rc 0 in {res['seconds']:.1f} s, {res['chunks']} chunks + "
            f"{res['steps']} steps, {res['chars']} chars: {res['text']!r}")
        out[f"family_{fam}"] = res
        path.unlink()
    return out


# ------------------------------------------------------------ slice 23
INT8_T = (1, 8, 16)
# the kernel's edges (T, O, I, experts E or 0): I = 32 (one block), O not a
# multiple of the CTA's 8 rows, widths past one warp pass of 16 blocks that
# are not multiples of it, grouped rows (each its own expert) past 16
INT8_EDGES = ((1, 40, 32, 0), (16, 1003, 2080, 0), (5, 777, 1408, 0), (20, 300, 2048, 6),
              (64, 2816, 2048, 8))


def int8_case(t: int, o: int, i: int, dev, gen, e: int = 0):
    """Q8_0 values [O, I] (or [E, O, I]) and f32 block scales whose products
    keep unit variance, and x [T, I] f32 with (T > 2) an all-zero row and a
    block whose scale d = amax / 127 is f16-subnormal."""
    import torch

    shape = (e, o, i) if e else (o, i)
    qs = torch.randint(-127, 128, shape, dtype=torch.int8, device=dev, generator=gen)
    s = torch.rand((*shape[:-1], i // 32), device=dev, generator=gen) * 0.001 + 0.0005
    x = torch.randn((t, i), device=dev, generator=gen)
    if t > 2:
        x[1] = 0.0
        x[2, :32] *= 1e-4
    return qs, s, x


def int8_exact_case(t: int, o: int, i: int, dev, gen):
    """A case whose result is exact under any summation order: each block of
    x is integers in [-127, 127] with one 127, times 2^k of its row (so d and
    its f16 round are 2^k), the weights integers in [-15, 15] with one
    power-of-two scale a row: every block sum, scale product and partial sum
    is an integer times 2^(j + k) below 2^24."""
    import torch

    nb = i // 32
    xq = torch.randint(-127, 128, (t, nb, 32), device=dev, generator=gen).float()
    xq[:, :, 0] = 127.0
    k = torch.randint(-6, 4, (t, 1, 1), device=dev, generator=gen).float()
    x = (xq * torch.exp2(k)).reshape(t, i)
    qs = torch.randint(-15, 16, (o, i), dtype=torch.int8, device=dev, generator=gen)
    j = torch.randint(-12, -4, (o, 1), device=dev, generator=gen).float()
    return qs, torch.exp2(j).expand(o, nb).contiguous(), x


def int8_bytes(t: int, o: int, i: int, xbytes: int) -> int:
    """The bytes the dot must move: the int8 values and f32 block scales once
    (K5's bytes for the same weight), x in and y out."""
    return o * i + o * (i // 32) * 4 + t * i * xbytes + t * o * 4


def check_int8_dot(dev, dims=LLAMA32_1B) -> dict:
    """The exact int8 mode's kernel (ops/int8_matmul.int8_dot,
    csrc/int8_matmul.cu) against `quant_matmul_int8_ref` on the card: the
    five Llama-3.2-1B projections at T = 1, 8, 16 in bf16 and f32 x and
    INT8_EDGES (grouped rows against `int8_dot_plain`), max|d| <= 1e-5 *
    max|y| (the two sum the blocks in other orders), two runs bit-equal; the
    exact case bit-equal at wqkv and w2 in both dtypes. Timed in bf16 (the
    Q8_0 GGUF's activations) beside the plain version, the bound (bytes) and
    bf16 torch.matmul on the dequantized weight (a yardstick: no PyTorch call
    computes a block-scaled int8 dot). The row is one decode token at T = 1:
    16 layers' four projections + the head (65 calls)."""
    import torch

    from llamatpu_torch.ops import int8_matmul as im
    from llamatpu_torch.ops.quant_matmul import dequant_blocks

    gen = torch.Generator(device=dev).manual_seed(23)
    L = dims["L"]
    per, worst, abs_max = {}, [0.0], [0.0]
    tot = dict(ms=0.0, plain_ms=0.0, yardstick_ms=0.0, bound_ms=0.0, wrapper_ms=0.0)

    def hold(got, again, want, label):
        torch.cuda.synchronize()
        a, r = max_err(got, want)
        assert r <= 1e-5, f"int8_dot {label}: max abs {a} rel {r}"
        assert torch.equal(got, again), f"int8_dot {label}: two runs differ"
        assert bool(torch.isfinite(got).all()), f"int8_dot {label}: non-finite output"
        worst[0], abs_max[0] = max(worst[0], r), max(abs_max[0], a)
        return r

    for name, (o, i) in block_shapes(dims).items():
        qs, s, _ = int8_case(1, o, i, dev, gen)
        w_bf = dequant_blocks(qs, s, torch.bfloat16)
        for t in INT8_T:
            for dt in (torch.bfloat16, torch.float32):
                x = int8_case(t, 1, i, dev, gen)[2].to(dt)
                hold(im.int8_dot(x, qs, s), im.int8_dot(x, qs, s),
                     im.quant_matmul_int8_ref(x, qs, s), f"{name} T={t} {dt}")
            xb = torch.randn((t, i), device=dev, generator=gen).to(torch.bfloat16)
            b_ms, b_by = bound(int8_bytes(t, o, i, 2), 2 * t * o * i, INT8_OPS_S)
            tm = timings(lambda: im.int8_dot(xb, qs, s), INT8_NAMES,
                         lambda: im.quant_matmul_int8_ref(xb, qs, s),
                         lambda: torch.matmul(xb, w_bf.T), iters=4 if name == "head" else 16)
            tm["yardstick_ms"] = tm.pop("library_ms")
            per[f"{name} T={t}"] = dict(**tm, bound_ms=b_ms, bound_by=b_by,
                                        shape=f"T={t} O={o} I={i}")
            if t == 1:
                reps = 1 if name == "head" else L
                for k in tot:
                    tot[k] += reps * (b_ms if k == "bound_ms" else tm[k])
            log(f"int8_dot {name} T={t}: {tm['ms']:.4f} ms (bound {b_ms:.4f} by {b_by}, plain "
                f"{tm['plain_ms']:.4f}, bf16 matmul {tm['yardstick_ms']:.4f})")
        del qs, s, w_bf
        torch.cuda.empty_cache()
    exact = []
    for name in ("wqkv", "w2"):
        o, i = block_shapes(dims)[name]
        for dt in (torch.float32, torch.bfloat16):
            qs, s, x = int8_exact_case(16, o, i, dev, gen)
            got = im.int8_dot(x.to(dt), qs, s)
            want = im.quant_matmul_int8_ref(x.to(dt), qs, s)
            torch.cuda.synchronize()
            assert torch.equal(got, want), f"int8_dot exact {name} {dt}: {max_err(got, want)}"
            exact.append(f"{name} {str(dt)[6:]}")
    edges = {}
    for t, o, i, e in INT8_EDGES:
        qs, s, x = int8_case(t, o, i, dev, gen, e)
        ex = torch.randint(0, e, (t,), device=dev, generator=gen, dtype=torch.int32) if e \
            else None
        for dt in (torch.float32, torch.bfloat16):
            xd = x.to(dt)
            got, again = im.int8_dot(xd, qs, s, ex), im.int8_dot(xd, qs, s, ex)
            want = im.int8_dot_plain(xd, qs, s, ex)
            key = f"T={t} O={o} I={i} E={e} {str(dt)[6:]}"
            edges[key] = hold(got, again, want, f"edge {key}")
            if t > 2:
                assert not bool(got[1].any()), f"int8_dot {key}: an all-zero row gives y != 0"
    log(f"int8_dot: every shape and edge within rel 1e-5 (worst {worst[0]:.3g}), two runs "
        f"bit-equal, exact cases bit-equal {exact}; a decode token (65 calls) "
        f"{tot['ms']:.4f} ms, bound {tot['bound_ms']:.4f}, plain {tot['plain_ms']:.4f}, "
        f"bf16 matmul {tot['yardstick_ms']:.4f}")
    return dict(
        name="int8_dot", route="cuda", source="llamatpu_torch/csrc/int8_matmul.cu",
        replaces="llamatpu/ops/int8_matmul.py:44 (an XLA dot_general; no TPU kernel)",
        max_abs_err=abs_max[0], max_rel_err=worst[0],
        tolerance="max|d| <= 1e-5 * max|plain| at every shape, T and edge, bf16 and f32 x; "
                  "two runs bit-equal; the exact cases bit-equal",
        ms=tot["ms"], ms_source=per["wo T=1"]["ms_source"], wrapper_ms=tot["wrapper_ms"],
        plain_ms=tot["plain_ms"], library_ms=None, yardstick_ms=tot["yardstick_ms"],
        library="none (no PyTorch call computes a block-scaled int8 dot); yardstick_ms: bf16 "
                "torch.matmul on the dequantized weight",
        bound_ms=tot["bound_ms"], bound_by="bytes",
        shape=f"one decode token at T=1: {L} x (wqkv+wo+w13+w2) + head", per_shape=per,
        exact=exact, edges=edges)


# the prefill chunk rows at which q8_row weights take K1 in the int8 mode
# (ops/matmul.py: every T there, never K4's activation quantization)
K1_INT8_T = (128, 512)


def check_k1_int8_rows(dev, dims=LLAMA32_1B) -> dict:
    """K1 (rowq_gemv) at the rows the int8 mode gives it in a prefill chunk:
    Llama-3.2-1B's wqkv, wo, w13 and w2 as q8_row values at T = 128 and 512,
    bf16 and f32 x, within 1e-5 of the largest plain output (exact
    products, f32 sums in another order), two runs bit-equal. Timed in bf16
    in a CUDA graph beside its plain version, its bound and K4 (the auto
    mode's route: the activation rows quantized, then rowq_gemm) on the same
    weight and rows."""
    import torch

    from llamatpu_torch.ops import gemm, quant_matmul
    from llamatpu_torch.ops.int8_prefill import quantize_activation_rows

    gen = torch.Generator(device=dev).manual_seed(29)
    per, worst = {}, 0.0
    for name, (o, i) in block_shapes(dims).items():
        if name == "head":  # a prefill chunk's head takes its last row alone
            continue
        qs = torch.randint(-127, 128, (o, i), dtype=torch.int8, device=dev, generator=gen)
        scales = torch.rand((o, 1), device=dev, generator=gen) * 1e-2 + 1e-3
        for t in K1_INT8_T:
            for dt in (torch.bfloat16, torch.float32):
                x = torch.randn((t, i), device=dev, generator=gen).to(dt)
                got, again = quant_matmul.rowq_gemv(x, qs), quant_matmul.rowq_gemv(x, qs)
                want = quant_matmul.rowq_gemv_plain(x, qs)
                torch.cuda.synchronize()
                assert torch.equal(got, again), f"K1 int8 rows {name} T={t} {dt}: two runs differ"
                abs_e, rel_e = max_err(got, want)
                assert rel_e <= 1e-5, f"K1 int8 rows {name} T={t} {dt}: max abs {abs_e} rel {rel_e}"
                worst = max(worst, rel_e)
            xb = torch.randn((t, i), device=dev, generator=gen).to(torch.bfloat16)
            b_ms, b_by = bound(o * i + t * i * 2 + t * o * 4, 2 * t * o * i, BF16_OPS_S)

            def k4(xb=xb):
                xi8, ax = quantize_activation_rows(xb)
                return gemm.rowq_gemm(qs, scales, xi8, ax)
            r = dict(ms=time_ms(lambda xb=xb: quant_matmul.rowq_gemv(xb, qs), iters=8),
                     plain_ms=time_ms(lambda xb=xb: quant_matmul.rowq_gemv_plain(xb, qs), iters=4),
                     k4_ms=time_ms(k4, iters=8), bound_ms=b_ms, bound_by=b_by,
                     shape=f"T={t} O={o} I={i}")
            per[f"{name} T={t}"] = r
            log(f"K1 int8-mode rows {name} T={t}: {r['ms']:.4f} ms (bound {b_ms:.4f} by {b_by}, "
                f"plain {r['plain_ms']:.4f}, K4 on the same rows {r['k4_ms']:.4f})")
        del qs, scales
    log(f"K1 int8-mode rows: every shape at T = {K1_INT8_T}, bf16 and f32, within rel 1e-5 "
        f"(worst {worst:.3g}), two runs bit-equal")
    return dict(worst_rel=worst, per_shape=per)


def moe_int8_hold(dev, n_layers: int = 2, overrides=None) -> dict:
    """Qwen1.5-MoE-A2.7B at full width and 2 layers (synthetic Q8_0, f32
    activations), int8 mode: a 16-token prefill and 4 decode steps through
    the kernel (each layer's (token, slot) expert rows in grouped calls):
    - every int8_dot call of that run against its plain version on the same
      inputs, max|d| <= 1e-5 * max|y|;
    - the logits against the same forwards with int8_dot's plain version
      throughout, max|d| <= 5e-2 * max|logit|: the two sum the blocks in
      other orders, and a 1-ulp difference moves an activation's int8
      rounding by a step, which the later layers carry (0.6-1.3e-2
      measured on the H100); a fault would differ by the logits' size;
    - a 128-token prefill chunk traced in int8 and in auto mode (device
      busy ms, wall ms, the top kernels)."""
    import numpy as np
    import torch

    from llamatpu_torch.models import transformer as tr
    from llamatpu_torch.models.synthetic import build_synthetic_model
    from llamatpu_torch.ops import int8_matmul as im
    from llamatpu_torch.runtime.engine import Engine

    t0 = time.perf_counter()
    model = build_synthetic_model("qwen15-moe-a2.7b", quant="q8_0", seed=0, dtype="f32",
                                  context_length=1024, n_layers=n_layers, overrides=overrides)
    engine = Engine(model, cache_len=256, prefill_chunk=16, cache_dtype=torch.float32,
                    impl="int8", device=dev, aot_compile=False)
    assert "gu_exps" in engine.weights["layers"], "moe int8: the stacks did not fold and fuse"
    prompt = np.random.default_rng(7).integers(0, model.cfg.vocab_size, 16).tolist()

    def forwards():
        engine.reset()
        logits, _ = tr.forward_tokens(engine.cfg, engine.weights,
                                      torch.tensor([prompt], device=dev), engine.cache, 0,
                                      s_limit=256, impl="int8")
        outs = [logits[0, -1]]
        for s in range(4):
            tok = int(outs[-1].argmax())
            lg, _ = tr.forward_tokens(engine.cfg, engine.weights,
                                      torch.tensor([[tok]], device=dev), engine.cache, 16 + s,
                                      last_logit_only=True, s_limit=256, impl="int8")
            outs.append(lg[0])
        torch.cuda.synchronize()
        return torch.stack(outs)

    kernel, calls = im.int8_dot, []

    def held(x2, qs, scales, experts=None):
        """The kernel, and its plain version on the same inputs; the kernel's
        body counts its launch on the name it is called by, this one."""
        y = kernel(x2, qs, scales, experts)
        calls.append(max_err(y, im.int8_dot_plain(x2, qs, scales, experts))[1])
        return y

    def using(fn):
        im.int8_dot = tr.int8_dot = fn
        try:
            return forwards()
        finally:
            im.int8_dot = tr.int8_dot = kernel

    held.launches = 0
    got = using(held)
    launches = held.launches
    want = using(im.int8_dot_plain)
    rel = [max_err(g, w)[1] for g, w in zip(got, want)]
    L = model.cfg.n_layers
    # a forward: wqkv and wo (dense), gate+up and down (grouped) a layer, the head
    assert launches == len(calls) == 5 * (4 * L + 1), f"moe int8: {launches} launches"
    assert max(calls) <= 1e-5, f"moe int8: a call against its plain version: {max(calls)}"
    assert max(rel) <= 5e-2, f"moe int8: logits kernel vs plain rel {rel}"
    top1 = [int(g.argmax()) == int(w.argmax()) for g, w in zip(got, want)]
    # a 128-token prefill chunk in int8 mode (every (token, slot) row in the
    # grouped int8 dot) beside the auto mode's (the grouped Q8_0 kernels)
    chunk = torch.tensor([np.random.default_rng(8).integers(0, 32000, 128).tolist()],
                         device=dev)
    chunk_tr, chunk_launches = {}, 0
    for impl in ("int8", "auto"):
        def fwd(impl=impl):
            return tr.forward_tokens(engine.cfg, engine.weights, chunk, engine.cache, 0,
                                     last_logit_only=True, s_limit=256, impl=impl)
        fwd()
        torch.cuda.synchronize()
        if impl == "int8":
            im.int8_dot.launches = 0
            fwd()
            chunk_launches = im.int8_dot.launches
        t = device_breakdown(fwd)
        chunk_tr[impl] = dict(busy_ms=t["busy_ms"], wall_ms=t["wall_ms"],
                              idle_share=t["idle_share"], top=t["kernels"][:3])
    # 128 rows: wqkv and wo take K5 (above 16 rows), the grouped gate+up and
    # down the int8 dot (no row limit), the head its last row
    assert chunk_launches == 2 * L + 1, f"moe int8 chunk: {chunk_launches} int8_dot launches"
    log(f"moe int8: a 128-token prefill chunk at {L} layers, traced: int8 mode busy "
        f"{chunk_tr['int8']['busy_ms']:.3f} of {chunk_tr['int8']['wall_ms']:.3f} ms (top "
        f"{[(k['name'][:40], round(k['ms'], 3)) for k in chunk_tr['int8']['top']]}), auto mode "
        f"busy {chunk_tr['auto']['busy_ms']:.3f} of {chunk_tr['auto']['wall_ms']:.3f} ms")
    log(f"moe int8: {L} layers, prefill 16 + 4 steps ({time.perf_counter() - t0:.1f} s with the "
        f"build): {len(calls)} int8_dot calls each within rel {max(calls):.2g} of the plain "
        f"version; logits against the plain forwards rel {[f'{r:.2g}' for r in rel]}, argmax "
        f"agree {top1}")
    del engine, model
    torch.cuda.empty_cache()
    return dict(calls=len(calls), calls_rel=max(calls), logits_rel=rel, argmax_agree=top1,
                int8_dot_launches=launches, prefill128=chunk_tr)


def cli_json(argv) -> dict:
    """The port's CLI in-process; the last line of its stdout as JSON."""
    import contextlib
    import io

    from llamatpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    assert rc == 0, f"cli {argv[0]}: rc {rc}, output {buf.getvalue()[:400]!r}"
    return dict(json.loads(buf.getvalue().strip().splitlines()[-1]),
                seconds=time.perf_counter() - t0)


def run_int8_paths(dev, gguf: Path, L: int = LLAMA32_1B["L"], overrides=None,
                   moe_overrides=None) -> dict:
    """Slice 23's paths, the exact int8 mode, on the full-width, full-depth
    Q8_0 GGUF of the gguf phase:
    - int8_cli: `cli run --impl int8` (int8_dot 65 a decode step; a
      128-row prompt chunk takes K5, the dequantised route above 16 rows,
      and its one-row head the int8 dot);
    - int8_ppl: `cli ppl --chunk 16` on one text, --impl int8 (int8_dot
      alone) beside --impl auto (K5 alone): both finite, within 4 % of each
      other (each Q8_0 path stays within 2 % of f32 in the parity phase);
    - int8: Engine(impl="int8"), pp512 (K5) + tg128 (int8_dot 65 a step,
      K6) as graph replays; a 16-step graph window equals the eager one and
      counts int8_dot 65 a step and no K5;
    - int8_batch: a 4-layer full-width Q8_0 BatchEngine at 8 lanes in int8
      mode (8 rows a step: int8_dot 17 a step), graph == eager;
    - int8_rowq: the same weights as q8_row in an int8-mode Engine: a
      512-row prefill chunk through K1 (17 launches, no K4), then a 16-step
      graph window == eager (K1 17 a step);
    - int8_moe: moe_int8_hold."""
    import numpy as np
    import torch

    from llamatpu_torch.models.loader import load_model
    from llamatpu_torch.models.synthetic import build_synthetic_model
    from llamatpu_torch.runtime.batch_engine import BatchEngine
    from llamatpu_torch.runtime.engine import Engine

    out = {}
    res = cli_run(dev, gguf, ("--impl", "int8"))
    want = {k: 0 for k in res["launches"]}
    # a prompt chunk's projections take K5 (more than 16 rows), its head the
    # int8 dot (one row: the logits of the last real token)
    want.update(int8_dot=(4 * L + 1) * res["steps"] + res["chunks"],
                block_matmul=4 * L * res["chunks"], decode_attention_fused_write=L * res["steps"])
    assert res["launches"] == want, f"int8_cli: {res['launches']} != {want}"
    log(f"int8_cli: cli run --impl int8 rc 0 in {res['seconds']:.1f} s, {res['chunks']} chunks "
        f"+ {res['steps']} steps, {res['chars']} chars: {res['text']!r}")
    out["int8_cli"] = res
    ppl = {}
    fns = counters()
    for impl in ("int8", "auto"):
        for f in fns.values():
            f.launches = 0
        r = cli_json(["ppl", "-m", str(gguf), "--device", str(dev), "--text", PPL_TEXT,
                      "--chunk", "16", "--impl", impl])
        r["launches"] = {k: f.launches for k, f in fns.items() if f.launches}
        assert r["tokens"] > 64 and 1.0 < r["ppl"] < float("inf"), r
        only = "int8_dot" if impl == "int8" else "block_matmul"
        assert set(r["launches"]) == {only}, f"ppl --impl {impl}: {r['launches']}"
        ppl[impl] = r
    rel = abs(ppl["int8"]["ppl"] - ppl["auto"]["ppl"]) / ppl["auto"]["ppl"]
    assert ppl["int8"]["tokens"] == ppl["auto"]["tokens"] and rel < 0.04, ppl
    out["int8_ppl"] = dict(ppl, rel=rel)
    log(f"int8_ppl: --chunk 16 --impl int8 {ppl['int8']['ppl']} against --impl auto "
        f"{ppl['auto']['ppl']} (rel {rel:.4f}) over {ppl['int8']['tokens']} tokens, launches "
        f"{ppl['int8']['launches']} / {ppl['auto']['launches']}")
    model = load_model(str(gguf), max_tokens=1024)
    engine = Engine(model, cache_len=1024, prefill_chunk=512, decode_window=128, impl="int8",
                    device=dev)
    prompt = np.random.default_rng(42).integers(0, 128000, 512).tolist()
    out["int8"] = drive_engine(engine, prompt, 128, lambda n: {
        "int8_dot": (4 * L + 1) * n + 1, "block_matmul": 4 * L,
        "decode_attention_fused_write": L * n}, "int8")
    g = out["int8"]["graph"] = graph_decode(engine, "int8")
    # the 16-step window as graph replays: int8_dot 4 L + 1 a step, no K5 at T = 1
    assert g["greedy"]["launches"] == {"int8_dot": (4 * L + 1) * 16,
                                       "decode_attention_fused_write": L * 16}, g["greedy"]
    del engine, model
    torch.cuda.empty_cache()
    model = build_synthetic_model("llama32-1b", quant="q8_0", context_length=1024, n_layers=4,
                                  overrides=overrides)
    engine = BatchEngine(model, batch_size=8, cache_len=1024, prefill_chunk=128,
                         decode_window=16, impl="int8", device=dev)
    g = graph_decode(engine, "int8_batch")
    assert g["greedy"]["launches"]["int8_dot"] == 17 * 16, g["greedy"]["launches"]
    out["int8_batch"] = dict(graph=g)
    del engine
    torch.cuda.empty_cache()
    out["int8_rowq"] = run_int8_rowq(dev, model)
    del model
    out["int8_moe"] = moe_int8_hold(dev, overrides=moe_overrides)
    return out


def run_int8_rowq(dev, model) -> dict:
    """`model`'s Q8_0 weights as q8_row in an int8-mode Engine, where q8_row
    takes K1 at every row count and never K4: a 512-row prefill chunk counts
    K1 for each projection and the head's last row and nothing else, then a
    16-step graph window equals the eager one, K1 4 L + 1 a step."""
    import numpy as np
    import torch

    from llamatpu_torch.runtime.engine import Engine

    engine = Engine(model, cache_len=1024, prefill_chunk=512, decode_window=16, rowq=True,
                    impl="int8", device=dev)
    fns = counters()
    for f in fns.values():
        f.launches = 0
    tok, logits = engine.prefill(np.random.default_rng(43).integers(0, 128000, 512).tolist(), 0)
    launches = {k: f.launches for k, f in fns.items() if f.launches}
    nl = model.cfg.n_layers
    assert launches == {"rowq_gemv": 4 * nl + 1}, f"int8_rowq prefill: {launches}"
    assert bool(torch.isfinite(logits).all()), "int8_rowq prefill: non-finite logits"
    g = graph_decode(engine, "int8_rowq", start=(int(tok[0]), 512))
    assert g["greedy"]["launches"] == {"rowq_gemv": (4 * nl + 1) * 16,
                                       "decode_attention_fused_write": nl * 16}, g["greedy"]
    log(f"int8_rowq: {nl}-layer q8_row Engine in int8 mode, a 512-row chunk {launches}, "
        f"graph == eager, a window {g['greedy']['launches']}")
    del engine
    torch.cuda.empty_cache()
    return dict(launches=launches, graph=g)


# the parity phase: Llama-3.2-1B width (vocab 128256 too) at 2 of its 16
# layers (a depth cut for time), corpus 128, tests/test_parity_gate.py's bounds
PARITY_VARIANTS = ("f32", "bf16", "q8_0", "q8_0-int8dot", "q8_0-kvint8", "q8_row", "q4_0")
PARITY_BOUNDS = {"bf16": 0.02, "q8_0": 0.02, "q8_0-int8dot": 0.02, "q8_0-kvint8": 0.03,
                 "q8_row": 0.05, "q4_0": 0.6}


def run_parity_path(dev) -> dict:
    """bench/parity.py's table on the card: the dense f32 master at
    Llama-3.2-1B width and 2 layers, its own 128-token sample as the corpus,
    PARITY_VARIANTS scored at chunk 16 (q8_0-int8dot through int8_dot),
    every |rel| inside PARITY_BOUNDS, every variant scoring the whole
    corpus."""
    from llamatpu_torch.bench import parity
    from llamatpu_torch.ops import int8_matmul as im

    t0 = time.perf_counter()
    im.int8_dot.launches = 0
    rows = parity.parity_table("llama32-1b", corpus_len=128, cache_len=128, seed=0,
                               variants=PARITY_VARIANTS, device=dev, n_layers=2)
    for r in rows:
        log(f"parity: {r['variant']:13s} ppl {r['ppl']:.4f} delta {r['delta']:+.4f} "
            f"rel {r['rel']:+.4%} tokens {r['tokens']} ({r['seconds']:.1f} s)")
    assert len({r["tokens"] for r in rows}) == 1, rows
    for r in rows:
        if r["variant"] in PARITY_BOUNDS:
            assert abs(r["rel"]) < PARITY_BOUNDS[r["variant"]], f"parity: {r}"
    assert im.int8_dot.launches > 0, "parity: q8_0-int8dot launched no int8_dot"
    res = dict(rows=rows, seconds=time.perf_counter() - t0, int8_dot=im.int8_dot.launches)
    log(f"parity: {len(rows)} variants within tests/test_parity_gate.py's bounds in "
        f"{res['seconds']:.1f} s ({im.int8_dot.launches} int8_dot launches)")
    return res


def native_loads(path: Path) -> dict:
    """A GGUF loaded with the native codecs and with the numpy ones
    (LLAMATPU_NO_NATIVE=1): each load's seconds and native calls; the two
    trees' head and embedding equal."""
    import numpy as np
    import torch

    from llamatpu_torch.gguf import native
    from llamatpu_torch.models.loader import load_model
    from llamatpu_torch.models.weights import QTensor

    assert native.available(), "the native codecs are not serving"
    res, trees = {}, {}
    for label, env in (("native", None), ("numpy", "1")):
        if env:
            os.environ["LLAMATPU_NO_NATIVE"] = env
        calls = native.calls
        t0 = time.perf_counter()
        try:
            trees[label] = load_model(str(path), max_tokens=1024).weights
        finally:
            os.environ.pop("LLAMATPU_NO_NATIVE", None)
        res[f"{label}_s"] = time.perf_counter() - t0
        res[f"{label}_calls"] = native.calls - calls
    assert res["native_calls"] > 0 and res["numpy_calls"] == 0, res

    def arr(a):
        return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    for key in ("wcls", "tok_emb"):
        a, b = trees["native"][key], trees["numpy"][key]
        if isinstance(a, QTensor):
            assert np.array_equal(arr(a.qs), arr(b.qs)) and \
                np.array_equal(arr(a.scales), arr(b.scales)), key
        else:
            assert np.array_equal(arr(a), arr(b)), key
    log(f"native: {path.name} loads in {res['native_s']:.2f} s with the native codecs "
        f"({res['native_calls']} calls) against {res['numpy_s']:.2f} s with LLAMATPU_NO_NATIVE=1;"
        f" the head and the embedding equal")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log-dir", default=None, help="write the ptxas report and results here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from llamatpu_torch import _build

    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
        LOG_FILES.append(open(os.path.join(args.log_dir, "smoke.log"), "w"))
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"device: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    summary = {"card": smi}
    t0 = time.perf_counter()
    logs = _build.build(verbose=args.log_dir is not None)  # one nvcc per source, in parallel
    summary["build_s"] = time.perf_counter() - t0
    log(f"build: {len(logs)} of {len(_build.SOURCES)} sources compiled in "
        f"{summary['build_s']:.1f} s")
    if args.log_dir:
        with open(os.path.join(args.log_dir, "ptxas.txt"), "w") as f:
            for name, text in logs.items():
                f.write(f"==== {name}\n{text}\n")
    workdir = Path(__file__).resolve().parent / "build" / "smoke"
    workdir.mkdir(parents=True, exist_ok=True)
    try:
        rows = check_kernels(dev) + check_block_kernels(dev) + check_serving_kernels(dev) \
            + check_moe_kernels(dev) + check_long_kernels(dev) + check_slice6_kernels(dev) \
            + [check_ffn_fused(dev), check_int8_dot(dev)]
        next(r for r in rows if r["name"] == "rowq_gemv")["int8_mode_rows"] = \
            check_k1_int8_rows(dev)
        edges = check_moe_edges(dev)
        for r in rows:
            if r["name"].startswith("grouped_"):
                r["edges"] = edges
        for key, check in (("qwen15", check_qwen_geometry), ("phi3_medium", check_phi3_geometry)):
            for name, sub in check(dev).items():
                next(r for r in rows if r["name"] == name)[key] = sub
        for check in (check_family_kernels, check_kquant_kernels):  # slice 22's shapes
            for name, subs in check(dev).items():
                next(r for r in rows if r["name"] == name).setdefault("slice22", {}).update(subs)
        paths = run_moe_paths(dev, n_layers=6)  # a depth cut for the time limit
        paths.update(run_moe_gguf_paths(dev, workdir))
        cpu_moe = run_moe_cpu_and_dense(dev)
        paths["moe_dense"] = cpu_moe.pop("moe_dense")
        summary["cpu_moe"] = cpu_moe
        paths.update(run_main_and_long_paths(dev))
        paths["gguf"] = run_gguf_path(dev, workdir)
        gguf = workdir / paths["gguf"]["gguf_file"]  # written by the gguf phase
        summary["tools"] = run_tool_paths(dev, gguf, workdir)
        paths["serve"] = run_serving_path(dev, gguf, rowq=False, latency=True)
        paths["serve_rowq"] = run_serving_path(dev, gguf, rowq=True, latency=False)
        paths.update(run_int8_serving_paths(dev, gguf))
        paths.update(run_int8_paths(dev, gguf))
        gguf.unlink()
        paths["pack4"] = run_pack4_path(dev, workdir)
        paths["dense_batch"] = run_dense_batch_path(dev)
        paths.update(run_phi3_paths(dev, n_layers=20))  # a depth cut for the time limit
        paths.update(run_phi3_gguf_paths(dev, workdir))
        paths.update(run_qwen3_paths(dev, workdir))
        paths.update(run_family_runs(dev, workdir))
        summary["parity"] = run_parity_path(dev)
        harness = run_harness_paths(dev)
        summary["harness"] = harness
        summary.update(paths)
        for r in rows:
            if r["name"] in SLICE6:  # the harness that drives the kernel
                r["launches"] = harness[SLICE6[r["name"]][0]]["launches"][r["name"]]
                r["in_path_ms"] = slice6_in_path_ms(harness, r["name"])
                assert r["launches"] > 0, f"{r['name']}: no launch in its harness"
                continue
            if r["name"] in ROW_WRAPPERS:  # every launch of the kernel's wrappers on the paths
                r["launches"] = sum(p["launches"].get(n, 0) for p in paths.values()
                                    if "launches" in p for n in ROW_WRAPPERS[r["name"]])
            else:
                r["launches"] = paths[IN_PATH[r["name"]][0]]["launches"][r["name"]]
            r["in_path_ms"] = in_path_ms(paths, r["name"])
            if r["name"] == "rowq_gemm":  # K4 a layer in Phi-3-medium's 128-token prefill
                r["phi3_in_path_ms"] = in_path_ms(paths, "rowq_gemm", "phi3_b1")
                log(f"K4 in path, a layer: {r['in_path_ms']:.4f} ms in the main path's "
                    f"{LLAMA32_1B['T']}-row chunk, {r['phi3_in_path_ms']:.4f} ms in "
                    "Phi-3-medium's 128-token prefill")
            if r["name"] == "decode_attention_fused_write":  # K6 in Phi-3-medium at one lane
                r["phi3_in_path_ms"] = in_path_ms(paths, r["name"], "phi3_b1")
                log(f"K6 in path, a layer and step: {r['in_path_ms']:.5f} ms in the Q8_0 GGUF "
                    f"window, {r['phi3_in_path_ms']:.5f} ms in Phi-3-medium's at one lane")
            if r["name"] == "layer_tail_fused_rowq":  # K3's tail at T = 1, beside K9's
                r["k3_in_path_ms"] = in_path_ms(paths, "layer_attn_tail_fused_rowq")
        summary["cpu"] = run_cpu_compare(dev, workdir)
        summary["graph_decode"] = graph_table(paths)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        while LOG_FILES:
            LOG_FILES.pop().close()
    if args.log_dir:
        with open(os.path.join(args.log_dir, "chip_smoke.json"), "w") as f:
            json.dump({"kernels": rows, **summary}, f, indent=1)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
