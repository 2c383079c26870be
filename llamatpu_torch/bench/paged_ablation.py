"""What bounds the single-launch cluster attention of csrc/attention.cu on
the card, K8 and K8-int8 (`paged_cluster_kernel`) and K6 and K6-int8
(`dense_cluster_kernel`, the same body over a dense stripe with the fused
row write): the kernels as built beside copies of them with one piece taken
out, at every cluster size, and where the time of one CTA goes.

    python -m llamatpu_torch.bench.paged_ablation     # the card; one JSON row a variant

Each variant is csrc/attention.cu with a few statements of the shared body
replaced (VARIANTS), built by nvcc into build/ablation/ and called through
its own `lt_paged_attention` / `lt_dense_attention` under ops/attention.py's
plans, the cluster size forced to 1, 2, 4 and 8. K8's shape is the serving
path's at 8 lanes and pos 512 on Llama-3.2-1B (KV 8, G 4, hd 64, block 16,
tables of 128 blocks over a shuffled pool of 512); K6's is the same
geometry at B = 1 and 8 lanes at pos 512 of a 1152-row cache (the dense
engine's at cache 1024). Both bf16 and int8. Every variant that still
attends is held to the plain version within 1e-5 of its largest output.
Times as bench/roofline.py takes them (a CUDA graph replayed between CUDA
events, best of 3) over 16 calls a graph, per call, in two rounds of
alternating order.

The "no stages" variant keeps the launch, the setup, K6's first copy
(issued before pos is read, and waited for) and both combines. The "phase
clocks" variant also records, for each rank of the cluster of lane 0 and
KV head 0, the SM clock (cycles since the CTA started) at each phase:
setup done (pos, the table entries and q loaded; K6: the row written) and
within it the barriers initialised, K6's first copy issued, q loaded and
pos known; every consumer warp's first stage arrived and its last stage
done, the warps combined, the rank's state pushed into rank 0, the end.
Needs the card and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from llamatpu_torch import _build
from llamatpu_torch.bench import roofline
from llamatpu_torch.ops import attention
from llamatpu_torch.ops.kv_quant import quantize_kv

STAGES = ("  const int nstages = nu > static_cast<int>(rank) ? "
          "(nu - static_cast<int>(rank) + C - 1) / C : 0;")
CONSUME = "      // row r: q . k for every head"
K8_SECTION = "// ------------------------------------------------------------------ K8\n"
WALK_SECTION = "// The walk kernel's pass 1 (K14, K15)."
CONSUMED = "      __syncwarp();  // the stage and pw are read: both free for the next"
OUT = ("    out[i] = valid ? __fdividef(num, den) : __int_as_float(0x7fc00000);"
       "  // no row attended: NaN\n  }\n")

# phase marks: (statement the mark follows or precedes, mark index, before?)
MARKS = (
    ("\n  if (warp == kPagedWarps) {\n    // the producer warp", 1, True),   # setup done
    ("    mbar_wait(&full[slot], phase);\n", 2, False),                    # a stage arrived
    ("  // this warp's state (l summed over its lanes)", 3, True),           # last stage done
    ("  // the combine: every rank with rows but 0", 4, True),               # warps combined
    ("    if (tid == 0) mbar_arrive_rank(&pushed, 0);", 5, True),            # state pushed
    ("      if (first_ahead) {\n", 6, True),                                # barriers initialised
    ("\n    if constexpr (!DENSE) {\n#pragma unroll\n      for (int u = 0; u < kTblCache / 32; "
     "++u) tbl", 7, True),                                                  # (K6) first copy issued
    ("  static_assert(kMaxW <= kPagedThreads", 8, True),                    # q loaded
    ("  if (C > 1) cluster_arrive_relaxed();", 9, True),                     # pos known
)
N_MARKS = 11  # the last: rank 0's end
CALLS = 16   # calls a CUDA graph: a call's time without the graph's launch


def _no_stages(s: str) -> str:
    """No stage: launch, setup, the warps' and the ranks' combines alone."""
    return s.replace(STAGES, "  const int nstages = 0;")


def _no_compute(s: str) -> str:
    """Every stage streamed in and waited for, nothing computed on it."""
    return s.replace(CONSUME, "#if 0\n" + CONSUME).replace(CONSUMED, "#endif\n" + CONSUMED)


def _k8_only(edit):
    """The edit applied to the cluster kernels' part of the source alone (the
    walk kernel keeps its own)."""
    def apply(s: str) -> str:
        i, j = s.index(K8_SECTION), s.index(WALK_SECTION)
        return s[:i] + edit(s[i:j]) + s[j:]
    return apply


def _clocks(s: str) -> str:
    """Each phase's SM clock (since the CTA started) into g_marks[rank][warp]
    for the cluster of lane 0, KV head 0 (the last mark of a warp's phase
    wins: the first stage's arrival is kept with a min); `s` is K8's part."""
    s = s.replace("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;",
                  "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
                  "  const long long t_start = clock64();\n"
                  "  const bool marked = blockIdx.y == 0 && blockIdx.x < C && lane == 0;")
    for stmt, m, before in MARKS:
        mark = (f"  if (marked) g_marks[rank][warp][{m}] = "
                + ("min(g_marks[rank][warp][2], clock64() - t_start);\n" if m == 2
                   else "clock64() - t_start;\n"))
        assert s.count(stmt) == 1, stmt
        s = s.replace(stmt, mark + stmt if before else stmt + mark)
    assert s.count(OUT) == 1
    end = f"  if (marked) g_marks[rank][warp][{N_MARKS - 1}] = clock64() - t_start;\n"
    s = s.replace(OUT, OUT + end)
    head = ("__device__ long long g_marks[8][9][%d];\n" % N_MARKS)
    tail = ("}  // namespace\n\nLT_EXPORT int lt_paged_marks(void* dst) {\n"
            "  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_marks, sizeof(g_marks)));\n}\n"
            "LT_EXPORT int lt_paged_marks_reset() {\n"
            "  long long init[8][9][%d];\n"
            "  for (auto& r : init) for (auto& w : r) for (auto& v : w) v = 1LL << 60;\n"
            "  return static_cast<int>(cudaMemcpyToSymbol(g_marks, init, sizeof(init)));\n}\n"
            "\nnamespace {\n" % N_MARKS)
    return s.replace(K8_SECTION, K8_SECTION + head) + tail


# name: (source transform, still attends)
VARIANTS = {
    "as built": (lambda s: s, True),
    "no stages (launch, setup, combines)": (_k8_only(_no_stages), False),
    "no compute (the ring alone)": (_k8_only(_no_compute), False),
    "phase clocks": (_k8_only(_clocks), True),
}


def build(out_dir) -> dict:
    """{variant: ctypes library}, the variants compiled in parallel."""
    src = (_build.CSRC / "attention.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, (name, (edit, _)) in enumerate(VARIANTS.items()):
        text = edit(src)
        assert name == "as built" or text != src, f"variant {name!r} changed nothing"
        cu, so = out_dir / f"attention_{n}.cu", out_dir / f"attention_{n}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} failed to build:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in _build._SIGNATURES["attention"].items():
            getattr(lib, fn).argtypes = list(argtypes)
        libs[name] = lib
    return libs


def paged(lib, q, pool, spool, tables, pv, hd: int, cluster: int, sms: int) -> torch.Tensor:
    """ops/attention.py _paged_launch on the variant's library, cluster forced."""
    b, kvh, g, _ = q.shape
    bs, width = pool.shape[-2], pool.shape[-1]
    plan = attention.plan_paged(b, kvh, tables.shape[1], width, pool.element_size(), sms)
    out = torch.empty((b, kvh, g, width - hd), dtype=torch.float32, device=q.device)
    err = lib.lt_paged_attention(
        q.data_ptr(), _build.dtype_code(q), pool.data_ptr(), attention.CACHE_CODES[pool.dtype],
        None if spool is None else spool.data_ptr(), tables.data_ptr(), pv.data_ptr(), b, kvh, g,
        pool.shape[0], bs.bit_length() - 1, tables.shape[1], hd, width - hd, hd ** -0.5,
        out.data_ptr(), cluster, plan.rows, _build.stream())
    _build.check(lib, err, "paged ablation")
    return out


def dense(lib, q, kvn, sn, kvc, sc, pv, hd: int, cluster: int, sms: int) -> torch.Tensor:
    """ops/attention.py _dense_launch on the variant's library (one layer's
    cache [B, KV, S, W]), cluster forced."""
    b, kvh, g, _ = q.shape
    s_len, width = kvc.shape[-2], kvc.shape[-1]
    plan = attention.plan_dense(b, kvh, s_len, width, kvc.element_size(), sms)
    out = torch.empty((b, kvh, g, width - hd), dtype=torch.float32, device=q.device)
    err = lib.lt_dense_attention(
        q.data_ptr(), _build.dtype_code(q), kvn.data_ptr(), attention.CACHE_CODES[kvn.dtype],
        None if sn is None else sn.data_ptr(), kvc.data_ptr(), attention.CACHE_CODES[kvc.dtype],
        None if sc is None else sc.data_ptr(), pv.data_ptr(), b, kvh, g, s_len, hd, width - hd,
        hd ** -0.5, out.data_ptr(), cluster, plan.rows, _build.stream())
    _build.check(lib, err, "dense ablation")
    return out


def dense_inputs(dev, quant: bool, lanes: int, kvh=8, g=4, hd=64, s=1152, pos=512, seed=10):
    """q, this token's rows (and scales), one layer's cache [B, KV, S, W] (and
    scale rows [B, KV, 2, S]), pos: every lane at pos."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((lanes, kvh, s, 2 * hd), device=dev, generator=gen)
    new = torch.randn((lanes, kvh, 1, 2 * hd), device=dev, generator=gen)
    if quant:
        (k, ks), (v, vs) = quantize_kv(x[..., :hd]), quantize_kv(x[..., hd:])
        kvc, sc = torch.cat([k, v], dim=-1), torch.stack([ks, vs], dim=-2)
        (k, ks), (v, vs) = quantize_kv(new[..., :hd]), quantize_kv(new[..., hd:])
        kvn, sn = torch.cat([k, v], dim=-1)[:, :, 0], torch.stack([ks, vs], dim=-1)[:, :, 0]
    else:
        kvc, sc, kvn, sn = x.to(torch.bfloat16), None, new[:, :, 0].to(torch.bfloat16), None
    q = torch.randn((lanes, kvh, g, hd), device=dev, generator=gen).to(torch.bfloat16)
    pv = torch.full((lanes,), pos, dtype=torch.int32, device=dev)
    return q, kvn, sn, kvc, sc, pv


def inputs(dev, quant: bool, lanes=8, kvh=8, g=4, hd=64, bs=16, maxblk=128, pos=512, seed=9):
    """q, one layer's pool (and scale pool), tables of a shuffled pool, pos."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    nblk = lanes * maxblk // 2
    x = torch.randn((nblk, kvh, bs, 2 * hd), device=dev, generator=gen)
    if quant:
        (k, ks), (v, vs) = quantize_kv(x[..., :hd]), quantize_kv(x[..., hd:])
        pool, spool = torch.cat([k, v], dim=-1), torch.stack([ks, vs], dim=-2)
    else:
        pool, spool = x.to(torch.bfloat16), None
    perm = torch.randperm(nblk - 1, generator=torch.Generator().manual_seed(seed)).tolist()
    tables = torch.full((lanes, maxblk), nblk - 1, dtype=torch.int32)
    for b in range(lanes):
        for j in range(pos // bs + 1):
            tables[b, j] = perm.pop()
    q = torch.randn((lanes, kvh, g, hd), device=dev, generator=gen).to(torch.bfloat16)
    pv = torch.full((lanes,), pos, dtype=torch.int32, device=dev)
    return q, pool, spool, tables.to(dev), pv


def phase_cycles(lib, run, c: int) -> list[dict]:
    """One run of the "phase clocks" variant: each rank's phase clocks."""
    marks = torch.zeros((8, 9, N_MARKS), dtype=torch.int64)
    _build.check(lib, lib.lt_paged_marks_reset(), "marks")
    run()
    torch.cuda.synchronize()
    _build.check(lib, lib.lt_paged_marks(ctypes.c_void_p(marks.data_ptr())), "marks")
    m = marks[:c, :9].tolist()  # ranks x (8 consumer warps + producer) x marks
    unset = 1 << 60
    return [{"setup": m[r][0][1] if m[r][0][1] < unset else None,
             "first_stage": [w[2] if w[2] < unset else None for w in m[r][:8]],
             "warps_done": [w[3] if w[3] < unset else None for w in m[r][:8]],
             "combined": m[r][0][4] if m[r][0][4] < unset else None,
             "pushed": m[r][0][5] if r and m[r][0][5] < unset else None,
             "barriers_init": m[r][8][6] if m[r][8][6] < unset else None,
             "first_copy_issued": m[r][8][7] if m[r][8][7] < unset else None,
             "q_loaded": m[r][0][8] if m[r][0][8] < unset else None,
             "pos_known": m[r][0][9] if m[r][0][9] < unset else None,
             "end": m[r][0][N_MARKS - 1] if r == 0 else None} for r in range(c)]


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("paged_ablation times the card's kernels: no CUDA device")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    libs = build(_build.BUILD_DIR.parent / "ablation")
    device = torch.cuda.get_device_name(dev)
    hd = 64
    cases = []  # (kernel, kv, lanes, call(lib, c), plain output)
    for quant in (False, True):
        q, pool, spool, tables, pv = inputs(dev, quant)
        cases.append(("K8", quant, q.shape[0],
                      lambda lib, c, a=(q, pool, spool, tables, pv): paged(lib, *a, hd, c, sms),
                      attention.decode_attention_paged_plain(q, pool, tables, pv, hd ** -0.5, hd,
                                                             scale_pool=spool)))
        for lanes in (1, 8):
            q, kvn, sn, kvc, sc, pv = dense_inputs(dev, quant, lanes)
            if quant:
                want = attention.decode_attention_fused_write_q_plain(
                    q, kvn, sn, kvc[None].clone(), sc[None].clone(), pv, hd ** -0.5, 0, hd)[0]
            else:
                want = attention.decode_attention_fused_write_plain(
                    q, kvn, kvc[None].clone(), pv, hd ** -0.5, 0, hd)[0]
            cases.append(("K6", quant, lanes,
                          lambda lib, c, a=(q, kvn, sn, kvc, sc, pv): dense(lib, *a, hd, c, sms),
                          want))
    for rnd in range(2):
        names = list(VARIANTS) if rnd == 0 else list(reversed(VARIANTS))
        for name in names:
            lib, attends = libs[name], VARIANTS[name][1]
            for kernel, quant, lanes, call, want in cases:
                for c in (1, 2, 4, 8):
                    def run(lib=lib, c=c, call=call):
                        return call(lib, c)
                    err = None
                    if attends:
                        got = run()
                        torch.cuda.synchronize()
                        err = ((got - want).abs().max() / want.abs().max()).item()
                        assert err <= 1e-5, f"{kernel} {name}, cluster {c}: rel err {err}"
                    extra = {}
                    if name == "phase clocks":
                        extra["cycles"] = phase_cycles(lib, run, c)
                    ms = roofline.time_run(lambda run=run: [run() for _ in range(CALLS)], dev) \
                        * 1e3 / CALLS
                    print(json.dumps({"bench": "paged_ablation", "kernel": kernel,
                                      "variant": name, "kv": "int8" if quant else "bf16",
                                      "lanes": lanes, "cluster": c, "device": device, "ms": ms,
                                      "round": rnd, "max_rel_err": err, **extra}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
