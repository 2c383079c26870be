"""What bounds the single-launch cluster attention of csrc/attention.cu on
the card, K8 and K8-int8 (`paged_cluster_kernel`), K6 and K6-int8
(`dense_cluster_kernel`, the same body over a dense stripe with the fused
row write) and K14 / K15 (`stripe_cluster_kernel`, the same body over a
long stripe, P clusters a head): the kernels as built beside copies of them
with one piece taken out, at every cluster size (K14 / K15: at the plans in
STRIPE_PLANS), and where the time of one CTA goes.

    python -m llamatpu_torch.bench.paged_ablation     # the card; one JSON row a variant

Each variant is csrc/attention.cu with a few statements of the shared body
replaced (VARIANTS), built by nvcc into build/ablation/ and called through
its own `lt_paged_attention` / `lt_dense_attention` / `lt_stripe_attention`
under ops/attention.py's plans, the cluster size forced to 1, 2, 4 and 8.
K8's shape is the serving path's at 8 lanes and pos 512 on Llama-3.2-1B (KV
8, G 4, hd 64, block 16, tables of 128 blocks over a shuffled pool of 512);
K6's is the same geometry at B = 1 and 8 lanes at pos 512 of a 1152-row
cache (the dense engine's at cache 1024). Both bf16 and int8. K14 is the
32k path's fused call at pos 32767 of 33792 rows, bf16 and int8, K15 the
f32 path's at pos 3999 of s_use 4000 (4128 rows), B = 1. Every variant that
still attends is held to the plain version within 1e-5 of its largest
output.
Times as bench/roofline.py takes them (a CUDA graph replayed between CUDA
events, best of 3) over 16 calls a graph, per call, in two rounds of
alternating order.

The "no stages" variant keeps the launch, the setup, K6's first copy
(issued before pos is read, and waited for) and the combines. The "phase
clocks" variant also records, for each of the C P ranks of lane 0 and KV
head 0, the SM clock (cycles since the CTA started) at each phase: setup
done (pos, the table entries and q loaded; K6: the row written) and within
it the barriers initialised, K6's first copy issued, q loaded and pos
known; every consumer warp's first stage arrived and its last stage done,
the warps combined, the rank's state pushed into its cluster's rank 0, and
rank 0's end (K14 / K15: its ranks' states in, and the end of its
stripe_finish: the scratch, the counter and, in the last cluster to
arrive, the P states' combine). For K14 and K15 it also prints, from a
copy whose launchers query instead of launching (OCCUPANCY), the clusters of
1, 2, 4 and 8 CTAs at the planner's stage rows that fit the card at once.
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

STAGES = "  const int nstages = nu > gr ? (nu - gr + CP - 1) / CP : 0;"
CONSUME = "      // row r: q . k for every head"
K8_SECTION = "// ------------------------------------------------------------------ K8\n"
CLUSTER_END = "}  // namespace\n"  # the cluster kernels' part ends here, the exports follow
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
    (OUT, 10, False),                                                         # K6 / K8: rank 0's end
    ("    stripe_finish(sa, out, bh,", 11, True),                                # stripe: ranks in
    ("last_cluster);\n", 12, False),                                           # stripe: its end
)
N_MARKS = 13
MARK_RANKS = 32  # the head's ranks C P recorded at most
CALLS = 16   # calls a CUDA graph: a call's time without the graph's launch


def _no_stages(s: str) -> str:
    """No stage: launch, setup, the warps' and the ranks' combines alone."""
    return s.replace(STAGES, "  const int nstages = 0;")


def _no_compute(s: str) -> str:
    """Every stage streamed in and waited for, nothing computed on it."""
    return s.replace(CONSUME, "#if 0\n" + CONSUME).replace(CONSUMED, "#endif\n" + CONSUMED)


def _cluster_only(edit):
    """The edit applied to the cluster kernels' part of the source alone (the
    header note and the exported entry points keep theirs)."""
    def apply(s: str) -> str:
        i, j = s.index(K8_SECTION), s.index(CLUSTER_END)
        return s[:i] + edit(s[i:j]) + s[j:]
    return apply


def _clocks(s: str) -> str:
    """Each phase's SM clock (since the CTA started) into g_marks[gr][warp]
    for the head's ranks gr of lane 0, KV head 0 (the last mark of a warp's
    phase wins: the first stage's arrival is kept with a min); `s` is the
    cluster kernels' part."""
    tids = "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;"
    assert s.count(tids) == 1
    s = s.replace(tids, tids + "\n  const long long t_start = clock64();\n"
                  f"  const bool marked = blockIdx.y == 0 && blockIdx.x < CP && gr < {MARK_RANKS}"
                  " && lane == 0;")
    for stmt, m, before in MARKS:
        mark = (f"  if (marked) g_marks[gr][warp][{m}] = "
                + ("min(g_marks[gr][warp][2], clock64() - t_start);\n" if m == 2
                   else "clock64() - t_start;\n"))
        assert s.count(stmt) == 1, stmt
        s = s.replace(stmt, mark + stmt if before else stmt + mark)
    head = "__device__ long long g_marks[%d][9][%d];\n" % (MARK_RANKS, N_MARKS)
    tail = ("}  // namespace\n\nLT_EXPORT int lt_paged_marks(void* dst) {\n"
            "  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_marks, sizeof(g_marks)));\n}\n"
            "LT_EXPORT int lt_paged_marks_reset() {\n"
            "  static long long init[%d][9][%d];\n"
            "  for (auto& r : init) for (auto& w : r) for (auto& v : w) v = 1LL << 60;\n"
            "  return static_cast<int>(cudaMemcpyToSymbol(g_marks, init, sizeof(init)));\n}\n"
            "\nnamespace {\n" % (MARK_RANKS, N_MARKS))
    return s.replace(K8_SECTION, K8_SECTION + head) + tail


DEPTHS = ("  constexpr int D = STRIPE ? kStripeDepth : kPagedDepth;",
          "KIND == 2 ? kStripeDepth : kPagedDepth")


def _stripe_ring8(s: str) -> str:
    """K14's and K15's ring at K6's 8 stages (one a consumer warp)."""
    for d in DEPTHS:
        assert s.count(d) == 1, d
    return s.replace(DEPTHS[0], "  constexpr int D = kPagedDepth;").replace(DEPTHS[1], "kPagedDepth")


# name: (source transform, still attends)
VARIANTS = {
    "as built": (lambda s: s, True),
    "stripe ring of 8 stages": (_cluster_only(_stripe_ring8), True),
    "no stages (launch, setup, combines)": (_cluster_only(_no_stages), False),
    "no compute (the ring alone)": (_cluster_only(_no_compute), False),
    "phase clocks": (_cluster_only(_clocks), True),
}
LAUNCHER = "template <typename CT, bool QUANT, int KIND, int GM, int NP>\nint launch_cluster("
LAUNCH = ("  if constexpr (KIND == 2)\n"
          "    return static_cast<int>(cudaLaunchKernelEx(&cfg, stripe_cluster_kernel")


def _occupancy(s: str) -> str:
    """Each launcher answers instead of launching: the clusters of its
    launch's shape (cluster, block, shared memory) that fit the card at once
    (cudaOccupancyMaxActiveClusters), read back by lt_clusters_at_once."""
    for stmt in (LAUNCHER, LAUNCH):
        assert s.count(stmt) == 1, stmt
    s = s.replace(LAUNCHER, "int g_clusters = -1;\n\n" + LAUNCHER)
    s = s.replace(LAUNCH, "  return static_cast<int>(cudaOccupancyMaxActiveClusters(&g_clusters, "
                  "kernel, &cfg));\n" + LAUNCH)
    return s + "\nLT_EXPORT int lt_clusters_at_once() { return g_clusters; }\n"


OCCUPANCY = "occupancy (no launch)"  # built beside VARIANTS, never timed
# K14 / K15 plans timed beside the planner's, (cluster, parts, rows), rows
# None the planner's (a stage past STRIPE_STAGE_BYTES is left out); C P =
# 32 two CTAs an SM at one lane.
STRIPE_PLANS = ((8, 2, 32), (8, 2, 16), (4, 4, None), (2, 8, None), (1, 16, None),
                (8, 1, None), (8, 4, None), (4, 8, None), (2, 16, None), (1, 32, None),
                (2, 8, 16), (1, 16, 16), (2, 16, 16), (1, 32, 16), (4, 8, 16))


def build(out_dir) -> dict:
    """{variant: ctypes library}, the variants and OCCUPANCY's copy
    compiled in parallel."""
    src = (_build.CSRC / "attention.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, (name, (edit, _)) in enumerate({**VARIANTS, OCCUPANCY: (_occupancy, False)}.items()):
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
        lib.lt_error_string.argtypes = [ctypes.c_int]
        lib.lt_error_string.restype = ctypes.c_char_p
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


def stripe(lib, q, kvn, sn, kvc, sc, pv, hd: int, plan, s_use: int | None) -> torch.Tensor:
    """ops/attention.py _stripe_launch on the variant's library (one layer's
    cache [B, KV, S, W]; fused where kvn is given), plan forced."""
    b, kvh, g, _ = q.shape
    s_len, width = kvc.shape[-2], kvc.shape[-1]
    out = torch.empty((b, kvh, g, width - hd), dtype=torch.float32, device=q.device)
    scratch = [None] * 3
    if plan.parts > 1:
        scratch = [torch.empty((b, kvh, plan.parts, g, width - hd), device=q.device),
                   torch.empty((b, kvh, plan.parts, g, 2), device=q.device),
                   attention._arrived(q.device, b * kvh)]
    err = lib.lt_stripe_attention(
        q.data_ptr(), _build.dtype_code(q), None if kvn is None else kvn.data_ptr(),
        0 if kvn is None else attention.CACHE_CODES[kvn.dtype],
        None if sn is None else sn.data_ptr(), kvc.data_ptr(), attention.CACHE_CODES[kvc.dtype],
        None if sc is None else sc.data_ptr(), pv.data_ptr(), b, kvh, g, s_len, s_use or s_len,
        hd, width - hd, hd ** -0.5, out.data_ptr(), None, None,
        *[None if t is None else t.data_ptr() for t in scratch], plan.cluster, plan.parts,
        plan.rows, _build.stream())
    _build.check(lib, err, "stripe ablation")
    return out


def stripe_plans(q, kvc, sms: int, variant: str) -> list:
    """The plans a K14 / K15 case is timed at: the planner's, and as built
    also STRIPE_PLANS (rows None: the planner's)."""
    b, kvh, _, _ = q.shape
    base = attention.plan_stripe(b, kvh, kvc.shape[-2], kvc.shape[-1], kvc.element_size(), sms)
    plans = [base]
    if variant in ("as built", "no compute (the ring alone)", "stripe ring of 8 stages",
                   "no stages (launch, setup, combines)"):
        for c, p, r in STRIPE_PLANS:
            plan = attention.StripePlan(c, p, r or base.rows)
            stage = plan.rows * kvc.shape[-1] * kvc.element_size()
            if plan not in plans and stage <= attention.STRIPE_STAGE_BYTES:
                plans.append(plan)
    return plans


def phase_cycles(lib, run, cp: int, c: int) -> list[dict]:
    """One run of the "phase clocks" variant: the phase clocks of each of the
    head's cp ranks (clusters of c)."""
    marks = torch.zeros((MARK_RANKS, 9, N_MARKS), dtype=torch.int64)
    _build.check(lib, lib.lt_paged_marks_reset(), "marks")
    run()
    torch.cuda.synchronize()
    _build.check(lib, lib.lt_paged_marks(ctypes.c_void_p(marks.data_ptr())), "marks")
    m = marks[:min(cp, MARK_RANKS), :9].tolist()  # ranks x (8 consumer warps + producer) x marks
    unset = 1 << 60

    def at(r, w, k):
        return m[r][w][k] if m[r][w][k] < unset else None
    return [{"setup": at(r, 0, 1),
             "first_stage": [at(r, w, 2) for w in range(8)],
             "warps_done": [at(r, w, 3) for w in range(8)],
             "combined": at(r, 0, 4),
             "pushed": at(r, 0, 5) if r % c else None,
             "barriers_init": at(r, 8, 6),
             "first_copy_issued": at(r, 8, 7),
             "q_loaded": at(r, 0, 8),
             "pos_known": at(r, 0, 9),
             "end": at(r, 0, 10) if r % c == 0 else None,
             "ranks_in": at(r, 0, 11) if r % c == 0 else None,
             "finished": at(r, 0, 12) if r % c == 0 else None}
            for r in range(len(m))]


def stripe_inputs(dev, quant: bool, f32: bool = False, kvh=8, g=4, hd=64, s=33792, seed=11):
    """q, this token's rows (and scales), one layer's cache [1, KV, S, W]
    (and scale rows): K14's 32k shape (bf16 or int8), or with f32 K15's."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((1, kvh, s, 2 * hd), device=dev, generator=gen)
    new = torch.randn((1, kvh, 1, 2 * hd), device=dev, generator=gen)
    q = torch.randn((1, kvh, g, hd), device=dev, generator=gen)
    if quant:
        (k, ks), (v, vs) = quantize_kv(x[..., :hd]), quantize_kv(x[..., hd:])
        kvc, sc = torch.cat([k, v], dim=-1), torch.stack([ks, vs], dim=-2)
        (k, ks), (v, vs) = quantize_kv(new[..., :hd]), quantize_kv(new[..., hd:])
        return (q.to(torch.bfloat16), torch.cat([k, v], dim=-1)[:, :, 0],
                torch.stack([ks, vs], dim=-1)[:, :, 0], kvc, sc)
    dt = torch.float32 if f32 else torch.bfloat16
    return q.to(dt), new[:, :, 0].to(dt), None, x.to(dt), None


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", default="K8,K6,K14,K15",
                    help="comma-separated kernels to time (default: all)")
    args = ap.parse_args(argv)
    wanted = set(args.kernels.split(","))
    if not torch.cuda.is_available():
        raise RuntimeError("paged_ablation times the card's kernels: no CUDA device")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    libs = build(_build.BUILD_DIR.parent / "ablation")
    device = torch.cuda.get_device_name(dev)
    hd = 64
    # (kernel, kv, lanes, configs(variant), call(lib, config), plain output, label(config))
    cases = []
    for quant in (False, True):
        if "K8" in wanted:
            q, pool, spool, tables, pv = inputs(dev, quant)
            cases.append(("K8", quant, q.shape[0], lambda v: (1, 2, 4, 8),
                          lambda lib, c, a=(q, pool, spool, tables, pv): paged(lib, *a, hd, c,
                                                                                sms),
                          attention.decode_attention_paged_plain(q, pool, tables, pv, hd ** -0.5,
                                                                 hd, scale_pool=spool),
                          lambda c: {"cluster": c}))
        for lanes in (1, 8) if "K6" in wanted else ():
            q, kvn, sn, kvc, sc, pv = dense_inputs(dev, quant, lanes)
            if quant:
                want = attention.decode_attention_fused_write_q_plain(
                    q, kvn, sn, kvc[None].clone(), sc[None].clone(), pv, hd ** -0.5, 0, hd)[0]
            else:
                want = attention.decode_attention_fused_write_plain(
                    q, kvn, kvc[None].clone(), pv, hd ** -0.5, 0, hd)[0]
            cases.append(("K6", quant, lanes, lambda v: (1, 2, 4, 8),
                          lambda lib, c, a=(q, kvn, sn, kvc, sc, pv): dense(lib, *a, hd, c, sms),
                          want, lambda c: {"cluster": c}))
    # K14 fused at pos 32767 (bf16, int8), K15 at pos 3999 of s_use 4000 (f32)
    for kernel, quant, f32, s_len, pos, s_use in (("K14", False, False, 33792, 32767, None),
                                                   ("K14", True, False, 33792, 32767, None),
                                                   ("K15", False, True, 4128, 3999, 4000)):
        if kernel not in wanted:
            continue
        q, kvn, sn, kvc, sc, = stripe_inputs(dev, quant, f32, s=s_len)
        pv = torch.full((1,), pos, dtype=torch.int32, device=dev)
        if kernel == "K15":
            kvn = sn = None
            want = attention.decode_attention_plain(q, kvc, pv, hd ** -0.5, hd, s_use)
        elif quant:  # the row written once here: every later call rewrites the same bits
            want = attention.decode_attention_split_fused_write_q_plain(
                q, kvn, sn, kvc[None], sc[None], pv, hd ** -0.5, 0, hd)[0]
        else:
            want = attention.decode_attention_split_fused_write_plain(
                q, kvn, kvc[None], pv, hd ** -0.5, 0, hd)[0]
        cases.append((kernel, quant, 1, lambda v, q=q, kvc=kvc: stripe_plans(q, kvc, sms, v),
                      lambda lib, plan, a=(q, kvn, sn, kvc, sc, pv), s_use=s_use:
                      stripe(lib, *a, hd, plan, s_use), want,
                      lambda plan: {"cluster": plan.cluster, "parts": plan.parts,
                                    "stage_rows": plan.rows}))
    for kernel, quant, lanes, configs, call, want, label in cases:
        if kernel in ("K14", "K15"):  # the clusters of each size that fit the card at once
            base = configs("as built")[0]
            for c in (1, 2, 4, 8):
                call(libs[OCCUPANCY], attention.StripePlan(c, 1, base.rows))
                print(json.dumps({"bench": "paged_ablation", "kernel": kernel,
                                  "variant": OCCUPANCY, "kv": ("f32" if kernel == "K15" else
                                                               "int8" if quant else "bf16"),
                                  "device": device, "cluster": c, "stage_rows": base.rows,
                                  "clusters_at_once": libs[OCCUPANCY].lt_clusters_at_once()}),
                      flush=True)
    for rnd in range(2):
        names = list(VARIANTS) if rnd == 0 else list(reversed(VARIANTS))
        for name in names:
            lib, attends = libs[name], VARIANTS[name][1]
            for kernel, quant, lanes, configs, call, want, label in cases:
                for cfg in configs(name):
                    def run(lib=lib, cfg=cfg, call=call):
                        return call(lib, cfg)
                    err = None
                    if attends:
                        got = run()
                        torch.cuda.synchronize()
                        err = ((got - want).abs().max() / want.abs().max()).item()
                        assert err <= 1e-5, f"{kernel} {name}, {label(cfg)}: rel err {err}"
                    extra = label(cfg)
                    if name == "phase clocks":
                        c = extra["cluster"]
                        extra["cycles"] = phase_cycles(lib, run, c * extra.get("parts", 1), c)
                    ms = roofline.time_run(lambda run=run: [run() for _ in range(CALLS)], dev) \
                        * 1e3 / CALLS
                    print(json.dumps({"bench": "paged_ablation", "kernel": kernel,
                                      "variant": name, "kv": ("f32" if kernel == "K15" else
                                                              "int8" if quant else "bf16"),
                                      "lanes": lanes, "device": device, "ms": ms,
                                      "round": rnd, "max_rel_err": err, **extra}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
