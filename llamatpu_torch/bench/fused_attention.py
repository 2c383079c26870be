"""K6 and K6-int8, the fused KV-append + decode attention
(`ops/attention.py decode_attention_fused_write[_q]`), timed on the card at
the decode paths' shapes: one JSON line a shape.

    python3 llamatpu_torch/bench/fused_attention.py [--root DIR]

--root DIR times the llamatpu_torch package of another checkout instead of
this one (for example the parent commit unpacked with `git archive`), so two
versions compare inside one call on one card: parent, change, change,
parent. Run it by path, not with -m, so that the package is imported from
DIR. Each shape's time is the device time of every kernel the wrapper
launches, from torch.profiler over 32 calls on one layer of a 2-layer
stacked cache (warm: the layer's rows stay in L2). The shapes: Llama-3.2-1B
(KV 8, G 4, hd 64) at pos 512 of 1152 rows at one lane and 8, at 8160 rows
(bf16) and 15360 (int8), the Q8_0 GGUF path's one-lane window (pos 520 of
1152) and Phi-3-medium's (KV 10, hd 128, pos 144 of 1152). Needs the card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

SHAPES = (  # (label, KV heads, G, hd, lanes, cache rows, pos, int8)
    ("llama b1 s1152", 8, 4, 64, 1, 1152, 512, False),
    ("llama b8 s1152", 8, 4, 64, 8, 1152, 512, False),
    ("llama b1 s8160", 8, 4, 64, 1, 8160, 512, False),
    ("llama gguf window b1 s1152 pos520", 8, 4, 64, 1, 1152, 520, False),
    ("phi3 window b1 s1152 pos144", 10, 4, 128, 1, 1152, 144, False),
    ("llama int8 b1 s1152", 8, 4, 64, 1, 1152, 512, True),
    ("llama int8 b8 s1152", 8, 4, 64, 8, 1152, 512, True),
    ("llama int8 b1 s15360", 8, 4, 64, 1, 15360, 512, True),
)
CALLS = 32


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None, help="checkout whose llamatpu_torch to time")
    args = ap.parse_args(argv)
    root = Path(args.root or Path(__file__).resolve().parents[2]).resolve()
    sys.path.insert(0, str(root))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from llamatpu_torch.ops import attention as A
    from llamatpu_torch.ops.kv_quant import quantize_kv

    if not torch.cuda.is_available():
        raise RuntimeError("fused_attention times the card's kernels: no CUDA device")
    assert Path(A.__file__).resolve().is_relative_to(root), f"{A.__file__} is not under {root}"
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device=dev).manual_seed(5)
    for label, kvh, g, hd, b, s, pos, int8 in SHAPES:
        x = torch.randn((2, b, kvh, s, 2 * hd), device=dev, generator=gen)
        new = torch.randn((b, kvh, 2 * hd), device=dev, generator=gen)
        q = torch.randn((b, kvh, g, hd), device=dev, generator=gen).to(torch.bfloat16)
        pv = torch.full((b,), pos, dtype=torch.int32, device=dev)
        if int8:
            (k, ks), (v, vs) = quantize_kv(x[..., :hd]), quantize_kv(x[..., hd:])
            kvc, sc = torch.cat([k, v], -1), torch.stack([ks, vs], -2)
            (k, ks), (v, vs) = quantize_kv(new[..., :hd]), quantize_kv(new[..., hd:])
            kvn, sn = torch.cat([k, v], -1), torch.stack([ks, vs], -1)

            def fn():
                return A.decode_attention_fused_write_q(q, kvn, sn, kvc, sc, pv, hd ** -0.5, 1, hd)
        else:
            kvc, kvn = x.to(torch.bfloat16), new.to(torch.bfloat16)

            def fn():
                return A.decode_attention_fused_write(q, kvn, kvc, pv, hd ** -0.5, 1, hd)
        del x
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if getattr(e, "device_time_total", 0) > 0]
        # a kernel seen n times in CALLS calls launches ceil(n / CALLS) times a call
        ms = sum(e.device_time_total / e.count * -(-e.count // CALLS) for e in events) / 1e3
        print(json.dumps({"bench": "fused_attention", "root": os.path.basename(str(root)),
                          "shape": label, "ms": ms, "card": card,
                          "kernels": {e.key[:80]: e.device_time_total / e.count / 1e3
                                      for e in events}}), flush=True)
        del kvc, kvn, q
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
