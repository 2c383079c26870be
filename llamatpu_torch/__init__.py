"""llamatpu_torch: the PyTorch/CUDA port of llamatpu for one NVIDIA H100.

The JAX package `llamatpu` stays beside this one as the reference the port is
held against; this package imports `torch` and numpy only, never `jax` and no
module of `llamatpu`. Entry points run on the card unless the caller passes
`device="cpu"`, where every kernel wrapper takes its plain PyTorch version.

Layout follows the JAX package's module names (minus the `pallas_` prefix):

- models/  config, weights (QTensor + load transforms + the weights bridge),
           synthetic presets, the transformer forward
- ops/     rmsnorm, rope, sampling, the matmul dispatch and the four kernel
           modules (quant_matmul, gemm, layer_fused) with their CUDA sources
           under csrc/, built by _build.py at first use
- runtime/ Engine: chunked prefill and windowed greedy decode
"""
