"""llamatpu_torch: the PyTorch/CUDA port of llamatpu for one NVIDIA H100.

The JAX package `llamatpu` stays beside this one as the reference the port is
held against; this package imports `torch` and numpy only, never `jax` and no
module of `llamatpu`. Entry points run on the card unless the caller passes
`device="cpu"` (`--device cpu`), where every kernel wrapper takes its plain
PyTorch version.

Layout follows the JAX package's module names (minus the `pallas_` prefix):

- cli.py   `python -m llamatpu_torch.cli run|validate -m model.gguf`
- gguf/    GGUF reader and writer, ggml types, block-quant codecs
- models/  config, family detection, the GGUF loader, weights (QTensor +
           load transforms + the weights bridge), synthetic presets, the
           transformer forward
- tokenizer/, format/  the Llama 3 byte-level BPE and chat format
- ops/     rmsnorm, rope, sampling, the matmul dispatch and the kernel
           modules (quant_matmul, gemm, layer_fused, attention) with their
           CUDA sources under csrc/, built by _build.py at first use
- runtime/ Engine (chunked prefill, windowed greedy or sampled decode) and
           the instruct / interactive sessions
- bench/   perplexity and the `validate` command
"""
