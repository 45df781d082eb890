"""Fractional-bit weight-only quantization + inference framework in JAX.

Re-implements the full capability surface of snu-mllab/Q-Palette (NeurIPS 2025,
arXiv:2509.20214) — scalar (SQ), vector (VQ) and trellis-coded (TCQ) quantizers
spanning 1.5–12 bits/weight, incoherence processing, LDLQ Hessian-aware
quantization, a decode-GEMV kernel, and the fusion-aware mixed-scheme (MSQ)
solvers — on JAX / XLA / Pallas, running on an NVIDIA H100.

Layer map (bottom → top), mirroring reference SURVEY.md §1:
  L0  qpalette_tpu.kernels   — device layouts + the trellis decode-GEMV (Pallas/Triton)
  L1  qpalette_tpu.ops       — packed formats, reference codecs, Hadamard transform
  L2  qpalette_tpu.quant     — LDLQ / Viterbi / VQ-ALS quantization algorithms
  L3  qpalette_tpu.models    — Llama model family with quantized linears
  L4  qpalette_tpu.runtime   — decode engine, KV cache, eval harness
  L5  qpalette_tpu.msq       — mixed-scheme quantization solvers (mem / latency)
  L6  qpalette_tpu.parallel  — mesh/sharding (tensor parallel over NVLink)
"""

__version__ = "0.1.0"

_EXPORTS = {
    "LlamaConfig": "qpalette_tpu.models.llama",
    "forward": "qpalette_tpu.models.llama",
    "quantize_linear": "qpalette_tpu.quant.incoherent",
    "parse_quantizer_str": "qpalette_tpu.quant.incoherent",
    "build_quantized_model": "qpalette_tpu.runtime.loader",
    "build_dense_model": "qpalette_tpu.runtime.loader",
    "generate": "qpalette_tpu.runtime.decode",
    "generate_fast": "qpalette_tpu.runtime.decode",
    "eval_ppl": "qpalette_tpu.runtime.evaluate",
    "solve_mem_constrained": "qpalette_tpu.msq.solver",
    "solve_lat_constrained": "qpalette_tpu.msq.solver",
    "make_mesh": "qpalette_tpu.parallel.sharding",
    "shard_params": "qpalette_tpu.parallel.sharding",
}


def __getattr__(name):  # lazy top-level API (avoids importing jax eagerly)
    if name in _EXPORTS:
        import importlib
        mod = importlib.import_module(_EXPORTS[name])
        return getattr(mod, name)
    raise AttributeError(name)
