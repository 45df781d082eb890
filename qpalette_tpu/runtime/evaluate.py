"""Perplexity evaluation harness.

Reference behavior: eval_qdict.py:17-38 — per-sample forward over
ctx-size windows of the test stream, mean cross-entropy, ppl = exp(loss);
results cached next to the qdict (:79-120).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from qpalette_tpu.models import llama


@functools.partial(jax.jit, static_argnames=("spec", "chunk"))
def ce_loss(spec, params, tokens, chunk: int = 1024):
    """tokens (B, S) -> mean next-token cross-entropy (matches the
    reference's shift-logits CE, eval_qdict.py:28-32).

    The lm_head matmul + log-softmax run over sequence chunks so ctx-8192
    never materializes (B, S, vocab) f32 (4.2 GB for Llama-3 vocab)."""
    h = llama.forward(spec, params, tokens, return_hidden=True)  # (B,S,hid)
    vocab = spec.config.vocab_size
    if spec.lm_head_spec is not None:
        # 4-bit trellis lm_head: same rotation + qlinear path forward()
        # uses (chunk calls share one hoisted dequant under jit), pad
        # columns sliced after
        from qpalette_tpu.runtime.qlinear import qlinear_apply
        B, S = tokens.shape
        total = jnp.float32(0.0)
        for c0 in range(0, S - 1, chunk):
            c1 = min(c0 + chunk, S - 1)
            hc = h[:, c0:c1].reshape(-1, h.shape[-1])
            hc = llama._rotate_in(hc, params["lm_head_su"].astype(hc.dtype))
            logits = qlinear_apply(spec.lm_head_spec, params["lm_head_q4"],
                                   hc, params.get("luts"))
            logits = logits.astype(jnp.float32)[:, :vocab]
            logits = logits.reshape(B, c1 - c0, vocab)
            logp = jax.nn.log_softmax(logits, axis=-1)
            tgt = tokens[:, c0 + 1:c1 + 1]
            nll = -jnp.take_along_axis(logp, tgt[..., None],
                                       axis=-1)[..., 0]
            total = total + jnp.sum(nll)
        return total / (B * (S - 1))
    if "lm_head_q" in params:
        # slice off the pad columns (loader pads vocab to a 2048 multiple
        # with q=0/scale=1 rows) BEFORE the softmax — 768 exact-zero logits
        # would otherwise enter the partition function (llama.forward
        # slices, llama.py:443; this consumer must too)
        lm = (params["lm_head_q"].astype(jnp.float32)
              * params["lm_head_s"].astype(jnp.float32)).T[:vocab]
        # int8 lm_head is quantized in the rotated basis: rotate h to match
        su = params["lm_head_su"]
        rot = True
    else:
        lm = params["lm_head"].astype(jnp.float32)[:vocab]
        rot = False
    B, S = tokens.shape
    total = jnp.float32(0.0)
    for c0 in range(0, S - 1, chunk):
        c1 = min(c0 + chunk, S - 1)
        hc = h[:, c0:c1]
        if rot:
            hc = llama._rotate_in(hc, su.astype(hc.dtype))
        logits = hc.astype(jnp.float32) @ lm.T
        logp = jax.nn.log_softmax(logits, axis=-1)
        tgt = tokens[:, c0 + 1:c1 + 1]
        nll = -jnp.take_along_axis(logp, tgt[..., None], axis=-1)[..., 0]
        total = total + jnp.sum(nll)
    return total / (B * (S - 1))


def eval_ppl(spec, params, token_stream: np.ndarray, ctx_size: int = 8192,
             progress: bool = True):
    """token_stream: flat int array.  Returns (ppl, avg_loss)."""
    n = len(token_stream) // ctx_size
    total = 0.0
    for i in range(n):
        chunk = token_stream[i * ctx_size:(i + 1) * ctx_size]
        loss = float(ce_loss(spec, params,
                             jnp.asarray(chunk[None, :], jnp.int32)))
        total += loss
        if progress:
            print(f"  [{i + 1}/{n}] avg_loss={total / (i + 1):.4f}",
                  flush=True)
    avg = total / max(n, 1)
    return float(np.exp(avg)), avg


def _tokenize(texts, tokenizer_name, joiner):
    from transformers import AutoTokenizer
    tok = AutoTokenizer.from_pretrained(tokenizer_name)
    return np.asarray(tok(joiner.join(texts),
                          return_tensors="np").input_ids[0])


def wikitext2_tokens(tokenizer_name: str = "meta-llama/Llama-3.1-8B",
                     split: str = "test"):
    """Load + tokenize WikiText-2 (reference gptq_data_utils.py:9-40).

    Requires local HF cache (no network egress in this environment); raises
    a clear error otherwise so callers can fall back to synthetic streams.
    """
    from datasets import load_dataset  # type: ignore
    ds = load_dataset("wikitext", "wikitext-2-raw-v1", split=split)
    return _tokenize(ds["text"], tokenizer_name, "\n\n")


def ptb_tokens(tokenizer_name: str = "meta-llama/Llama-3.1-8B",
               split: str = "test"):
    """PTB test stream (reference gptq_data_utils.py ptb loader)."""
    from datasets import load_dataset  # type: ignore
    ds = load_dataset("ptb_text_only", "penn_treebank", split=split)
    return _tokenize(ds["sentence"], tokenizer_name, " ")


def c4_tokens(tokenizer_name: str = "meta-llama/Llama-3.1-8B",
              n_docs: int = 1100):
    """C4 validation stream (reference gptq_data_utils.py c4 loader)."""
    from datasets import load_dataset  # type: ignore
    ds = load_dataset("allenai/c4", "en",
                      data_files={"validation":
                                  "en/c4-validation.00000-of-00008.json.gz"},
                      split="validation")
    return _tokenize([ds[i]["text"] for i in range(min(n_docs, len(ds)))],
                     tokenizer_name, " ")


DATASET_LOADERS = {"wikitext2": wikitext2_tokens, "ptb": ptb_tokens,
                   "c4": c4_tokens}
