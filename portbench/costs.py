"""The yardstick's work counts and the card's peaks, frozen.

The kernels' least work is a copy of ``flops_and_bytes`` in the program's
``kernels/paged_attention.py`` and ``kernels/flash_attention.py``; the
model's FLOPs follow ``launch/roofline.py::model_flops``. They are copied
here so that a later change to the program, or a kernel taken off the
path, is still held to the same work. Every count is taken from what the
clients observed (prompt lengths and tokens streamed), never from the
program's own counters.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
H100_PEAK_BF16_FLOPS = 989e12
H100_HBM_BYTES_S = 3.35e12


@dataclasses.dataclass(frozen=True)
class Dims:
    """The sizes of a uniform dense GQA decoder that the costs need."""
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    block_size: int
    itemsize: int = 2          # bf16 activations and KV

    @property
    def layer_matmul_params(self) -> int:
        """Weights of one layer that a token multiplies: q, k, v, o and the
        three SwiGLU projections."""
        d, hq, hkv = self.d_model, self.heads * self.head_dim, \
            self.kv_heads * self.head_dim
        return d * hq + 2 * d * hkv + hq * d + 3 * d * self.d_ff

    @property
    def row_bytes(self) -> int:
        """One KV block row of the pool: every layer's K and V of
        ``block_size`` tokens."""
        return (self.layers * 2 * self.block_size * self.kv_heads
                * self.head_dim * self.itemsize)


def paged_flops_and_bytes(B: int, H: int, Hkv: int, D: int, MB: int,
                          context_total: int, *, itemsize: int,
                          kv_itemsize: int, quant: bool
                          ) -> Tuple[float, float]:
    """Least work of one paged-attention call over ``context_total``
    context tokens: 4 operations per token, query head and head dim; q
    read and the output written once, the block tables and lengths, each
    context token's K and V once (and the int8 mode's scales)."""
    nbytes = (2 * B * H * D * itemsize + B * MB * 4 + B * 4
              + context_total * Hkv * D * 2 * kv_itemsize
              + (B * MB * 2 * Hkv * 4 if quant else 0))
    return float(4 * context_total * H * D), float(nbytes)


def flash_flops_and_bytes(B: int, Sq: int, Skv: int, H: int, Hkv: int,
                          D: int, *, causal: bool, window: int,
                          q_offset: int, itemsize: int
                          ) -> Tuple[float, float]:
    """Least work of one flash-attention call: 4 operations per visible
    (query, key) pair, query head and head dim; q, k, v read once and the
    output written once."""
    pos = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(Skv, pos + 1) if causal else np.full(Sq, Skv)
    lo = (np.maximum(0, pos - window + 1) if window > 0
          else np.zeros(Sq, np.int64))
    pairs = B * int(np.clip(hi - lo, 0, None).sum())
    nbytes = (2 * B * Sq * H * D + 2 * B * Skv * Hkv * D) * itemsize
    return float(4 * pairs * H * D), float(nbytes)


def decode_attention_work(dims: Dims, context: int) -> Tuple[float, float]:
    """Paged attention's least work, over every layer, for one decode
    token that attends ``context`` positions."""
    mb = -(-context // dims.block_size)
    f, b = paged_flops_and_bytes(1, dims.heads, dims.kv_heads, dims.head_dim,
                                 mb, context, itemsize=dims.itemsize,
                                 kv_itemsize=dims.itemsize, quant=False)
    return f * dims.layers, b * dims.layers


def prefill_attention_work(dims: Dims, prompt_len: int) -> Tuple[float, float]:
    """Flash attention's least work, over every layer, for one causal
    prompt of ``prompt_len`` tokens: however the prompt was cut into
    chunks, each (query, key) pair is computed once and each of q, k, v
    and the output moves once."""
    f, b = flash_flops_and_bytes(1, prompt_len, prompt_len, dims.heads,
                                 dims.kv_heads, dims.head_dim, causal=True,
                                 window=0, q_offset=0, itemsize=dims.itemsize)
    return f * dims.layers, b * dims.layers


def prefill_model_flops(dims: Dims, prompt_len: int) -> float:
    """Useful FLOPs of prefilling one prompt: 2 per weight a token
    multiplies in every layer, the exact causal attention term, and the LM
    head once, for the token the prefill emits. (``model_flops`` charges
    the head on every token; only the last one's logits are needed.)"""
    attn, _ = prefill_attention_work(dims, prompt_len)
    return (2.0 * dims.layer_matmul_params * dims.layers * prompt_len + attn
            + 2.0 * dims.d_model * dims.vocab)


def decode_model_flops(dims: Dims, context: int) -> float:
    """Useful FLOPs of one decode token that attends ``context``
    positions: every layer's weights, its attention over the cache, and
    the LM head."""
    attn, _ = decode_attention_work(dims, context)
    return (2.0 * dims.layer_matmul_params * dims.layers + attn
            + 2.0 * dims.d_model * dims.vocab)


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take for this work: the larger of
    its operations over peak FLOP/s and its bytes over peak bandwidth."""
    return max(flops / H100_PEAK_BF16_FLOPS, nbytes / H100_HBM_BYTES_S)
