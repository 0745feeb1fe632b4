"""The plain reference of a dense GQA decoder (Qwen2.5 and Yi alike): RMSNorm
that scales by ``1 + w``, half-split rotary embeddings, causal softmax
attention with ``H / Hkv`` query heads a KV head, and a SwiGLU MLP, with no
cache, no kernels and no batching.

It runs a whole causal forward pass over each prompt with the tokens the
program served, one layer at a time: each layer's weights are upcast to
float32 once and applied to every sequence, so the reference fits beside
the model's bf16 weights. Float32 throughout, with TF32 off. Its answer is
the gap by which each served token's logit lies below the reference's
best logit at that position.

The control (``control=True``) runs the same computation beside it with
every matrix product's inputs rounded to float8 e4m3 (weights by output column,
activations by row, each scaled to its absolute maximum), which is the
precision below the bf16 that the configurations state. The control's
reading is the float32 reference's gap of the token that the fp8 model
puts first.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

QUERY_CHUNK = 512       # query rows a block of the attention scores
ROW_CHUNK = 2048        # token rows a block of the MLP
FP8_MAX = 448.0         # largest float8 e4m3fn


@contextlib.contextmanager
def exact_fp32():
    """Float32 matrix products without TF32, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (absolute maximum to 448), back in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    s = FP8_MAX / amax
    return (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s


WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
IN_DIMS = {"wo": 2}      # wo is (H, D, d); every other weight (in, out...)


class Linear:
    """A weight as a float32 ``(in, out)`` matrix, and in fp8 mode its
    rounded copy; ``__call__`` multiplies rows ``(n, in)``."""

    def __init__(self, w: torch.Tensor, mode: str, in_dims: int = 1):
        n_in = 1
        for s in w.shape[:in_dims]:
            n_in *= s
        m = w.reshape(n_in, -1).float()
        self.out_shape = tuple(w.shape[in_dims:])
        self.fp8 = mode == "fp8"
        self.m = fp8_round(m, 0) if self.fp8 else m

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            x = fp8_round(x, -1)
        return (x @ self.m).reshape(x.shape[:-1] + self.out_shape)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + w.float())


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate (S, heads, D) by position, pairing dim j with j + D/2."""
    S, _, D = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float64,
                                        device=x.device) / D))
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """Causal softmax attention; q (S, H, D), k and v (S, Hkv, D)."""
    S, H, D = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1).transpose(0, 1)       # (H, S, D)
    v = v.repeat_interleave(G, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    for a in range(0, S, QUERY_CHUNK):
        b = min(a + QUERY_CHUNK, S)
        s = torch.einsum("qhd,hkd->hqk", q[a:b], k[:, :b]) * D ** -0.5
        pos = torch.arange(a, b, device=q.device)[:, None]
        s = s.masked_fill(torch.arange(b, device=q.device)[None] > pos,
                          float("-inf"))
        out[a:b] = torch.einsum("hqk,hkd->qhd", torch.softmax(s, -1),
                                v[:, :b])
    return out


def _layer(x: torch.Tensor, lin: Mapping[str, Linear], p: Mapping,
           eps: float, theta: float) -> torch.Tensor:
    a = rms_norm(x, p["ln1"], eps)
    q = rope(lin["wq"](a), theta)
    k = rope(lin["wk"](a), theta)
    v = lin["wv"](a)
    o = attention(q, k, v)
    x = x + lin["wo"](o.reshape(o.shape[0], -1))
    for r in range(0, x.shape[0], ROW_CHUNK):
        h = rms_norm(x[r:r + ROW_CHUNK], p["ln2"], eps)
        m = torch.nn.functional.silu(lin["w_gate"](h)) * lin["w_up"](h)
        x[r:r + ROW_CHUNK] += lin["w_down"](m)
    return x


def served_gaps(weights: Mapping, eps: float, theta: float,
                prompts: Sequence[Sequence[int]],
                served: Sequence[Sequence[int]], device,
                control: bool = False
                ) -> Tuple[List[torch.Tensor], Optional[List[torch.Tensor]]]:
    """For each prompt and the tokens served after it, the gap of each
    served token: the reference's best logit at its position less the
    logit of the token, float32, (n,) each. With ``control``, also the
    fp8 control's reading at the same positions: the reference's best
    logit less the logit of the token the fp8 model puts first."""
    head = weights["head"]
    seqs = [torch.tensor(list(p) + list(s[:-1]), device=device)
            for p, s in zip(prompts, served)]
    with exact_fp32(), torch.no_grad():
        xs = [head["embed"][t].float() for t in seqs]
        ctl = [x.clone() for x in xs] if control else None
        for p in weights["layers"]:
            lin = {k: Linear(p[k], "fp32", IN_DIMS.get(k, 1))
                   for k in WEIGHTS}
            xs = [_layer(x, lin, p, eps, theta) for x in xs]
            if ctl is not None:
                lin8 = {k: Linear(p[k], "fp8", IN_DIMS.get(k, 1))
                        for k in WEIGHTS}
                del lin
                ctl = [_layer(x, lin8, p, eps, theta) for x in ctl]
                del lin8
        lm = Linear(head["lm_head"], "fp32")
        lm8 = Linear(head["lm_head"], "fp8") if ctl is not None else None
        gaps, ctl_gaps = [], ([] if ctl is not None else None)
        for i, (pr, sv) in enumerate(zip(prompts, served)):
            at = slice(len(pr) - 1, len(pr) - 1 + len(sv))
            logits = lm(rms_norm(xs[i][at], head["final_norm"], eps))
            best = logits.max(-1).values
            tok = torch.tensor(list(sv), device=device)
            gaps.append(best - logits.gather(1, tok[:, None])[:, 0])
            if ctl is not None:
                h8 = rms_norm(ctl[i][at], head["final_norm"], eps)
                tok8 = lm8(h8).argmax(-1)
                ctl_gaps.append(best - logits.gather(1, tok8[:, None])[:, 0])
        return gaps, ctl_gaps


def reference_tokens(weights: Mapping, eps: float, theta: float,
                     prompt: Sequence[int], n: int, device) -> List[int]:
    """Greedy decoding by the reference (a whole forward pass per token):
    for the tests, at tiny sizes."""
    toks: List[int] = []
    for _ in range(n):
        seq = list(prompt) + toks
        g = _last_logits(weights, eps, theta, seq, device)
        toks.append(int(g.argmax()))
    return toks


def _last_logits(weights: Mapping, eps: float, theta: float,
                 seq: Sequence[int], device) -> torch.Tensor:
    head = weights["head"]
    with exact_fp32(), torch.no_grad():
        x = head["embed"][torch.tensor(list(seq), device=device)].float()
        for p in weights["layers"]:
            lin: Dict[str, Linear] = {
                k: Linear(p[k], "fp32", IN_DIMS.get(k, 1)) for k in WEIGHTS}
            x = _layer(x, lin, p, eps, theta)
        return Linear(head["lm_head"], "fp32")(
            rms_norm(x[-1:], head["final_norm"], eps))[0]
