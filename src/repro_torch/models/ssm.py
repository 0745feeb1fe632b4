"""Mamba-2 SSD (state-space duality) in its chunked matmul form.

The port of ``causal_conv``, ``causal_conv_step``, ``ssd_forward`` and
``ssd_decode_step`` (``src/repro/models/ssm.py:32-150``), which the
reference computes in jnp outside any Pallas kernel; plain PyTorch is
their counterpart. The reference's ``lax.scan`` over chunks becomes a loop
over chunks carrying the (B, H, P, N) fp32 state. A partial last chunk is
padded with ``dt = 0`` steps, which decay nothing and add nothing, so the
carried state stays exact; ``dt`` goes through softplus in fp32; the final
state is cast to the input's dtype (the cache dtype).

Shapes: x (B, S, d_inner) with d_inner = H·P (H heads of dim P); state
size N; one B/C group.

One deliberate difference: the reference exponentiates the intra-chunk
decay ``L_q - L_s`` everywhere and then zeroes the entries above the
diagonal, where it is positive; once it passes fp32's ``exp`` range
(about 88, which a 256-step chunk reaches at full width) the forward
still reads 0 there but the gradient is NaN (``0 * inf``), so the
reference cannot train mamba2 or jamba at full width. The port masks the
exponent to ``-inf`` first: the same forward, bit for bit, and a finite
gradient (ROADMAP.md §3).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import SSMConfig


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, accumulated in fp32. x: (B, S, C), w: (W, C)
    -> (B, S, C)."""
    W, S = w.shape[0], x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(W):
        out = out + xp[:, i:i + S].float() * w[i].float()
    return out.to(x.dtype)


def causal_conv_step(x_new: torch.Tensor, conv_state: torch.Tensor,
                     w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One conv step. x_new: (B, C); conv_state: (B, W-1, C), the last W-1
    raw inputs. Returns (out (B, C), the new state)."""
    full = torch.cat([conv_state, x_new[:, None]], dim=1)       # (B, W, C)
    out = torch.einsum("bwc,wc->bc", full.float(), w.float()).to(x_new.dtype)
    return out, full[:, 1:].to(conv_state.dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # log(1 + e^x) for every x, as jax.nn.softplus computes it (torch's
    # softplus returns x itself above its threshold)
    return torch.logaddexp(x, torch.zeros_like(x))


def ssd_forward(xz: dict, params: dict, cfg: SSMConfig, init_state=None,
                return_state: bool = False):
    """Chunked SSD over a whole sequence.

    xz: {"x": (B, S, d_inner) after conv and silu, "b"/"c": (B, S, N),
    "dt": (B, S, H) before softplus}; params: {"A_log", "D", "dt_bias"}
    (H,). Returns y (B, S, H, P) [and the final state (B, H, P, N)].
    """
    xin = xz["x"]
    B_, S, DI = xin.shape
    P = cfg.head_dim
    H = DI // P
    x = xin.reshape(B_, S, H, P)
    bmat, cmat = xz["b"], xz["c"]
    N = bmat.shape[-1]
    Q = min(cfg.chunk_size, S)
    pad = (-S) % Q
    dt = _softplus(xz["dt"].float() + params["dt_bias"].float())  # (B,S,H)
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        bmat = torch.nn.functional.pad(bmat, (0, 0, 0, pad))
        cmat = torch.nn.functional.pad(cmat, (0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    nc = (S + pad) // Q
    A = -torch.exp(params["A_log"].float())                       # (H,)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    h = (torch.zeros((B_, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    ys = []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        xq, bq, cq, dtq = x[:, sl], bmat[:, sl], cmat[:, sl], dt[:, sl]
        xbar = xq.float() * dtq[..., None]                        # (B,Q,H,P)
        L = torch.cumsum(dtq * A, dim=1)                          # (B,Q,H)
        L_last = L[:, -1]                                         # (B,H)
        # within the chunk
        cb = torch.einsum("bqn,bsn->bqs", cq.float(), bq.float())
        # masked before the exp: above the diagonal L_q - L_s > 0 can
        # overflow, and exp's gradient there would be 0 * inf = NaN
        decay = torch.exp(torch.where(tri[None, :, :, None],
                                      L[:, :, None, :] - L[:, None, :, :],
                                      -torch.inf))                # (B,Q,S,H)
        y_diag = torch.einsum("bqsh,bshp->bqhp", cb[..., None] * decay, xbar)
        # the carried state's share
        y_off = torch.exp(L)[..., None] * torch.einsum(
            "bqn,bhpn->bqhp", cq.float(), h)
        # the chunk's own state
        w_state = torch.exp(L_last[:, None, :] - L)               # (B,Q,H)
        s_n = torch.einsum("bqn,bqhp->bhpn", bq.float(),
                           w_state[..., None] * xbar)
        h = h * torch.exp(L_last)[:, :, None, None] + s_n
        ys.append(y_diag + y_off)
    y = torch.cat(ys, dim=1)[:, :S]
    y = y + x[:, :S].float() * params["D"].float()[None, None, :, None]
    y = y.to(xin.dtype)
    if return_state:
        return y, h.to(xin.dtype)
    return y


def ssd_decode_step(xz: dict, params: dict, cfg: SSMConfig,
                    h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token SSD update. xz: {"x": (B, d_inner), "b"/"c": (B, N),
    "dt": (B, H)}; h: (B, H, P, N). Returns (y (B, H, P), the new state in
    h's dtype)."""
    B_, DI = xz["x"].shape
    P = cfg.head_dim
    H = DI // P
    x = xz["x"].reshape(B_, H, P)
    dt = _softplus(xz["dt"].float() + params["dt_bias"].float())   # (B,H)
    A = -torch.exp(params["A_log"].float())
    a = torch.exp(dt * A[None, :])
    xbar = x.float() * dt[..., None]                               # (B,H,P)
    h_new = (h.float() * a[:, :, None, None]
             + torch.einsum("bhp,bn->bhpn", xbar, xz["b"].float()))
    y = torch.einsum("bn,bhpn->bhp", xz["c"].float(), h_new)
    y = y + x.float() * params["D"].float()[None, :, None]
    return y.to(x.dtype), h_new.to(h.dtype)
