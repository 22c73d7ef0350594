"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060).

Counterpart of ``repro/models/ssm.py``.  The chunked SSD algorithm: the
sequence splits into chunks of length L; inside a chunk the output is the
masked "attention-like" quadratic term, across chunks a small recurrence
over per-chunk states (h: (heads, p, n)) carries history, a Python loop
over the ``S / L`` chunk states where the reference runs ``lax.scan``.

The reference's multi-operand einsums are written as broadcast factors
followed by one batched matmul over the contracted axis, and ``B`` / ``C``
stay in their ``n_groups`` layout (the reference repeats them over the
heads of a group): no intermediate ever holds both the chunk length and
the ``(p, n)`` state.  The scan runs in fp32 whatever the compute dtype,
as the reference's does.  ``_segsum`` masks before ``exp``, so the upper
triangle is an exact ``exp(-inf) = 0`` and its gradient zero.

Decode is the O(1) recurrence  h' = exp(dt·A)·h + dt·B⊗x;  y = C·h + D·x.
``ssd_decode`` updates the cache's ``state`` and ``conv`` IN PLACE (as
:func:`repro_torch.models.attention.attn_decode` writes its KV cache,
R12): the cache passed in is consumed, and the one returned holds the same
tensors and ``idx + 1`` on the device (no host sync).  ``ssd_init``'s
deterministic leaves (``A_log``, ``D``, ``dt_bias``) come from numpy in
the reference's formula; ``A_log`` agrees with ``jnp.linspace``'s to an ulp.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .config import SSMConfig
from .layers import causal_conv, dense_init

__all__ = ["SSMCache", "ssd_init", "ssd_scan", "ssd_apply", "ssd_decode",
           "init_ssm_cache"]


class SSMCache(NamedTuple):
    state: torch.Tensor     # (B, H, p, n) fp32 recurrent state
    conv: torch.Tensor      # (B, d_conv - 1, d_conv_channels) conv tail
    idx: torch.Tensor       # 0-d int32 on the cache's device: tokens seen


def _dims(d_model: int, cfg: SSMConfig):
    d_in = cfg.expand * d_model
    n_heads = d_in // cfg.head_dim
    d_conv_ch = d_in + 2 * cfg.n_groups * cfg.d_state
    return d_in, n_heads, d_conv_ch


def ssd_init(gen: torch.Generator, d_model: int, cfg: SSMConfig):
    d_in, n_heads, d_conv_ch = _dims(d_model, cfg)
    d_proj = 2 * d_in + 2 * cfg.n_groups * cfg.d_state + n_heads  # z,x,B,C,dt
    a_log = np.log(np.linspace(1.0, 16.0, n_heads).astype(np.float32))
    return {
        "w_in": dense_init(gen, d_model, d_proj),
        "conv_w": torch.randn((cfg.d_conv, d_conv_ch), generator=gen,
                              dtype=torch.float32) * 0.1,
        "A_log": torch.as_tensor(a_log),
        "D": torch.ones((n_heads,), dtype=torch.float32),
        "dt_bias": torch.zeros((n_heads,), dtype=torch.float32),
        "norm_g": torch.ones((d_in,), dtype=torch.float32),
        "w_out": dense_init(gen, d_in, d_model),
    }


def _split_proj(proj, d_in, n_groups, d_state):
    """(z, xBC, dt) of the input projection."""
    xbc_w = d_in + 2 * n_groups * d_state
    return (proj[..., :d_in], proj[..., d_in:d_in + xbc_w],
            proj[..., d_in + xbc_w:])


def _segsum(x):
    """log-space cumulative segment sums: out[i, j] = sum_{j<l<=i} x[l],
    ``-inf`` above the diagonal."""
    length = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((length, length), dtype=torch.bool,
                      device=x.device).tril()
    return out.masked_fill(~mask, -torch.inf)


def ssd_scan(xh, dt, A, Bm, Cm, chunk: int, init_state=None):
    """Chunked SSD. xh: (B,S,H,p); dt: (B,S,H); A: (H,) (``A_log``);
    Bm/Cm: (B,S,G,n).  Returns (y (B,S,H,p), final_state (B,H,p,n)), fp32.
    """
    b, s, h, p = xh.shape
    g, n = Bm.shape[2], Bm.shape[3]
    L = min(chunk, s)
    nc = s // L
    if s % L:
        raise ValueError(f"seq {s} must be divisible by chunk {L}")
    rep = h // g
    f32 = torch.float32

    xc = xh.reshape(b, nc, L, h, p).to(f32)
    dtc = dt.reshape(b, nc, L, h).to(f32)
    # B and C per group, chunk-major: (b, nc, g, L, n)
    Bg = Bm.reshape(b, nc, L, g, n).to(f32).permute(0, 1, 3, 2, 4)
    Cg = Cm.reshape(b, nc, L, g, n).to(f32).permute(0, 1, 3, 2, 4)

    dA = dtc * (-torch.exp(A.to(f32)))                         # (b,nc,L,h) <= 0

    # 1) intra-chunk (diagonal) term: masked quadratic attention analogue
    decay = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))         # (b,nc,h,L,L)
    scores = Cg @ Bg.transpose(-1, -2)                          # (b,nc,g,L,L)
    weights = (scores[:, :, :, None] *
               decay.reshape(b, nc, g, rep, L, L)).reshape(b, nc, h, L, L)
    xdt = (xc * dtc[..., None]).permute(0, 1, 3, 2, 4)         # (b,nc,h,L,p)
    y_diag = (weights @ xdt).permute(0, 1, 3, 2, 4)            # (b,nc,L,h,p)

    # 2) per-chunk states: h_c = sum_l decay_to_end[l] * dt_l * B_l ⊗ x_l
    dA_cum = torch.cumsum(dA, dim=2)                            # (b,nc,L,h)
    decay_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)       # (b,nc,L,h)
    xw = xc * (decay_end * dtc)[..., None]                      # (b,nc,L,h,p)
    xw = xw.reshape(b, nc, L, g, rep * p).permute(0, 1, 3, 4, 2)
    states = (xw @ Bg).reshape(b, nc, h, p, n)                 # (b,nc,h,p,n)

    # 3) inter-chunk recurrence over the chunk states (state BEFORE chunk c)
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])                # (b,nc,h)
    hprev = (torch.zeros((b, h, p, n), dtype=f32, device=xh.device)
             if init_state is None else init_state.to(f32))
    h_in = []
    for c in range(nc):
        h_in.append(hprev)
        hprev = hprev * chunk_decay[:, c, :, None, None] + states[:, c]
    h_in = torch.stack(h_in, dim=1)                             # (b,nc,h,p,n)

    # 4) off-diagonal term: the incoming state's contribution to each position
    state_decay = torch.exp(dA_cum)                             # (b,nc,L,h)
    y_off = Cg @ h_in.reshape(b, nc, g, rep * p, n).transpose(-1, -2)
    y_off = y_off.reshape(b, nc, g, L, rep, p).permute(0, 1, 3, 2, 4, 5)
    y_off = y_off.reshape(b, nc, L, h, p) * state_decay[..., None]

    return (y_diag + y_off).reshape(b, s, h, p), hprev


def _gated_out(params, y, z, dtype):
    """Mamba-2's gated RMSNorm before the output projection."""
    y = y * F.silu(z)
    yf = y.to(torch.float32)
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    y = (yf * torch.rsqrt(var + 1e-6) * params["norm_g"]).to(dtype)
    return y @ params["w_out"].to(dtype)


def ssd_apply(params, x: torch.Tensor, cfg: SSMConfig, d_model: int):
    """Full Mamba-2 mixer block (no separate MLP). x: (B,S,d) -> (B,S,d)."""
    b, s, _ = x.shape
    d_in, n_heads, _ = _dims(d_model, cfg)
    g, n = cfg.n_groups, cfg.d_state

    proj = x @ params["w_in"].to(x.dtype)
    z, xbc, dt = _split_proj(proj, d_in, g, n)
    xbc = F.silu(causal_conv(xbc, params["conv_w"])[0])
    xi, Bm, Cm = torch.split(xbc, [d_in, g * n, g * n], dim=-1)
    dt = F.softplus(dt.to(torch.float32) + params["dt_bias"])

    xh = xi.reshape(b, s, n_heads, cfg.head_dim)
    y, _ = ssd_scan(xh, dt, params["A_log"], Bm.reshape(b, s, g, n),
                    Cm.reshape(b, s, g, n), cfg.chunk)
    y = y + params["D"].to(torch.float32)[:, None] * xh.to(torch.float32)
    return _gated_out(params, y.reshape(b, s, d_in).to(x.dtype), z, x.dtype)


def init_ssm_cache(batch: int, d_model: int, cfg: SSMConfig,
                   dtype=torch.float32, device=None) -> SSMCache:
    d_in, n_heads, d_conv_ch = _dims(d_model, cfg)
    return SSMCache(
        state=torch.zeros((batch, n_heads, cfg.head_dim, cfg.d_state),
                          dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.d_conv - 1, d_conv_ch), dtype=dtype,
                         device=device),
        idx=torch.zeros((), dtype=torch.int32, device=device))


def ssd_decode(params, x: torch.Tensor, cache: SSMCache, cfg: SSMConfig,
               d_model: int):
    """One-token decode. x: (B,1,d) -> (out (B,1,d), cache).  O(1): the
    state and the conv tail are updated IN PLACE; the cache passed in is
    consumed and the one returned holds the same tensors and ``idx + 1``."""
    b = x.shape[0]
    d_in, n_heads, _ = _dims(d_model, cfg)
    g, n = cfg.n_groups, cfg.d_state
    rep = n_heads // g

    proj = x @ params["w_in"].to(x.dtype)
    z, xbc, dt = _split_proj(proj, d_in, g, n)

    # conv with the cached tail
    conv_out, tail = causal_conv(xbc, params["conv_w"], cache.conv)
    cache.conv.copy_(tail)
    xi, Bm, Cm = torch.split(F.silu(conv_out[:, 0]), [d_in, g * n, g * n],
                             dim=-1)

    dt1 = F.softplus(dt[:, 0].to(torch.float32) + params["dt_bias"])  # (B,H)
    xh = xi.reshape(b, n_heads, cfg.head_dim).to(torch.float32)
    Bh = Bm.reshape(b, g, 1, n).expand(b, g, rep, n).reshape(b, n_heads, n)
    Ch = Cm.reshape(b, g, 1, n).expand(b, g, rep, n).reshape(b, n_heads, n)
    Bh, Ch = Bh.to(torch.float32), Ch.to(torch.float32)

    dA = torch.exp(dt1 * (-torch.exp(params["A_log"].to(torch.float32))))
    state = cache.state
    state.mul_(dA[..., None, None])
    state.addcmul_((dt1[..., None] * xh)[..., None], Bh[:, :, None, :])
    y = (state @ Ch[..., None])[..., 0]                          # (B,H,p)
    y = y + params["D"].to(torch.float32)[:, None] * xh
    out = _gated_out(params, y.reshape(b, 1, d_in).to(x.dtype), z, x.dtype)
    return out, cache._replace(idx=cache.idx + 1)
