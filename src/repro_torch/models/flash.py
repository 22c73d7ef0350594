"""Flash-style attention with a hand-written backward, in plain PyTorch.

Counterpart of ``repro/models/flash.py`` (pure jnp with a ``custom_vjp``;
no Pallas kernel).  The forward scans the KV chunks with an online softmax
and keeps only ``(q, k, v, out, lse)`` -- O(S·d) -- for the backward, which
recomputes the probability blocks chunk by chunk, as the FlashAttention
backward does:

    D    = rowsum(dO ⊙ O)
    p_c  = exp(q·k_cᵀ·scale - lse)
    dV_c = p_cᵀ · dO
    dP_c = dO · v_cᵀ
    dS_c = p_c ⊙ (dP_c - D)
    dQ  += scale · dS_c · k_c ;   dK_c = scale · dS_cᵀ · q

GQA grouping, causal masks, sliding windows, cross attention and a
v-head-dim other than the qk-head-dim are supported.  Scores, softmax
statistics and accumulators are fp32 (the reference's ``P_BLOCK_DTYPE``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["flash_attention"]

NEG_INF = -1e30


def _scale(hd: int, device) -> torch.Tensor:
    # 1 / sqrt(fp32(hd)), in fp32 as the reference computes it
    return 1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32,
                                         device=device))


def _chunk_kv(x: torch.Tensor, chunk: int) -> torch.Tensor:
    """(B, Skv, KV, h) -> (n_chunks, B, chunk, KV, h), zero-padded."""
    b, skv, kv, h = x.shape
    n_chunks = -(-skv // chunk)
    pad = n_chunks * chunk - skv
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
    return x.reshape(b, n_chunks, chunk, kv, h).permute(1, 0, 2, 3, 4)


def _mask(q_pos, kv_pos, skv: int, causal: bool, window: int):
    valid = (kv_pos[None, :] < skv).expand(q_pos.shape[0], -1)
    if causal:
        valid = valid & (kv_pos[None, :] <= q_pos[:, None])
    if window:
        valid = valid & (kv_pos[None, :] > q_pos[:, None] - window)
    return valid                                    # (Sq, C)


def _fwd_scan(q, k, v, causal, window, chunk, q_offset):
    b, sq, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    hdv = v.shape[3]
    rep = h // kv
    scale = _scale(hd, q.device)
    chunk = min(chunk, skv)

    qg = q.reshape(b, sq, kv, rep, hd).to(torch.float32) * scale
    kc = _chunk_kv(k, chunk)
    vc = _chunk_kv(v, chunk)
    q_pos = q_offset + torch.arange(sq, device=q.device)

    m = torch.full((b, kv, rep, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kv, rep, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kv, rep, sq, hdv), dtype=torch.float32,
                      device=q.device)
    for ci in range(kc.shape[0]):
        kv_pos = ci * chunk + torch.arange(chunk, device=q.device)
        s = torch.einsum("bqgrd,bcgd->bgrqc", qg, kc[ci].to(torch.float32))
        valid = _mask(q_pos, kv_pos, skv, causal, window)
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bgrqc,bcgd->bgrqd", p, vc[ci].to(torch.float32))
        acc = acc * corr[..., None] + pv
        m = m_new
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                      torch.full_like(l, 1e30))
    out = acc / torch.clamp(l, min=1e-30)[..., None]    # (b,kv,rep,sq,hdv)
    return out, lse


def _to_bshd(out: torch.Tensor, dtype) -> torch.Tensor:
    b, kv, rep, sq, hdv = out.shape
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, kv * rep, hdv).to(dtype)


def _flash_bwd(q, k, v, out, lse, do, causal, window, chunk, q_offset):
    b, sq, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    hdv = v.shape[3]
    rep = h // kv
    scale = _scale(hd, q.device)
    chunk_sz = min(chunk, skv)

    qg = q.reshape(b, sq, kv, rep, hd).to(torch.float32)
    dog = (do.reshape(b, sq, kv, rep, hdv).permute(0, 2, 3, 1, 4)
             .to(torch.float32))                    # (b,kv,rep,sq,hdv)
    dmass = (dog * out).sum(dim=-1)                 # D: (b,kv,rep,sq)

    kc = _chunk_kv(k, chunk_sz)
    vc = _chunk_kv(v, chunk_sz)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    dq = torch.zeros((b, sq, kv, rep, hd), dtype=torch.float32,
                     device=q.device)
    dks, dvs = [], []
    for ci in range(kc.shape[0]):
        kch = kc[ci].to(torch.float32)
        vch = vc[ci].to(torch.float32)
        kv_pos = ci * chunk_sz + torch.arange(chunk_sz, device=q.device)
        s = torch.einsum("bqgrd,bcgd->bgrqc", qg * scale, kch)
        valid = _mask(q_pos, kv_pos, skv, causal, window)
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        p = torch.exp(s - lse[..., None])                 # recomputed
        dvs.append(torch.einsum("bgrqc,bgrqd->bcgd", p, dog))
        dp = torch.einsum("bgrqd,bcgd->bgrqc", dog, vch)
        ds = p * (dp - dmass[..., None]) * scale
        dq = dq + torch.einsum("bgrqc,bcgd->bqgrd", ds, kch)
        dks.append(torch.einsum("bgrqc,bqgrd->bcgd", ds, qg))
    dk = torch.cat(dks, dim=1)[:, :skv]
    dv = torch.cat(dvs, dim=1)[:, :skv]
    return (dq.reshape(b, sq, h, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk, q_offset):
        out, lse = _fwd_scan(q, k, v, causal, window, chunk, q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, chunk, q_offset)
        return _to_bshd(out, q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    chunk: int = 1024, q_offset: int = 0):
    """q: (B,Sq,H,hd); k/v: (B,Skv,KV,hd[v]). Returns (B,Sq,H,hdv)."""
    return _FlashAttention.apply(q, k, v, causal, window, chunk, q_offset)
