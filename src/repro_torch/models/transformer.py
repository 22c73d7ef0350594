"""TransformerLM: composes the attention / MLA / MoE / SSD / RG-LRU blocks
of a :class:`~repro_torch.models.config.ModelConfig` into a trainable LM,
an encoder-decoder (whisper: ``encode_frames`` and cross-attention) or a
VLM (prefix patch embeddings through ``prefix_proj``).  Functional:
parameters are nested dicts (and the ``blocks`` list) of fp32 tensors in
the reference's layout, so
:func:`~repro_torch.models.paper_models.params_from_jax` hands a JAX
model's values over and ``jax.tree.flatten`` order lines up (a MoE block
is ``mix, moe, norm1, norm2``, its ``moe`` dict ``router, shared_0, ...,
w_down, w_gate, w_up``; an SSD block ``mix, norm1``; a decoder block of
an encoder-decoder adds ``cross, norm_x``).

Counterpart of ``repro/models/transformer.py``:

    init_model(cfg, key)                  -> params
    forward(params, cfg, tokens, ...)     -> (logits, aux_loss)
    lm_loss(params, cfg, tokens, labels)  -> scalar (chunked LM head optional)
    init_cache(cfg, batch, s_cache)       -> per-layer cache list
    decode_step(params, cfg, token, caches, ...) -> (logits, caches)
    encode_frames(params, cfg, frames)    -> encoder memory

``forward``'s aux loss is the MoE load-balance loss summed over the
blocks (0 without MoE), and ``lm_loss`` adds it.  ``cfg.remat``
checkpoints each block (``torch.utils.checkpoint``, not reentrant) while
autograd records; with grad off (prefill, under
``torch.inference_mode``) there is nothing to recompute, and the blocks
run plainly.  ``decode_step`` writes each layer's cache in place
(:func:`repro_torch.models.attention.attn_decode`,
:func:`repro_torch.models.mla.mla_decode`,
:func:`repro_torch.models.ssm.ssd_decode`,
:func:`repro_torch.models.rglru.rglru_decode`); the SSD and RG-LRU caches
are fixed-size recurrent states, whatever ``s_cache``.
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import attention, mla, moe, rglru, ssm
from ..device import resolve_device
from .config import ModelConfig
from .layers import embed_init, mlp_apply, mlp_init, rms_norm, rms_norm_init

__all__ = ["init_model", "forward", "lm_loss", "init_cache", "decode_step",
           "encode_frames"]


def _generator(key) -> torch.Generator:
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator().manual_seed(int(key))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_block(cfg: ModelConfig, kind: str, gen: torch.Generator,
                layer_idx: int) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    block: dict[str, Any] = {"norm1": rms_norm_init(d)}
    if kind in ("attn", "local"):
        block["mix"] = attention.attn_init(gen, d, cfg.n_heads,
                                           cfg.n_kv_heads, hd,
                                           bias=cfg.attn_bias)
    elif kind == "mla":
        block["mix"] = mla.mla_init(gen, d, cfg.n_heads, cfg.mla)
    elif kind == "ssd":
        block["mix"] = ssm.ssd_init(gen, d, cfg.ssm)
    elif kind == "rglru":
        block["mix"] = rglru.rglru_init(gen, d, cfg.rglru)
    else:
        raise ValueError(kind)
    if kind != "ssd":  # mamba2 blocks have no separate MLP
        block["norm2"] = rms_norm_init(d)
        if cfg.moe is not None and layer_idx >= cfg.moe.first_dense:
            block["moe"] = moe.moe_init(gen, d, cfg.moe, cfg.mlp_act)
        else:
            block["mlp"] = mlp_init(gen, d, cfg.d_ff, cfg.mlp_act)
    if cfg.encoder is not None:  # decoder layers get cross-attention
        block["norm_x"] = rms_norm_init(d)
        block["cross"] = attention.attn_init(gen, d, cfg.n_heads,
                                             cfg.n_heads, hd)
    return block


def init_model(cfg: ModelConfig, key=0, device=None) -> dict:
    """Random fp32 parameters from ``key`` (a seed or a CPU
    ``torch.Generator``), drawn on the CPU and moved to ``device``.

    ``device="meta"`` builds the same tree -- paths, shapes, dtypes and
    leaf order -- of shape stand-ins through the same init functions:
    nothing is drawn (``key`` is not read) and nothing is allocated, so a
    14 G-parameter config costs no host memory."""
    if device is not None and torch.device(device).type == "meta":
        from ..core.compression import tree_map
        return tree_map(torch.Tensor.detach, _meta_params(cfg))
    params = _init_params(cfg, _generator(key))
    if device is not None:
        from ..core.compression import tree_map
        params = tree_map(lambda t: t.to(device), params)
    return params


@functools.lru_cache(maxsize=32)
def _meta_params(cfg: ModelConfig) -> dict:
    """The meta route's tree, built once a config (a meta tensor holds no
    storage; each caller gets its own containers and tensor objects)."""
    from ..core.compression import tree_map
    with torch.device("meta"):
        params = _init_params(cfg, torch.Generator())
    return tree_map(lambda t: t.to("meta"), params)


def _init_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """The parameter tree, every factory call on the current default
    device (the CPU, or ``meta`` inside ``torch.device("meta")``)."""
    d = cfg.d_model
    params: dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, d),
        "blocks": [_init_block(cfg, cfg.layer_kind(i), gen, i)
                   for i in range(cfg.n_layers)],
        "final_norm": rms_norm_init(d),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(gen, cfg.vocab_size, d)
    if cfg.encoder is not None:
        params["encoder"] = {
            "blocks": [{
                "norm1": rms_norm_init(d),
                "mix": attention.attn_init(gen, d, cfg.n_heads, cfg.n_heads,
                                           cfg.resolved_head_dim),
                "norm2": rms_norm_init(d),
                "mlp": mlp_init(gen, d, cfg.d_ff, cfg.mlp_act),
            } for _ in range(cfg.encoder.n_layers)],
            "final_norm": rms_norm_init(d),
        }
    if cfg.n_prefix_tokens:
        # the reference stores the transpose of an embedding draw
        params["prefix_proj"] = embed_init(gen, d, d).T.contiguous()
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _uses_window(cfg: ModelConfig, kind: str) -> bool:
    """'local' layers, and every layer of a pure-attn config with a
    sliding window (the long_500k dense variant), attend a window."""
    return kind == "local" or bool(cfg.sliding_window and
                                   len(cfg.block_pattern) == 1)


def _ffn(block, h, cfg: ModelConfig):
    """The block's FFN on ``h``: ``(out, aux)``, aux the MoE's load-balance
    loss (a zero for a dense MLP)."""
    if "moe" in block:
        return moe.moe_apply(block["moe"], h, cfg.moe, cfg.mlp_act)
    mlp = {name: w.to(h.dtype) for name, w in block["mlp"].items()}
    return (mlp_apply(mlp, h, cfg.mlp_act),
            torch.zeros((), dtype=torch.float32, device=h.device))


def _block_apply(block, x, memory, *, cfg: ModelConfig, kind: str,
                 chunk: int):
    h = rms_norm(block["norm1"], x, cfg.norm_eps)
    if kind in ("attn", "local"):
        window = cfg.sliding_window if _uses_window(cfg, kind) else 0
        x = x + attention.attn_apply(
            block["mix"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
            causal=True, window=window, chunk=chunk)
    elif kind == "mla":
        x = x + mla.mla_apply(block["mix"], h, n_heads=cfg.n_heads,
                              cfg=cfg.mla, rope_theta=cfg.rope_theta,
                              chunk=chunk, window=cfg.sliding_window)
    elif kind == "ssd":
        x = x + ssm.ssd_apply(block["mix"], h, cfg.ssm, cfg.d_model)
    else:
        x = x + rglru.rglru_apply(block["mix"], h, cfg.rglru, cfg.d_model)
    if memory is not None and "cross" in block:
        hx = rms_norm(block["norm_x"], x, cfg.norm_eps)
        x = x + attention.attn_apply(
            block["cross"], hx, n_heads=cfg.n_heads, n_kv_heads=cfg.n_heads,
            head_dim=cfg.resolved_head_dim, memory=memory, chunk=chunk)
    if kind == "ssd":
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    out, aux = _ffn(block, rms_norm(block["norm2"], x, cfg.norm_eps), cfg)
    return x + out, aux


def encode_frames(params, cfg: ModelConfig, frames: torch.Tensor,
                  chunk: int = 1024) -> torch.Tensor:
    """Run the (whisper) encoder over stub frame embeddings (B, F, d):
    bidirectional attention blocks, in ``frames``' dtype."""
    x = frames
    for block in params["encoder"]["blocks"]:
        h = rms_norm(block["norm1"], x, cfg.norm_eps)
        x = x + attention.attn_apply(
            block["mix"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_heads,
            head_dim=cfg.resolved_head_dim, causal=False, chunk=chunk)
        mlp = {name: w.to(x.dtype) for name, w in block["mlp"].items()}
        x = x + mlp_apply(mlp, rms_norm(block["norm2"], x, cfg.norm_eps),
                          cfg.mlp_act)
    return rms_norm(params["encoder"]["final_norm"], x, cfg.norm_eps)


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, *,
            prefix: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None,
            compute_dtype=torch.bfloat16, chunk: int = 1024,
            return_hidden: bool = False):
    """tokens: (B, S) integers.  prefix: (B, P, d) VLM patch embeddings,
    projected and put before the tokens.  frames: (B, F, d) audio frame
    embeddings, encoded into the cross-attention memory.  Returns (logits
    (B, P + S, V), aux_loss); the aux loss is the MoE blocks' load-balance
    loss summed over the blocks (0 without MoE)."""
    x = F.embedding(tokens.long(), params["embed"]).to(compute_dtype)
    if prefix is not None:
        pfx = (prefix.to(compute_dtype) @
               params["prefix_proj"].to(compute_dtype))
        x = torch.cat([pfx, x], dim=1)
    memory = None
    if frames is not None:
        memory = encode_frames(params, cfg, frames.to(compute_dtype), chunk)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, block in enumerate(params["blocks"]):
        fn = functools.partial(_block_apply, cfg=cfg, kind=cfg.layer_kind(i),
                               chunk=chunk)
        if cfg.remat and torch.is_grad_enabled():
            x, aux_i = checkpoint(fn, block, x, memory, use_reentrant=False)
        else:
            x, aux_i = fn(block, x, memory)
        aux = aux + aux_i
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    if return_hidden:
        return x, aux
    head = params.get("lm_head", params["embed"])
    return x @ head.T.to(compute_dtype), aux


def lm_loss(params, cfg: ModelConfig, tokens: torch.Tensor,
            labels: torch.Tensor, *, prefix=None, frames=None,
            compute_dtype=torch.bfloat16, chunk: int = 1024) -> torch.Tensor:
    """Causal LM cross-entropy (mean over the text tokens) + the aux loss.

    The log-sum-exp runs in fp32 on fp32 logits.  With ``cfg.logit_chunk >
    0`` the LM head and softmax run in sequence chunks, never materializing
    the full (B, S, V) logits.
    """
    hidden, aux = forward(params, cfg, tokens, prefix=prefix, frames=frames,
                          compute_dtype=compute_dtype, chunk=chunk,
                          return_hidden=True)
    if prefix is not None:
        hidden = hidden[:, prefix.shape[1]:]     # loss only on text tokens
    head = params.get("lm_head", params["embed"]).T.to(compute_dtype)
    labels = labels.long()

    def ce(h_chunk, y_chunk):
        logits = (h_chunk @ head).to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, y_chunk[..., None], dim=-1)[..., 0]
        return torch.sum(logz - gold)

    b, s, _ = hidden.shape
    lc = cfg.logit_chunk
    if lc and s > lc and s % lc == 0:
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for c0 in range(0, s, lc):
            total = total + ce(hidden[:, c0:c0 + lc], labels[:, c0:c0 + lc])
    else:
        total = ce(hidden, labels)
    return total / (b * s) + aux


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, s_cache: int,
               dtype=torch.bfloat16, device=None) -> list:
    """Per-layer caches on ``device`` (the card unless ``"cpu"``).
    Windowed attention layers (``_uses_window``) get a ring buffer of the
    window when it is shorter than ``s_cache``; the other attention layers
    ``s_cache`` slots; MLA layers a latent cache of ``s_cache`` slots
    whatever the window (the reference's rule); SSD and RG-LRU layers their
    recurrent state and conv tail, whatever ``s_cache``."""
    device = resolve_device(device)
    caches = []
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        if kind == "mla":
            caches.append(mla.init_mla_cache(batch, s_cache, cfg.mla, dtype,
                                             device=device))
            continue
        if kind == "ssd":
            caches.append(ssm.init_ssm_cache(batch, cfg.d_model, cfg.ssm,
                                             dtype, device=device))
            continue
        if kind == "rglru":
            caches.append(rglru.init_rglru_cache(batch, cfg.d_model,
                                                 cfg.rglru, dtype,
                                                 device=device))
            continue
        use_window = _uses_window(cfg, kind)
        window = cfg.sliding_window
        size = min(window, s_cache) if use_window and window else s_cache
        caches.append(attention.init_kv_cache(
            batch, size, cfg.n_kv_heads, cfg.resolved_head_dim, dtype,
            ring=bool(use_window and window and size < s_cache),
            device=device))
    return caches


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, caches: list,
                *, memory: Optional[torch.Tensor] = None,
                compute_dtype=torch.bfloat16):
    """One decode step. token: (B, 1) integers -> (logits (B,1,V), caches).
    The caches passed in are consumed (written in place).  ``memory`` is
    the encoder output (:func:`encode_frames`) for the cross-attention
    blocks; without cross-attention blocks it goes unused, as in the
    reference."""
    x = F.embedding(token.long(), params["embed"]).to(compute_dtype)
    new_caches = []
    for i, (block, cache) in enumerate(zip(params["blocks"], caches)):
        kind = cfg.layer_kind(i)
        h = rms_norm(block["norm1"], x, cfg.norm_eps)
        if kind in ("attn", "local"):
            mix, new = attention.attn_decode(
                block["mix"], h, cache, n_heads=cfg.n_heads,
                n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
                rope_theta=cfg.rope_theta)
        elif kind == "mla":
            mix, new = mla.mla_decode(block["mix"], h, cache,
                                      n_heads=cfg.n_heads, cfg=cfg.mla,
                                      rope_theta=cfg.rope_theta)
        elif kind == "ssd":
            mix, new = ssm.ssd_decode(block["mix"], h, cache, cfg.ssm,
                                      cfg.d_model)
        else:
            mix, new = rglru.rglru_decode(block["mix"], h, cache, cfg.rglru,
                                          cfg.d_model)
        x = x + mix
        new_caches.append(new)
        if memory is not None and "cross" in block:
            # the reference hands the layer's cache in and drops what
            # comes back: cross-attention leaves it untouched
            hx = rms_norm(block["norm_x"], x, cfg.norm_eps)
            out, _ = attention.attn_decode(
                block["cross"], hx, cache, n_heads=cfg.n_heads,
                n_kv_heads=cfg.n_heads, head_dim=cfg.resolved_head_dim,
                memory=memory)
            x = x + out
        if kind != "ssd":
            out, _ = _ffn(block, rms_norm(block["norm2"], x, cfg.norm_eps),
                          cfg)
            x = x + out
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    head = params.get("lm_head", params["embed"])
    return x @ head.T.to(compute_dtype), new_caches
