"""Serving steps: prefill (a full forward over the prompt) and decode (one
new token against the KV, latent or recurrent-state caches of
:func:`repro_torch.models.init_cache`).

Counterpart of ``repro/launch/serve.py``.  Both steps run under
``torch.inference_mode()`` on the device the step was made for (the card
unless ``device="cpu"``); the parameters and caches must live there, and
token, prefix and frame inputs are moved there.  The decode step writes
the caches in place and, but for MoE layers, makes no host sync, so a
loop of steps runs
ahead of the host; a MoE layer reads its experts' group sizes to the host,
one sync a layer a step (:mod:`repro_torch.models.moe`).

The batch axis is the caller's to shard: on a mesh with client axes
(``pod``, ``data``) each rank passes its own rows, and no collective is
needed.  ``cache_mode`` takes the reference's values; they only pin
layouts under GSPMD, so on a mesh whose ``model`` axis is 1 every mode
gives the same values.  ``model > 1`` raises ``NotImplementedError``: the
port does not run tensor parallelism yet (ROADMAP Queue 1).
:func:`serve_state_structs` gives the sharded shape stand-ins of a serve
step's parameters and caches on any mesh, for the dry run.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.transformer import decode_step, forward, init_cache, init_model
from ..sharding.rules import (Sharding, StandIn, cache_specs, fit_spec,
                              map_tree, param_shardings)
from .train import _TENSOR_PARALLEL

__all__ = ["CACHE_MODES", "make_prefill_step", "make_decode_step",
           "serve_state_structs"]

CACHE_MODES = ("heads", "batch", "local", "seq")


def _check(cfg: ModelConfig, mesh) -> None:
    if mesh.shape.get("model", 1) > 1:
        raise NotImplementedError(_TENSOR_PARALLEL)


def make_prefill_step(cfg: ModelConfig, mesh, compute_dtype=torch.bfloat16,
                      device=None):
    """``prefill(params, batch) -> logits`` (batch: dict of inputs, with
    ``tokens`` (B, S), and ``prefix`` (B, P, d) or ``frames`` (B, F, d)
    where the arch takes them).  The logits are the LAST position's only,
    (B, 1, V): the realistic serving prefill, which never holds (B, S,
    V)."""
    _check(cfg, mesh)
    device = resolve_device(device)

    def prefill(params, batch):
        with torch.inference_mode():
            extra = {name: (None if batch.get(name) is None else
                            torch.as_tensor(batch[name]).to(device))
                     for name in ("prefix", "frames")}
            hidden, _ = forward(params, cfg,
                                torch.as_tensor(batch["tokens"]).to(device),
                                compute_dtype=compute_dtype,
                                return_hidden=True, **extra)
            head = params.get("lm_head", params["embed"])
            return hidden[:, -1:, :] @ head.T.to(hidden.dtype)

    return prefill


def make_decode_step(cfg: ModelConfig, mesh, compute_dtype=torch.bfloat16,
                     cache_mode: str = "heads", device=None):
    """``decode(params, token, caches, memory=None) -> (logits, caches)``.

    ``token`` is (B, 1); the caches passed in are consumed (written in
    place) and come back with their ``idx`` advanced on the device.
    ``memory`` is an encoder-decoder's encoder output
    (:func:`repro_torch.models.encode_frames`), on the device."""
    if cache_mode not in CACHE_MODES:
        raise ValueError(f"unknown cache_mode {cache_mode!r}; options: "
                         f"{CACHE_MODES}")
    _check(cfg, mesh)
    device = resolve_device(device)

    def decode(params, token, caches, memory=None):
        with torch.inference_mode():
            return decode_step(params, cfg, torch.as_tensor(token).to(device),
                               caches, memory=memory,
                               compute_dtype=compute_dtype)

    return decode


def serve_state_structs(cfg: ModelConfig, mesh, batch: int, s_cache: int,
                        cache_dtype=torch.bfloat16, cache_mode=None):
    """``(params, caches)`` as sharded shape stand-ins
    (:class:`~repro_torch.sharding.rules.StandIn`: a ``meta`` tensor and
    its sharding; a cache's ``ring`` flag stays a bool): the parameters of
    :func:`~repro_torch.models.init_model` and the caches of
    :func:`~repro_torch.models.init_cache` for ``batch`` sequences of
    ``s_cache`` positions, with nothing allocated.  ``cache_mode``
    (``"heads"`` / ``"hd"``) is the caches' split over ``model`` (default
    :data:`repro_torch.sharding.rules.CACHE_SHARD_MODE`)."""
    params = init_model(cfg, device="meta")
    params_struct = map_tree(lambda _, p, sh: StandIn(p, sh), params,
                             param_shardings(params, mesh))
    caches = init_cache(cfg, batch, s_cache, cache_dtype, device="meta")
    specs = cache_specs(caches, mesh, batch, cache_mode)

    def attach(_, leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return StandIn(leaf, Sharding(mesh, fit_spec(spec, tuple(leaf.shape),
                                                     mesh)))

    return params_struct, map_tree(attach, caches, specs)
