"""Dry run: size every (architecture x input shape) on a mesh -- the
production meshes or one card -- with no parameter drawn and nothing
allocated.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
        --shape train_4k [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \\
        [--device cpu] [--out DIR]

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
step with XLA and reads its ``memory_analysis()`` and ``cost_analysis()``.
PyTorch has no such analysis, so the port counts from the config:

* memory: the step's arguments as shape stand-ins on the ``meta`` device
  (:func:`repro_torch.launch.train.state_shardings`,
  :func:`repro_torch.launch.serve.serve_state_structs`), each paired with
  its sharding; a device's bytes are the sum of its shards;
* ``flops``: the matmul FLOPs the port's step executes (:func:`step_flops`),
  counted as ``torch.utils.flop_counter.FlopCounterMode`` counts them:
  2·m·k·n a product, the backward's products, remat's recompute, the flash
  scan's every chunk (causally masked and zero-padded ones included), the
  ragged MoE's tokens x top-k rows, the SSD's chunk products;
* ``bytes_accessed``: the step's arguments read once and its outputs
  written once, a device (what the roofline's memory term divides);
* ``model_flops``: 6·N_active·tokens for train, 2·N_active·tokens for
  prefill and decode (global, as ``benchmarks/roofline.py`` counts it);
* ``collectives``: the tree codec's one ``all_reduce`` of the flat fp32
  message over the client ranks (:mod:`repro_torch.core.distributed`),
  a device's shard of it; and, where the step runs the ``model`` axis (the
  attention family, dense or MoE, on every split ``fit_spec`` makes),
  tensor parallelism's collectives over a client's model group as the step
  hands them to gloo (:func:`tp_collectives`): the split products'
  ``all_reduce`` s, the MoE gates' gradient sums, the attention's gather
  route's ``all_gather`` s, the vocab-parallel embedding's and
  cross-entropy's, and the split
  k-selection's; the selection's candidate gather is data-dependent and
  listed apart (``collectives_data_dependent``); and for the serve steps
  on such a mesh (:func:`tp_serve_collectives`), the embedding's and the
  split products' ``all_reduce`` s, the gather route's ``all_gather`` s
  and the logits' ``all_gather``;
* ``server_ingest`` and ``fleet_scenarios`` as the reference measures them,
  through the port's :class:`~repro_torch.launch.train.WireLedger` (the
  ``"kernel"`` wire backend: ``pack_chunks`` on the card unless
  ``--device cpu``) and :func:`repro_torch.fed.events.simulate_scenario`.

What a record leaves out: ``temp_size_in_bytes`` (activations and
workspaces: nothing here measures them, so a record does not fit a step
into memory by itself); and, for a config the step does not run with
``model > 1`` (:func:`repro_torch.launch.train.tensor_parallel_gap`,
:func:`repro_torch.launch.serve.serve_gap`: MLA, SSD, RG-LRU,
encoder, prefix, the chunked STC, a decode's cache not in the ``"heads"``
layout), tensor parallelism's collectives, with its ``flops`` split over
``model`` evenly, an assumption.  Where the step runs it, ``flops`` is
one rank's count (:func:`step_flops` with ``model``): each product's
block, the whole product of a leaf kept whole, and the attention core on
the rank's heads, or on every head on the gather route.  The roofline
terms are the H100's (:mod:`repro_torch.launch.hardware`).  Records go to ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import time

import torch

from ..configs import (ARCH_IDS, INPUT_SHAPES, InputShape, get_config,
                       input_specs)
from ..core.compression import tree_leaves
from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.attention import core_heads
from ..models.moe import capacity
from ..models.transformer import _uses_window, init_model
from ..sharding.rules import (Sharding, StandIn, batch_spec, map_tree,
                              shard_tree)
from . import hardware
from .mesh import Mesh, make_debug_mesh, make_production_mesh
from .serve import serve_gap, serve_state_structs
from .train import (TrainConfig, WireLedger, batch_shardings, codec_for,
                    init_train_state, state_shardings, tensor_parallel_gap)

__all__ = ["lower_combo", "save_record", "main", "measured_ingest_bytes",
           "fleet_event_stats", "step_flops", "model_flops",
           "tp_collectives", "tp_serve_collectives"]

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                         "artifacts", "dryrun_torch")

CHUNK = 1024        # the attention scan's chunk (forward's and lm_loss's)


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------


def _mm(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


class _Splits:
    """One of ``model`` ranks' widths of an attention config's split leaves,
    read off its blocks of a meta model cut to its first MoE layer
    (:func:`~repro_torch.sharding.rules.shard_tree`, which cuts each leaf
    as ``fit_spec`` does): ``cols`` of ``wq``, ``wk``, ``d_ff`` (a dense
    block's), ``d_expert`` (a MoE block's experts, routed and shared) and
    the vocabulary; which of them ``model`` splits (a leaf kept whole keeps
    its width, and its product runs replicated); and the heads its
    attention core runs (:func:`~repro_torch.models.attention.core_heads`).
    At ``model = 1`` every width is whole."""

    def __init__(self, cfg: ModelConfig, model: int):
        hd = cfg.resolved_head_dim
        self.q_width = cfg.n_heads * hd
        whole = {"q": self.q_width, "kv": cfg.n_kv_heads * hd,
                 "ff": cfg.d_ff, "vocab": cfg.vocab_size,
                 "expert": cfg.moe.d_expert if cfg.moe else 0}
        self.cols = dict(whole)
        if model > 1:
            layers = 1 if cfg.moe is None else cfg.moe.first_dense + 1
            meta = init_model(dataclasses.replace(cfg, n_layers=layers),
                              device="meta")
            rank = shard_tree(meta, make_debug_mesh(1, model), 0)
            first, last = rank["blocks"][0], rank["blocks"][-1]
            self.cols.update(q=first["mix"]["wq"].shape[1],
                             kv=first["mix"]["wk"].shape[1],
                             vocab=rank["embed"].shape[0])
            if "mlp" in first:
                self.cols["ff"] = first["mlp"]["w_down"].shape[0]
            if "moe" in last:
                self.cols["expert"] = last["moe"]["w_down"].shape[1]
        self.q, self.kv, self.mlp, self.expert, self.vocab = (
            self.cols[n] < whole[n]
            for n in ("q", "kv", "ff", "expert", "vocab"))
        self.core, _ = core_heads(cfg.n_heads, cfg.n_kv_heads, model)
        self.heads = model == 1 or self.core < cfg.n_heads
        # the gather route's joined q/k/v columns a token (all ranks')
        self.gathered = (0 if self.heads else
                         (cfg.n_heads * self.q + 2 * cfg.n_kv_heads * self.kv)
                         * hd)

    def ffn(self, cfg: ModelConfig, i: int) -> bool:
        """Whether layer ``i``'s FFN (its MLP or its experts) is split."""
        return self.expert if _is_moe(cfg, i) else self.mlp


def _is_moe(cfg: ModelConfig, i: int) -> bool:
    return cfg.moe is not None and i >= cfg.moe.first_dense


@functools.lru_cache(maxsize=None)
def _splits(cfg: ModelConfig, model: int) -> _Splits:
    return _Splits(cfg, model)


class _Count:
    """Forward and backward FLOPs, and the forward FLOPs of the product
    that ends each block (remat's recompute stops before it: the
    checkpoint stops once the last tensor the backward saves is
    recomputed, and a product saves its inputs before it runs)."""

    def __init__(self):
        self.fwd = self.bwd = 0
        self.last = 0

    def mm(self, m, k, n, grads: int = 2):
        """A product; ``grads`` of its two inputs take a gradient."""
        f = _mm(m, k, n)
        self.fwd += f
        self.bwd += grads * f
        self.last = f

    def extra(self, fwd, bwd):
        self.fwd += fwd
        self.bwd += bwd
        self.last = 0


def _flash(c: _Count, b, h, sq, skv, hd, hdv):
    """The flash scan (models/flash.py): every chunk of the padded keys,
    two products a chunk forward, five backward (one recomputes the
    scores)."""
    ch = min(CHUNK, skv)
    keys = -(-skv // ch) * ch
    c.extra(2 * b * h * sq * keys * (hd + hdv),
            2 * b * h * sq * keys * (3 * hd + 2 * hdv))


def _attn(c: _Count, cfg: ModelConfig, b, s, *, kv_heads=None, memory=0,
          sp=None):
    """Self-attention over s positions, or cross-attention over ``memory``
    positions (k and v projected from the memory); with ``sp`` (a
    :class:`_Splits`) one rank's share of self-attention."""
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    kv = cfg.n_kv_heads if kv_heads is None else kv_heads
    t, skv = b * s, (memory or s)
    q_cols, kv_cols, core = ((h * hd, kv * hd, h) if sp is None else
                             (sp.cols["q"], sp.cols["kv"], sp.core))
    c.mm(t, d, q_cols)
    c.mm(b * skv, d, kv_cols)
    c.mm(b * skv, d, kv_cols)
    _flash(c, b, core, s, skv, hd, hd)
    c.mm(t, q_cols, d)


def _mla(c: _Count, cfg: ModelConfig, b, s):
    m, d, h, t = cfg.mla, cfg.d_model, cfg.n_heads, b * s
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    c.mm(t, d, h * qk)
    c.mm(t, d, m.kv_lora_rank)
    c.mm(t, m.kv_lora_rank, h * m.qk_nope_head_dim)
    c.mm(t, m.kv_lora_rank, h * m.v_head_dim)
    c.mm(t, d, m.qk_rope_head_dim)
    _flash(c, b, h, s, s, qk, m.v_head_dim)
    c.mm(t, h * m.v_head_dim, d)


def _ssd(c: _Count, cfg: ModelConfig, b, s):
    """The SSD mixer: in-projection, the chunk scan's four batched
    products (with one chunk the per-chunk states feed only the discarded
    final state, and the incoming state is a constant), out-projection."""
    sc, d = cfg.ssm, cfg.d_model
    d_in = sc.expand * d
    h, p, g, n = d_in // sc.head_dim, sc.head_dim, sc.n_groups, sc.d_state
    c.mm(b * s, d, 2 * d_in + 2 * g * n + h)
    L = min(sc.chunk, s)
    nc = s // L
    scores = 2 * b * nc * g * L * L * n
    diag = 2 * b * nc * h * L * L * p
    states = 2 * b * nc * h * p * L * n
    off = 2 * b * nc * h * L * n * p
    c.extra(scores + diag + states + off,
            2 * (scores + diag) + (2 * (states + off) if nc > 1 else off))
    c.mm(b * s, d_in, d)


def _rglru(c: _Count, cfg: ModelConfig, b, s):
    d, w, t = cfg.d_model, cfg.rglru.block_width or cfg.d_model, b * s
    c.mm(t, d, w)
    c.mm(t, w, w)
    c.mm(t, w, w)
    c.mm(t, w, d)


def _mlp(c: _Count, cfg: ModelConfig, t, f):
    d = cfg.d_model
    c.mm(t, d, f)
    if cfg.mlp_act == "swiglu":
        c.mm(t, d, f)
    c.mm(t, f, d)


def _moe(c: _Count, cfg: ModelConfig, t, f):
    """Router (whole on every rank), the routed experts at the hidden width
    ``f`` (tokens x top-k rows ragged, experts x capacity rows in the
    capacity dispatch), the shared experts at ``f``."""
    m, d = cfg.moe, cfg.d_model
    c.mm(t, d, m.n_experts)
    rows = (t * m.top_k if m.dispatch != "capacity"
            else m.n_experts * capacity(m, t))
    _mlp(c, cfg, rows, f)
    c.last = 0                  # the combine's gate product saves after
    for _ in range(m.n_shared):
        _mlp(c, cfg, t, f)


def _ffn(c: _Count, cfg: ModelConfig, i, t, sp: _Splits):
    if _is_moe(cfg, i):
        _moe(c, cfg, t, sp.cols["expert"])
    else:
        _mlp(c, cfg, t, sp.cols["ff"])


def _forward(cfg: ModelConfig, b, s, frames: int, remat: bool,
             model: int = 1) -> _Count:
    """The model's forward over ``s`` positions (prefix included) and its
    backward, the LM head excluded; with ``remat`` the blocks' recompute is
    added to the backward.  ``model`` > 1: one rank's share under tensor
    parallelism (the attention family, dense or MoE)."""
    total, sp = _Count(), _splits(cfg, model)
    d = cfg.d_model
    if cfg.n_prefix_tokens:
        total.mm(b * cfg.n_prefix_tokens, d, d, grads=1)
    if frames:
        for _ in range(cfg.encoder.n_layers):
            _attn(total, cfg, b, frames, kv_heads=cfg.n_heads)
            _mlp(total, cfg, b * frames, cfg.d_ff)
    for i in range(cfg.n_layers):
        c = _Count()
        kind = cfg.layer_kind(i)
        if kind in ("attn", "local"):
            _attn(c, cfg, b, s, sp=sp)
        elif kind == "mla":
            _mla(c, cfg, b, s)
        elif kind == "ssd":
            _ssd(c, cfg, b, s)
        else:
            _rglru(c, cfg, b, s)
        if frames:
            _attn(c, cfg, b, s, kv_heads=cfg.n_heads, memory=frames)
        if kind != "ssd":
            _ffn(c, cfg, i, b * s, sp)
        total.extra(c.fwd, c.bwd + (c.fwd - c.last if remat else 0))
    return total


def _decode(cfg: ModelConfig, b, s_cache, memory: int, model: int = 1) -> int:
    """One decode step: each layer against its cache (a ring of the window
    on windowed layers), cross-attention re-projecting the memory; one
    rank's share over ``model`` ranks."""
    c = _Count()
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    sp = _splits(cfg, model)
    q_cols, kv_cols, core = sp.cols["q"], sp.cols["kv"], sp.core
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        if kind in ("attn", "local"):
            window = cfg.sliding_window
            slots = (min(window, s_cache) if _uses_window(cfg, kind)
                     and window else s_cache)
            c.mm(b, d, q_cols)
            c.mm(b, d, kv_cols)
            c.mm(b, d, kv_cols)
            c.extra(4 * b * core * slots * hd, 0)
            c.mm(b, q_cols, d)
        elif kind == "mla":
            m = cfg.mla
            r, nope, rope = (m.kv_lora_rank, m.qk_nope_head_dim,
                             m.qk_rope_head_dim)
            c.mm(b, d, h * (nope + rope))
            c.mm(b, d, r)
            c.mm(b, d, rope)
            c.extra(2 * b * h * (nope * r + s_cache * (2 * r + rope) +
                                 r * m.v_head_dim), 0)
            c.mm(b, h * m.v_head_dim, d)
        elif kind == "ssd":
            sc = cfg.ssm
            d_in = sc.expand * d
            nh = d_in // sc.head_dim
            c.mm(b, d, 2 * d_in + 2 * sc.n_groups * sc.d_state + nh)
            c.extra(2 * b * nh * sc.head_dim * sc.d_state, 0)
            c.mm(b, d_in, d)
        else:
            _rglru(c, cfg, b, 1)
        if memory:
            c.mm(b, d, h * hd)
            c.mm(b * memory, d, h * hd)
            c.mm(b * memory, d, h * hd)
            c.extra(4 * b * h * memory * hd, 0)
            c.mm(b, h * hd, d)
        if kind != "ssd":
            _ffn(c, cfg, i, b, sp)
    c.mm(b, d, sp.cols["vocab"])
    return c.fwd


def step_flops(cfg: ModelConfig, kind: str, batch: int, seq: int, *,
               local_iters: int = 1, model: int = 1) -> int:
    """Matmul FLOPs of one step of the port on ``batch`` rows.

    ``train``: :func:`repro_torch.launch.train.make_train_step` on
    ``(batch, seq)`` tokens -- forward, backward and, with ``cfg.remat``,
    the blocks' recompute; ``local_iters`` microbatches (a codec's
    communication delay) each run on ``batch / local_iters`` rows.
    ``prefill``: :func:`repro_torch.launch.serve.make_prefill_step` over
    ``seq`` tokens, logits of the last position.  ``decode``:
    :func:`repro_torch.launch.serve.make_decode_step`, one token against
    caches of ``seq`` positions.  A VLM's prefix and an encoder-decoder's
    frames (or, at decode, its memory) come with the arch's input specs.

    ``model`` > 1 counts one rank of a tensor-parallel step of the
    attention family, dense or MoE: each product's block where
    ``fit_spec`` splits its leaf and the whole product where it keeps the
    leaf whole (the router always), and the attention core on the rank's
    heads, or on every head where the heads do not split (the gather
    route).
    """
    frames = cfg.encoder.n_frames if cfg.encoder is not None else 0
    if kind == "decode":
        return _decode(cfg, batch, seq, frames, model)
    s = seq + cfg.n_prefix_tokens
    d, v = cfg.d_model, _splits(cfg, model).cols["vocab"]
    if kind == "prefill":
        return (_forward(cfg, batch, s, frames, False, model).fwd +
                _mm(batch, d, v))
    if kind != "train":
        raise ValueError(f"unknown step kind {kind!r}")
    if batch % local_iters:
        raise ValueError(f"{batch} rows do not split into {local_iters} "
                         "microbatches")
    micro = batch // local_iters
    c = _forward(cfg, micro, s, frames, cfg.remat, model)
    head = _mm(micro * seq, d, v)
    return local_iters * (c.fwd + c.bwd + 3 * head)


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """MODEL_FLOPS (global): 6·N_active·tokens for train, 2·N_active·tokens
    forward-only; a decode step is one token a sequence."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


# ---------------------------------------------------------------------------
# the wire and the fleet
# ---------------------------------------------------------------------------


def _sample_bits(tc: TrainConfig, n_s: int, seed: int, wire_backend: str,
                 device) -> tuple:
    """The WireLedger's four bit columns for one sampled round of ``n_s``
    positions."""
    import numpy as np
    codec = codec_for(tc)
    if "wire_backend" in {f.name for f in dataclasses.fields(codec)}:
        codec = dataclasses.replace(codec, wire_backend=wire_backend)
    rng = np.random.default_rng(seed)
    k = max(int(n_s * getattr(codec, "sparsity_up", 1.0)), 1)
    up = np.zeros(n_s, np.float32)
    up[rng.choice(n_s, size=k, replace=False)] = \
        rng.choice((-1.0, 1.0), size=k) * 0.01
    kd = max(int(n_s * getattr(codec, "sparsity_down", 1.0)), 1)
    down = np.zeros(n_s, np.float32)
    down[rng.choice(n_s, size=kd, replace=False)] = \
        rng.choice((-1.0, 1.0), size=kd) * 0.01
    ledger = WireLedger(codec, n_s, device=device)
    ledger.record_round({"m": up[None]}, {"g": down})
    return (ledger.bits_up, ledger.bits_down, ledger.bits_up_analytic,
            ledger.bits_down_analytic)


def measured_ingest_bytes(tc: TrainConfig, numel: int, n_clients: int,
                          sample_cap: int = 1 << 22, seed: int = 0, *,
                          wire_backend: str = "kernel", device=None) -> dict:
    """Measured server ingest / broadcast bytes a round via the WireLedger.

    Encodes ONE sampled client update through the codec's actual wire
    format and scales to the full parameter count and cohort: measured bits
    a coded position are position-invariant up to the Golomb gap
    statistics, so a >= 2^22 sample pins the round's figure without a
    model-sized round.  The ``"kernel"`` wire backend packs on ``device``
    (the card unless ``"cpu"``, where ``pack_chunks`` runs its plain
    version); ``"numpy"`` packs on the host.  Codecs without a wire format
    report the ledger's analytic column in both fields."""
    n_s = min(numel, sample_cap)
    where = None if wire_backend != "kernel" else resolve_device(device)
    up, down, up_a, down_a = _sample_bits(tc, n_s, seed, wire_backend, where)
    scale = numel / n_s
    return {
        "bytes_up_round": up / 8.0 * scale * n_clients,
        "bytes_down_round": down / 8.0 * scale,
        "analytic_bytes_up_round": up_a / 8.0 * scale * n_clients,
        "analytic_bytes_down_round": down_a / 8.0 * scale,
        "sampled_numel": n_s,
        "n_clients": n_clients,
    }


def fleet_event_stats(n_clients: int, seed: int = 0) -> dict:
    """Per-scenario event statistics for the dry-run record: one
    model-free :func:`repro_torch.fed.events.simulate_scenario` pass (numpy
    only) a registered fleet scenario, sized to the mesh's client count --
    how often the K-arrival trigger fires and what fraction of uploads the
    fleet loses."""
    from ..fed.events import simulate_scenario
    from ..fed.scenarios import registered_scenarios
    cohort = max(n_clients // 8, 1)
    out = {}
    for name in registered_scenarios():
        st = simulate_scenario(name, n_clients=n_clients, cohort=cohort,
                               concurrency=2 * cohort, max_staleness=2,
                               aggregations=6, seed=seed)
        out[name] = {k: (round(v, 4) if isinstance(v, float) else v)
                     for k, v in st.items() if k != "scenario"}
    return out


# ---------------------------------------------------------------------------
# stand-ins
# ---------------------------------------------------------------------------


def _stand_ins(tree, shardings):
    return map_tree(lambda _, t, sh: StandIn(t, sh), tree, shardings)


def train_structs(cfg: ModelConfig, tc: TrainConfig, mesh: Mesh):
    """The train state as sharded stand-ins of its GLOBAL shapes: the
    client-major buffers with ``n_clients`` rows, a device one row."""
    state = init_train_state(cfg, tc, 1, device="meta")
    n = mesh.n_clients
    for name in ("client_res", "momentum"):
        if name in state:
            state[name] = map_tree(
                lambda _, t: torch.empty((n,) + tuple(t.shape[1:]),
                                         dtype=t.dtype, device="meta"),
                state[name])
    return _stand_ins(state, state_shardings(state, mesh))


def _batch_structs(specs: dict, mesh: Mesh, global_batch: int) -> dict:
    sh = batch_shardings(specs, mesh, global_batch)
    return {name: StandIn(torch.empty(spec.shape, dtype=spec.dtype,
                                      device="meta"), sh[name])
            for name, spec in specs.items()}


def _device_bytes(tree) -> int:
    return sum(x.device_bytes() for x in tree_leaves(tree)
               if isinstance(x, StandIn))


# ---------------------------------------------------------------------------
# one combination
# ---------------------------------------------------------------------------


def _mesh_tag(mesh: Mesh) -> str:
    return "x".join(str(s) for s in mesh.sizes)


def _wire_bytes(collectives: dict) -> float:
    """A ring's bytes a device: an all-reduce 2·(n - 1)/n of its message,
    an all-gather (n - 1)/n of what it gathers."""
    total = 0.0
    for name, rec in collectives.items():
        n = rec["ranks"]
        share = 1.0 if name.endswith("all-gather") else 2.0
        total += share * rec["bytes"] * (n - 1) / n
    return total


# the codecs whose tree path selects k over the model group (calls a step)
# and the one that sums its TernQuant statistics over it
_SPLIT_SELECTIONS = {"stc": 2, "topk": 1}
_SPLIT_TERNQUANT = {"ternquant": 2}


def tp_collectives(cfg: ModelConfig, tc: TrainConfig, mesh: Mesh,
                   rows: int, seq: int) -> tuple[dict, dict]:
    """Tensor parallelism's collectives in one step of ``rows`` rows of
    ``seq`` tokens on a device, as the step hands them to gloo over the
    model group: ``(counted, data_dependent)``, each ``{name: {"count",
    "bytes", "ranks"}}`` (bytes a device hands in; an all-gather's, what it
    gathers).  ``model-all-reduce``: per microbatch of ``t`` tokens, each
    block's forward ``all_reduce`` s of its split products' outputs
    (attention, and MLP or experts), the backward's of their inputs'
    gradients and, with remat, the attention's again in the recompute
    (which stops before the MLP's or the experts' last product), the
    embedding's rows and the head's input gradient, all ``(t, d)`` in the
    compute dtype; a MoE block's gates' gradient ``(t, k)`` in fp32 where
    its experts split; the cross-entropy's row maxima ``(t,)`` and
    exp-sums and gold logits ``(2, t)`` in fp32 per logit chunk; the split
    k-selection's maximum and 256 bin sums a call; and TernQuant's three
    8-byte sums a call.  A product of a leaf that
    ``fit_spec`` keeps whole runs replicated and hands gloo nothing.
    ``model-activations-all-gather``: on the attention's gather route
    (heads that do not split), each layer's joined q/k/v blocks in the
    forward and again in remat's recompute, and its output's gradient
    rows in the backward (``scatter_to``), in the compute dtype.
    ``model-all-gather``: the selection's 256 int32 counts a call.  The
    candidate bin's gather depends on the data (``data_dependent``, bytes
    None).  Empty where the step does not run the ``model`` axis."""
    m = mesh.shape.get("model", 1)
    if m == 1 or tensor_parallel_gap(cfg, mesh, tc):
        return {}, {}
    codec = codec_for(tc)
    iters = codec.local_iters
    t = rows // iters * seq
    width = torch.empty((), dtype=tc.compute_dtype).element_size()
    sp = _splits(cfg, m)
    remat = 1 if cfg.remat else 0
    attn_out = sp.heads or sp.q             # wo split: reduce_from
    attn_in = sp.heads or sp.q or sp.kv     # a split input: copy_to
    ffn = sum(sp.ffn(cfg, i) for i in range(cfg.n_layers))
    gates = sum(sp.ffn(cfg, i) for i in range(cfg.n_layers)
                if _is_moe(cfg, i))         # the gates' gradient, (t, k)
    acts = (cfg.n_layers * (attn_out * (1 + remat) + attn_in) + 2 * ffn
            + 2 * sp.vocab)
    lc = cfg.logit_chunk
    chunks = seq // lc if lc and seq > lc and seq % lc == 0 else 1
    count = iters * (acts + gates + 2 * chunks * sp.vocab)
    nbytes = iters * (acts * t * cfg.d_model * width + 3 * 4 * t * sp.vocab
                      + gates * 4 * t * (cfg.moe.top_k if gates else 0))
    sel = _SPLIT_SELECTIONS.get(codec.name, 0)
    tq = _SPLIT_TERNQUANT.get(codec.name, 0)
    count += 2 * sel + 3 * tq
    nbytes += sel * (4 + 4 * 256) + tq * 3 * 8
    counted = {"model-all-reduce": {"count": count, "bytes": nbytes,
                                    "ranks": m}}
    gathers = (1 + remat) * bool(sp.gathered) + (not sp.heads and sp.q)
    if gathers:
        counted["model-activations-all-gather"] = {
            "count": iters * cfg.n_layers * gathers,
            "bytes": iters * cfg.n_layers * t * width * (
                (1 + remat) * sp.gathered +
                (0 if sp.heads or not sp.q else sp.q_width)),
            "ranks": m}
    dependent = {}
    if sel:
        counted["model-all-gather"] = {"count": sel,
                                       "bytes": sel * m * 4 * 256,
                                       "ranks": m}
        dependent["model-candidates-all-gather"] = {
            "count": sel, "bytes": None, "ranks": m}
    return counted, dependent


def tp_serve_collectives(cfg: ModelConfig, mesh: Mesh, kind: str,
                         rows: int, seq: int,
                         cache_mode: str = "heads") -> dict:
    """Tensor parallelism's collectives in one serve step (``kind``
    ``"prefill"`` of ``rows`` prompts of ``seq`` tokens, or ``"decode"``
    of ``rows`` tokens), as the step hands them to gloo over the model
    group: ``{name: {"count", "bytes", "ranks"}}`` (an all-gather's bytes:
    what it gathers), in the serve steps' bf16.  ``model-all-reduce``: the
    embedding's rows and each layer's attention and MLP or experts'
    outputs, ``(t, d)`` for the step's ``t`` tokens, where their leaves
    split;
    ``model-all-gather``: the last position's logits, the vocabulary's
    columns from every rank; ``model-activations-all-gather``: on the
    attention's gather route, each layer's joined q/k/v blocks.  On whole
    heads ``2·L + 2`` calls a step, on the gather route ``3·L + 2``.
    Empty where the step does not run the ``model`` axis."""
    m = mesh.shape.get("model", 1)
    if m == 1 or serve_gap(cfg, mesh, cache_mode):
        return {}
    t = rows * (seq if kind == "prefill" else 1)
    width = 2                          # bytes of a bf16 element
    sp = _splits(cfg, m)
    acts = (cfg.n_layers * (sp.heads or sp.q) + sp.vocab +
            sum(sp.ffn(cfg, i) for i in range(cfg.n_layers)))
    out = {}
    if acts:
        out["model-all-reduce"] = {"count": acts,
                                   "bytes": acts * t * cfg.d_model * width,
                                   "ranks": m}
    if sp.vocab:
        out["model-all-gather"] = {"count": 1,
                                   "bytes": rows * cfg.vocab_size * width,
                                   "ranks": m}
    if sp.gathered:
        out["model-activations-all-gather"] = {
            "count": cfg.n_layers,
            "bytes": cfg.n_layers * t * sp.gathered * width, "ranks": m}
    return out


def lower_combo(arch: str, shape_name, *, multi_pod: bool = False,
                tc: TrainConfig | None = None, verbose: bool = True,
                cache_shard: str = "heads", moe_dispatch: str = "",
                flash_bf16: bool = False,
                mesh: Mesh | None = None, cfg: ModelConfig | None = None,
                device=None, ingest: bool = True) -> dict:
    """Size one (arch, input shape, mesh) without allocating; returns the
    record.

    ``shape_name`` names an input shape, or is an
    :class:`~repro_torch.configs.InputShape`; ``mesh`` (default the
    production mesh, ``multi_pod`` choosing it) and ``cfg`` (default the
    arch's config at that shape, e.g. a cut depth) size what a caller runs.
    ``cache_shard`` (``"heads"`` or ``"hd"``) and ``moe_dispatch`` are the
    reference's levers that the port's step has.  Those it lacks raise:
    ``flash_bf16`` (the port's flash scan keeps its probability blocks in
    fp32) and the cache pins ``"batch"``, ``"local"``, ``"seq"`` (the
    port's decode step re-lays no cache inside the step).  The reference's
    ``logit_chunk`` and ``stc_iters`` change nothing a record holds here
    (the chunked head's temporaries are not sized; the port's selection
    is exact), so they are not taken.  ``device`` is where the
    ``"kernel"`` wire backend packs the ingest sample (``ingest=False``
    skips the ingest and fleet measurements)."""
    if flash_bf16:
        raise NotImplementedError(
            "flash_bf16: the port's flash scan has no bf16 probability "
            "blocks (models/flash.py keeps them fp32)")
    if cache_shard in ("batch", "local", "seq"):
        raise NotImplementedError(
            f"cache_shard={cache_shard!r}: the port's decode step pins no "
            "cache layout inside the step; its caches keep cache_specs' "
            "'heads' or 'hd' layout")
    if cache_shard not in ("heads", "hd"):
        raise ValueError(f"unknown cache_shard {cache_shard!r}")
    shape = (shape_name if isinstance(shape_name, InputShape)
             else INPUT_SHAPES[shape_name])
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    cfg = cfg or get_config(arch, shape)
    if moe_dispatch and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch=moe_dispatch))
    tc = tc or TrainConfig(protocol="stc")
    specs = input_specs(cfg, shape)
    b = shape.global_batch
    model = mesh.shape.get("model", 1)
    split = math.prod(mesh.shape[a] for a in batch_spec(mesh, b))
    rows = b // split

    t0 = time.time()
    if shape.kind == "train":
        args = {"state": train_structs(cfg, tc, mesh),
                "batch": _batch_structs(specs, mesh, b)}
        outputs = {"state": args["state"]}
        codec = codec_for(tc)
        flops = step_flops(cfg, "train", rows, shape.seq_len,
                           local_iters=codec.local_iters)
    elif shape.kind == "prefill":
        params, _ = serve_state_structs(cfg, mesh, b, 2)
        args = {"params": params, "batch": _batch_structs(specs, mesh, b)}
        outputs = {"logits": StandIn(
            torch.empty((b, 1, cfg.vocab_size), dtype=torch.bfloat16,
                        device="meta"),
            Sharding(mesh, (args["batch"]["tokens"].sharding.spec[0],)))}
        flops = step_flops(cfg, "prefill", rows, shape.seq_len)
    else:
        params, caches = serve_state_structs(
            cfg, mesh, b, shape.seq_len,
            cache_mode=cache_shard)
        args = {"params": params, "caches": caches,
                **_batch_structs(specs, mesh, b)}
        logits = StandIn(
            torch.empty((b, 1, cfg.vocab_size), dtype=torch.bfloat16,
                        device="meta"),
            Sharding(mesh, (args["token"].sharding.spec[0],)))
        outputs = {"logits": logits, "caches": caches}
        flops = step_flops(cfg, "decode", rows, shape.seq_len)
    arg_parts = {name: _device_bytes(t) for name, t in args.items()}
    memory = {"argument_size_in_bytes": sum(arg_parts.values()),
              "output_size_in_bytes": _device_bytes(outputs),
              "arguments": arg_parts}
    if shape.kind == "decode":
        # the decode step writes its caches in place
        memory["alias_size_in_bytes"] = arg_parts["caches"]
    t_build = time.time() - t0

    collectives, dependent = {}, {}
    if shape.kind == "train" and mesh.n_clients > 1:
        collectives["all-reduce"] = {
            "count": 1, "bytes": 4 * sum(
                x.device_bytes() // 4
                for x in tree_leaves(args["state"]["params"])),
            "ranks": mesh.n_clients}
    serve_mode = cache_shard if shape.kind == "decode" else "heads"
    if shape.kind == "train":
        tp, dependent = tp_collectives(cfg, tc, mesh, rows, shape.seq_len)
        tp_gap = model > 1 and tensor_parallel_gap(cfg, mesh, tc)
    else:
        tp = tp_serve_collectives(cfg, mesh, shape.kind, rows, shape.seq_len,
                                  serve_mode)
        tp_gap = model > 1 and serve_gap(cfg, mesh, serve_mode)
    collectives.update(tp)
    if model > 1 and not tp_gap:
        flops_dev = step_flops(
            cfg, shape.kind, rows, shape.seq_len, model=model,
            local_iters=(codec_for(tc).local_iters if shape.kind == "train"
                         else 1))
    else:
        flops_dev = flops / model
    bytes_acc = memory["argument_size_in_bytes"] + memory[
        "output_size_in_bytes"]
    terms = {"compute": flops_dev / hardware.PEAK_BF16_FLOPS,
             "memory": bytes_acc / hardware.HBM_BYTES_PER_S,
             "collective": (_wire_bytes(collectives) /
                            hardware.NVLINK_BYTES_PER_S)}
    mf = model_flops(cfg, shape)
    devices = math.prod(mesh.sizes)
    rec = {
        "arch": arch,
        "shape": shape.name,
        "mesh": _mesh_tag(mesh),
        "kind": shape.kind,
        "protocol": tc.protocol if shape.kind == "train" else "serve",
        "config": {"name": cfg.name, "n_layers": cfg.n_layers,
                   "remat": cfg.remat},
        "rows_per_device": rows,
        "flops": flops_dev,
        "model_flops": mf,
        "useful_ratio": mf / (flops_dev * devices) if flops_dev else 0.0,
        "bytes_accessed": bytes_acc,
        "memory": memory,
        "not_measured": ["temp_size_in_bytes"],
        "collectives": collectives,
        "collectives_data_dependent": dependent,
        "assumptions": ([
            "flops split over the model axis evenly; tensor parallelism's "
            "own collectives are not counted (the step does not run this "
            f"config on this mesh: {tp_gap})"] if tp_gap else []) + [
            "bytes_accessed: each argument read once, each output written "
            "once (the train step's metrics, a few scalars, left out)"],
        "params": cfg.param_count(),
        "roofline": {"card": hardware.CARD,
                     "power_limit_w": hardware.POWER_LIMIT_W,
                     "t_compute_s": terms["compute"],
                     "t_memory_s": terms["memory"],
                     "t_collective_s": terms["collective"],
                     "dominant": max(terms, key=terms.get)},
        "fits": memory["argument_size_in_bytes"] <= hardware.HBM_BYTES,
        "t_build_s": round(t_build, 3),
    }
    if shape.kind == "train" and ingest:
        rec["server_ingest"] = measured_ingest_bytes(
            tc, cfg.param_count(), mesh.n_clients, device=device)
        rec["fleet_scenarios"] = fleet_event_stats(max(mesh.n_clients, 8))
    if verbose:
        _print(rec)
    return rec


def _print(rec: dict) -> None:
    mem = rec["memory"]
    r = rec["roofline"]
    parts = {k: round(v / 2**30, 3) for k, v in mem["arguments"].items()}
    print(f"[dryrun] {rec['arch']} x {rec['shape']} x {rec['mesh']}: "
          f"args {mem['argument_size_in_bytes'] / 2**30:.3f} GiB ({parts})"
          f" out {mem['output_size_in_bytes'] / 2**30:.3f} GiB; flops "
          f"{rec['flops']:.4e} a device; roofline compute "
          f"{r['t_compute_s']:.3e} s, memory {r['t_memory_s']:.3e} s, "
          f"collective {r['t_collective_s']:.3e} s ({r['dominant']}); "
          f"fits {rec['fits']}")
    if "server_ingest" in rec:
        si = rec["server_ingest"]
        worst = max(rec["fleet_scenarios"].items(),
                    key=lambda kv: kv[1]["drop_rate"])
        print(f"         server_ingest: up "
              f"{si['bytes_up_round'] / 2**20:.2f} MiB/round, down "
              f"{si['bytes_down_round'] / 2**20:.2f} MiB/round (measured, "
              f"{si['n_clients']} clients); fleet: worst drop_rate "
              f"{worst[1]['drop_rate']:.3f} ({worst[0]})")


def save_record(rec: dict, out_dir: str | None = None) -> str:
    out_dir = out_dir or os.path.abspath(ARTIFACTS)
    os.makedirs(out_dir, exist_ok=True)
    fname = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}"
    if rec.get("variant"):
        fname += f"__{rec['variant']}"
    path = os.path.join(out_dir, fname + ".json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=2)
    return path


def main(argv=None) -> None:
    from ..core.protocols import registered_protocols
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) combination")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 = 512-device mesh")
    ap.add_argument("--debug-mesh", type=int, nargs=2, default=None,
                    metavar=("DATA", "MODEL"),
                    help="a small mesh instead (1 1: one card)")
    ap.add_argument("--protocol", default="stc",
                    choices=registered_protocols())
    ap.add_argument("--variant", default="",
                    help="tag appended to the record's filename")
    ap.add_argument("--flash-bf16", action="store_true",
                    help="the reference's bf16 probability blocks (the "
                         "port has none: raises)")
    ap.add_argument("--moe-dispatch", default="",
                    choices=("", "ragged", "capacity"))
    ap.add_argument("--cache-shard", default="heads",
                    choices=("heads", "hd", "batch", "local", "seq"),
                    help="decode-cache sharding (the reference's in-step "
                         "pins batch, local, seq: the port has none, "
                         "raises)")
    ap.add_argument("--device", default=None,
                    help="where the wire packs the ingest sample: cpu, or "
                         "the card (default)")
    ap.add_argument("--out", default=None,
                    help="record directory (default artifacts/dryrun_torch)")
    args = ap.parse_args(argv)
    if args.all:
        combos = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("need --arch and --shape (or --all)")
        combos = [(args.arch, args.shape)]
    mesh = (make_debug_mesh(*args.debug_mesh) if args.debug_mesh else
            make_production_mesh(multi_pod=args.multi_pod))
    tc = TrainConfig(protocol=args.protocol)
    failures = []
    for arch, shape in combos:
        try:
            rec = lower_combo(arch, shape, tc=tc, mesh=mesh,
                              cache_shard=args.cache_shard,
                              moe_dispatch=args.moe_dispatch,
                              flash_bf16=args.flash_bf16, device=args.device)
            if args.variant:
                rec["variant"] = args.variant
            save_record(rec, args.out)
        except Exception as e:  # noqa: BLE001 -- report and continue
            failures.append((arch, shape, repr(e)[:500]))
            print(f"[dryrun] FAIL {arch} x {shape}: {repr(e)[:300]}")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for a, s, e in failures:
            print(f"  {a} x {s}: {e}")
        raise SystemExit(1)
    print(f"\nall {len(combos)} combinations sized on mesh "
          f"{_mesh_tag(mesh)}")


if __name__ == "__main__":
    main()
