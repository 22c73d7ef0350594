"""The port's sharding rules and shape stand-ins against the reference's.

* ``param_specs`` leaf by leaf, and ``fit_spec`` on the leaves' shapes,
  equal to the reference's for all ten archs at full size on the
  production meshes (16x16 and 2x16x16) and ``make_debug_mesh(2, 2)``; the
  reference's trees come from ``jax.eval_shape`` and
  ``jax.sharding.AbstractMesh``, so neither side needs a device.
* ``cache_specs`` in both ``CACHE_SHARD_MODE`` s at decode_32k and
  long_500k, fitted to the caches' shapes, equal to the reference's.
* The dry run's per-device argument bytes of every arch x input shape x
  mesh equal the sum of the reference's ``NamedSharding.shard_shape``
  bytes: its ``state_shardings`` / ``batch_shardings`` for train, its
  ``param_shardings`` for serve, and its ``cache_specs`` fitted leaf by
  leaf for the caches.  (The reference's ``serve_state_structs`` returns
  its caches unsharded: its ``tree.map`` takes the cache list for one
  leaf.  A cache's ``ring`` flag is a Python bool in the port, not a
  device argument, and is left out on both sides.)
* ``init_model(cfg, device="meta")``: the tree of ``init_model``'s draw at
  smoke size (paths, shapes, dtypes, leaf order), with no draw at full
  size; the drawn values are pinned by digest to what they were before
  the meta route.
"""

import functools
import hashlib
import math
import os

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

from repro import configs as ref_configs
from repro.launch import train as ref_train
from repro.models import init_cache as ref_init_cache
from repro.models import init_model as ref_init_model
from repro.sharding import rules as ref_rules
from repro_torch import configs
from repro_torch.core.compression import tree_leaves
from repro_torch.launch.dryrun import lower_combo, train_structs
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.launch.serve import serve_state_structs
from repro_torch.launch.train import (TrainConfig, init_train_state,
                                      state_shardings)
from repro_torch.models import init_cache, init_model
from repro_torch.sharding import rules

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

MESHES = {
    "16x16": (lambda: AbstractMesh((16, 16), ("data", "model")),
              make_production_mesh),
    "2x16x16": (lambda: AbstractMesh((2, 16, 16), ("pod", "data", "model")),
                lambda: make_production_mesh(multi_pod=True)),
    "2x2": (lambda: AbstractMesh((2, 2), ("data", "model")),
            lambda: make_debug_mesh(2, 2)),
}

# sha256 of the fp32 bytes of init_model(smoke config, 7, "cpu") in
# flatten order (first 16 hex digits), as drawn before the meta route
DRAW_DIGESTS = {
    "deepseek-v2-lite-16b": "6888d713fbda5893",
    "moonshot-v1-16b-a3b": "decc71afcafabd8b",
    "granite-moe-3b-a800m": "48a4d7df8697d3c5",
    "smollm-135m": "ae27763cff56e871",
    "qwen2-0.5b": "7788b9b93f697e8e",
    "whisper-medium": "532b76814b1f7d66",
    "recurrentgemma-2b": "63c8f9a68861c8bf",
    "mamba2-370m": "eec7435df3613639",
    "phi3-medium-14b": "6f8427782195eb5e",
    "internvl2-2b": "b6fb154f9dc8ee9f",
}


def _sorted_leaves(tree) -> list:
    """Leaves of a dict / list tree of specs (plain tuples) in flatten
    order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in _sorted_leaves(t)]
    return [tree]


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str, shape: str | None = None):
    cfg = ref_configs.get_config(arch, shape)
    return jax.eval_shape(functools.partial(ref_init_model, cfg),
                          jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_specs_match_reference(arch):
    ref = _ref_params(arch)
    port = init_model(configs.get_config(arch), device="meta")
    ref_specs = jax.tree.leaves(ref_rules.param_specs(ref),
                                is_leaf=lambda x: isinstance(x, P))
    port_specs = _sorted_leaves(rules.param_specs(port))
    assert port_specs == [tuple(s) for s in ref_specs]
    shapes = [tuple(x.shape) for x in tree_leaves(port)]
    assert shapes == [tuple(x.shape) for x in jax.tree.leaves(ref)]
    for name, (ref_mesh, port_mesh) in MESHES.items():
        am, pm = ref_mesh(), port_mesh()
        want = [tuple(ref_rules.fit_spec(s, shape, am))
                for s, shape in zip(ref_specs, shapes)]
        got = [rules.fit_spec(s, shape, pm)
               for s, shape in zip(port_specs, shapes)]
        assert got == want, name
        fitted = _sorted_leaves(rules.param_shardings(port, pm))
        assert [f.spec for f in fitted] == want, name
        assert [f.shard_shape(shape) for f, shape in zip(fitted, shapes)] \
            == [NamedSharding(am, P(*s)).shard_shape(shape)
                for s, shape in zip(want, shapes)], name


def test_fit_spec_replicates_what_does_not_divide():
    """whisper's 51,865-row vocab over 16 and qwen2's 2 KV heads are
    replicated; a 16-row dim keeps its split."""
    mesh = make_production_mesh()
    assert rules.fit_spec(("model", None), (51_865, 1024), mesh) == \
        (None, None)
    assert rules.fit_spec((None, None, "model", None), (128, 4, 2, 64),
                          mesh) == (None, None, None, None)
    assert rules.fit_spec((("pod", "data"), "model"), (32, 16),
                          make_production_mesh(multi_pod=True)) == \
        (("pod", "data"), "model")
    with pytest.raises(ValueError):
        rules.Sharding(mesh, ("model",)).shard_shape((51_865,))


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("mode", ["heads", "hd"])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_cache_specs_match_reference(arch, mode, shape, monkeypatch):
    batch = configs.INPUT_SHAPES[shape].global_batch
    seq = configs.INPUT_SHAPES[shape].seq_len
    ref_cfg = ref_configs.get_config(arch, shape)
    cfg = configs.get_config(arch, shape)
    monkeypatch.setattr(ref_rules, "CACHE_SHARD_MODE", mode)
    ref_caches = jax.eval_shape(functools.partial(
        ref_init_cache, ref_cfg, batch, seq, jnp.bfloat16))
    caches = init_cache(cfg, batch, seq, device="meta")
    assert all(t.device.type == "meta" for c in caches for t in c
               if isinstance(t, torch.Tensor))
    for name, (ref_mesh, port_mesh) in MESHES.items():
        am, pm = ref_mesh(), port_mesh()
        want = ref_rules.cache_specs(
            ref_init_cache(ref_cfg, 1, 2, jnp.bfloat16), am, batch)
        got = rules.cache_specs(caches, pm, batch, mode)
        assert len(got) == len(want) == cfg.n_layers
        for g, w, c, rc in zip(got, want, caches, ref_caches):
            assert type(g).__name__ == type(w).__name__
            for f in w._fields:
                assert getattr(g, f) == tuple(getattr(w, f)), (name, f)
                leaf = getattr(c, f)
                if isinstance(leaf, torch.Tensor) and leaf.ndim:
                    shape_f = tuple(leaf.shape)
                    assert shape_f == tuple(getattr(rc, f).shape)
                    assert rules.fit_spec(getattr(g, f), shape_f, pm) == \
                        tuple(ref_rules.fit_spec(getattr(w, f), shape_f, am))


def _shard_bytes(structs, shardings) -> int:
    leaves = jax.tree.leaves(structs)
    shs = jax.tree.leaves(shardings,
                          is_leaf=lambda x: isinstance(x, NamedSharding))
    assert len(leaves) == len(shs)
    return sum(math.prod(sh.shard_shape(x.shape)) *
               jnp.dtype(x.dtype).itemsize for x, sh in zip(leaves, shs))


def _ref_argument_bytes(arch: str, shape_name: str, am) -> dict:
    """The reference's per-device argument bytes of one combination, part
    by part, from its own rules on abstract trees."""
    shape = ref_configs.INPUT_SHAPES[shape_name]
    cfg = ref_configs.get_config(arch, shape_name)
    specs = ref_configs.input_specs(cfg, shape)
    b = shape.global_batch
    n_clients = math.prod(am.shape[a] for a in ("pod", "data")
                          if a in am.axis_names)
    if shape.kind == "train":
        state = jax.eval_shape(functools.partial(
            ref_train.init_train_state, cfg,
            ref_train.TrainConfig(protocol="stc"), n_clients),
            jax.random.PRNGKey(0))
        return {"state": _shard_bytes(
                    state, ref_train.state_shardings(state, am)),
                "batch": _shard_bytes(
                    specs, ref_train.batch_shardings(specs, am, b))}
    params = _ref_params(arch, shape_name)
    out = {"params": _shard_bytes(params,
                                  ref_rules.param_shardings(params, am))}
    if shape.kind == "prefill":
        out["batch"] = _shard_bytes(
            specs, ref_train.batch_shardings(specs, am, b))
        return out
    bs = NamedSharding(am, ref_rules.batch_spec(am, b))
    caches = jax.eval_shape(functools.partial(
        ref_init_cache, cfg, b, shape.seq_len, jnp.bfloat16))
    cspecs = ref_rules.cache_specs(ref_init_cache(cfg, 1, 2, jnp.bfloat16),
                                   am, b)
    leaves, shardings = [], []
    for c, sp in zip(caches, cspecs):
        for f in c._fields:
            leaf = getattr(c, f)
            if not hasattr(leaf, "shape") or leaf.dtype == jnp.bool_:
                continue        # the ring flag: no device argument here
            leaves.append(leaf)
            shardings.append(NamedSharding(am, ref_rules.fit_spec(
                getattr(sp, f), leaf.shape, am)))
    out["caches"] = _shard_bytes(leaves, shardings)
    out["token"] = _shard_bytes([specs["token"]], [bs])
    if "memory" in specs:
        out["memory"] = _shard_bytes([specs["memory"]], [bs])
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_argument_bytes_match_reference(arch, mesh):
    ref_mesh, port_mesh = MESHES[mesh]
    am, pm = ref_mesh(), port_mesh()
    for shape in configs.INPUT_SHAPES:
        rec = lower_combo(arch, shape, mesh=pm, ingest=False, verbose=False)
        want = _ref_argument_bytes(arch, shape, am)
        assert rec["memory"]["arguments"] == want, (shape, want)
        assert rec["memory"]["argument_size_in_bytes"] == sum(want.values())
        assert rec["mesh"] == mesh


def test_smollm_train_state_bytes_a_device():
    """The figure the reference's abstract mesh gives: SmolLM-135M's STC
    train state on 16x16 takes 101,281,540 bytes a device."""
    state = train_structs(configs.get_config("smollm-135m"),
                          TrainConfig(protocol="stc"),
                          make_production_mesh())
    total = sum(x.device_bytes() for x in tree_leaves(state))
    assert total == 101_281_540


def test_rank_state_is_its_shard():
    """On a mesh of two clients (model 1) a rank's real state is, leaf by
    leaf, the shard that ``state_shardings`` gives of the global state."""
    cfg = configs.get_smoke_config("qwen2-0.5b")
    mesh = make_debug_mesh(2, 1)
    tc = TrainConfig(protocol="stc", momentum=0.9)
    state = init_train_state(cfg, tc, 2, 0, device="cpu")
    sh = state_shardings(state, mesh)
    glob = train_structs(cfg, tc, mesh)
    for name in ("params", "client_res", "server_res", "momentum"):
        for leaf, s, g in zip(tree_leaves(state[name]),
                              tree_leaves(sh[name]),
                              tree_leaves(glob[name])):
            assert s.shard_shape(g.shape) == tuple(leaf.shape), name
            assert g.sharding == s
    assert sh["step"].spec == ()


def test_serve_state_structs_allocate_nothing():
    cfg = configs.get_config("recurrentgemma-2b")
    params, caches = serve_state_structs(cfg, make_production_mesh(), 128,
                                         32_768)
    for x in tree_leaves(params):
        assert isinstance(x, rules.StandIn)
        assert x.tensor.device.type == "meta"
    for c in caches:
        for f in c._fields:
            v = getattr(c, f)
            assert isinstance(v, rules.StandIn) or isinstance(v, bool)
    assert sum(x.tensor.numel() for x in tree_leaves(params)) == \
        cfg.param_count()


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_meta_route_is_init_models_tree(arch):
    cfg = configs.get_smoke_config(arch)
    drawn = init_model(cfg, 7, "cpu")
    meta = init_model(cfg, device="meta")

    def paths(tree, prefix=()):
        if isinstance(tree, dict):
            return [p for k in sorted(tree)
                    for p in paths(tree[k], prefix + (k,))]
        if isinstance(tree, list):
            return [p for i, t in enumerate(tree)
                    for p in paths(t, prefix + (i,))]
        return [(prefix, tuple(tree.shape), tree.dtype)]

    assert paths(meta) == paths(drawn)
    assert all(t.device.type == "meta" for t in tree_leaves(meta))
    h = hashlib.sha256()
    for t in tree_leaves(drawn):
        h.update(t.numpy().tobytes())
    assert h.hexdigest()[:16] == DRAW_DIGESTS[arch]
    # each call gets its own tensors and containers
    again = init_model(cfg, device="meta")
    assert again is not meta and all(
        a is not b for a, b in zip(tree_leaves(again), tree_leaves(meta)))


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_meta_route_draws_nothing_at_full_size(arch):
    cfg = configs.get_config(arch)
    gen = torch.Generator().manual_seed(3)
    before = gen.get_state().clone()
    global_before = torch.get_rng_state().clone()
    meta = init_model(cfg, gen, device="meta")
    assert torch.equal(gen.get_state(), before)
    assert torch.equal(torch.get_rng_state(), global_before)
    assert all(t.device.type == "meta" and t.dtype == torch.float32
               for t in tree_leaves(meta))
    assert sum(t.numel() for t in tree_leaves(meta)) == cfg.param_count()
