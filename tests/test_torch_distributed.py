"""Port parity of the tree-level codecs (``core/distributed.py``) and the
Codec tree API (``tree_encode`` / ``tree_reduce`` / ``tree_decode``).

Held against the JAX package on numpy inputs made from a seed, on the
smollm smoke model's parameter tree (246,240 coordinates):

* ``stc_compress_tree`` on the port's ``"torch"`` and ``"kernel"`` routes
  at p = 1/50 (k = 4,924: the reference's direct gather route) and p = 1/20
  (k = 12,312: its histogram route): thresholds, counts, positions and
  signs exact, µ within rtol 1e-6; ties and empty leaves too.  All zeros
  and fewer non-zeros than k (ROADMAP R11): positions and signs exact, the
  port's count the non-zeros, the reference's at least that.
* ``stc_compress_tree_chunked`` with a ``p_fn`` and both adaptive
  controllers: counts, positions and signs exact, µ within rtol 1e-6.
* ``ternary_quantize_tree`` (R7: Δ and µ within rtol 1e-6, counts exact)
  and ``sign_compress_tree`` (exact).
* The tree API of all six codecs and of a chunked codec (which delegates
  to its base), with no client axes, with and without mask and staleness,
  under ``mean``, ``coordinate_median`` and ``trimmed_mean``: STC and
  top-k positions and signs exact and values within rtol 1e-6, the rest
  within rtol 1e-6 (exact where noted).
* The same collectives over two gloo ranks spawned on the CPU
  (``tests/_torch_mesh_worker.py``): bitwise the reference's arithmetic
  for two clients, and the sharded STC and ternary quantization equal to
  the single-process ones on the concatenated shards.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.core import distributed as ref_dist
from repro.core import make_protocol as ref_make_protocol
from repro.core.aggregation import make_rule as ref_make_rule
from repro.models import init_model as ref_init_model
from repro_torch.core import distributed as dist_mod
from repro_torch.core import make_protocol
from repro_torch.core.chunking import chunk_codec, chunk_spec_from_tree
from repro_torch.core.compression import tree_leaves
from repro_torch.models import params_from_jax

HERE = os.path.dirname(os.path.abspath(__file__))
ROUTES = ("torch", "kernel")
PS = (1 / 50, 1 / 20)


@functools.lru_cache(maxsize=None)
def _shapes():
    params = ref_init_model(ref_smoke("smollm-135m"), jax.random.PRNGKey(0))
    return jax.tree.map(lambda x: x.shape, params)


def _tree(seed, kind="normal"):
    """A numpy tree of the smoke model's structure."""
    rng = np.random.default_rng(seed)

    def leaf(shape):
        x = rng.standard_normal(shape).astype(np.float32)
        if kind == "ties":
            x = np.round(x * 4) / 4
        elif kind == "zeros":
            x = np.zeros(shape, np.float32)
        elif kind == "sparse":        # fewer non-zeros than k at p = 1/50
            x = np.where(rng.random(shape) < 0.005, x, 0).astype(np.float32)
        return x

    return jax.tree.map(leaf, _shapes(), is_leaf=lambda s: isinstance(s,
                                                                       tuple))


def _ref(tree):
    return jax.tree.map(jnp.asarray, tree)


def _port(tree):
    return params_from_jax(tree)


def _np_leaves(tree):
    return [np.asarray(x) for x in (tree_leaves(tree)
                                    if not _is_jax(tree)
                                    else jax.tree.leaves(tree))]


def _is_jax(tree):
    return isinstance(jax.tree.leaves(tree)[0], jax.Array)


def _flat(tree):
    return np.concatenate([x.ravel() for x in _np_leaves(tree)])


def _same_ternary(got, want, rtol=1e-6):
    """Positions and signs exact, values within ``rtol``."""
    g, w = _flat(got), _flat(want)
    np.testing.assert_array_equal(g != 0, w != 0)
    np.testing.assert_array_equal(np.sign(g), np.sign(w))
    np.testing.assert_allclose(g, w, rtol=rtol, atol=0)


# -- stc_compress_tree ------------------------------------------------------


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_stc_compress_tree_matches_reference(route, p, kind):
    tree = _tree(1, kind)
    want, ws = ref_dist.stc_compress_tree(_ref(tree), p)
    got, gs = dist_mod.stc_compress_tree(_port(tree), p, backend=route)
    assert float(gs.thresh) == float(ws.thresh)
    assert int(gs.nnz) == int(ws.nnz)
    assert gs.numel == ws.numel == 246_240
    np.testing.assert_allclose(float(gs.mu), float(ws.mu), rtol=1e-6)
    _same_ternary(got, want)
    # the leaves come back in the tree's structure and shapes
    assert [x.shape for x in tree_leaves(got)] == \
        [x.shape for x in jax.tree.leaves(want)]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("kind", ["zeros", "sparse"])
def test_stc_compress_tree_fewer_nonzeros_than_k_r11(route, kind):
    """Threshold 0: the messages' positions and signs agree; the port counts
    the non-zeros (its flat STC's count), the reference also counts zeros
    of its candidate gathers (ROADMAP R11)."""
    tree = _tree(2, kind)
    nonzero = int(np.count_nonzero(_flat(tree)))
    want, ws = ref_dist.stc_compress_tree(_ref(tree), 1 / 50)
    got, gs = dist_mod.stc_compress_tree(_port(tree), 1 / 50, backend=route)
    assert float(gs.thresh) == float(ws.thresh) == 0.0
    assert int(gs.nnz) == nonzero < 4924
    assert int(ws.nnz) >= nonzero
    g, w = _flat(got), _flat(want)
    np.testing.assert_array_equal(g != 0, w != 0)
    np.testing.assert_array_equal(np.sign(g), np.sign(w))
    if nonzero:
        np.testing.assert_allclose(float(gs.mu),
                                   np.abs(_flat(tree)).sum() / nonzero,
                                   rtol=1e-6)


@pytest.mark.parametrize("route", ROUTES)
def test_stc_compress_tree_empty_leaves(route):
    """Empty leaves pass through; the rest select as the reference does on
    the tree without them (the reference's sweeps reject empty leaves)."""
    tree = _tree(3)
    ported = _port(tree)
    ported["empty"] = torch.zeros((0, 4))
    ported["blocks"][0]["none"] = torch.zeros((0,))
    want, ws = ref_dist.stc_compress_tree(_ref(tree), 1 / 20)
    got, gs = dist_mod.stc_compress_tree(ported, 1 / 20, backend=route)
    assert got["empty"].shape == (0, 4) and got["blocks"][0]["none"].numel() == 0
    del got["empty"], got["blocks"][0]["none"]
    assert int(gs.nnz) == int(ws.nnz) and float(gs.thresh) == float(ws.thresh)
    _same_ternary(got, want)


def test_stc_compress_tree_leaves_are_views_of_one_row():
    got, _ = dist_mod.stc_compress_tree(_port(_tree(4)), 1 / 50)
    leaves = tree_leaves(got)
    base = leaves[0].untyped_storage().data_ptr()
    assert all(x.untyped_storage().data_ptr() == base for x in leaves)


# -- stc_compress_tree_chunked ------------------------------------------------


def _p_fn(name, depth):
    return 1 / 10 if "embed" in name else None


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("controller", [None, ("residual_mass",
                                               {"budget": 1.0}),
                                        ("snr_constant", {})])
def test_stc_compress_tree_chunked_matches_reference(route, controller):
    from repro.core.adaptive import make_controller as ref_ctrl
    from repro_torch.core.adaptive import make_controller
    tree = _tree(5)
    rc = pc = None
    if controller is not None:
        rc, pc = ref_ctrl(controller[0], **controller[1]), \
            make_controller(controller[0], **controller[1])
    want, ws = ref_dist.stc_compress_tree_chunked(
        _ref(tree), 1 / 50, 4096, p_fn=_p_fn, controller=rc)
    got, gs = dist_mod.stc_compress_tree_chunked(
        _port(tree), 1 / 50, 4096, p_fn=_p_fn, backend=route, controller=pc)
    assert int(gs.nnz) == int(ws.nnz)
    np.testing.assert_allclose(float(gs.mu), float(ws.mu), rtol=1e-6)
    _same_ternary(got, want)


# -- ternary quantization and signs ------------------------------------------


def test_ternary_quantize_tree_matches_reference_r7():
    tree = _tree(6)
    want, ws = ref_dist.ternary_quantize_tree(_ref(tree), 0.75)
    got, gs = dist_mod.ternary_quantize_tree(_port(tree), 0.75)
    assert int(gs.nnz) == int(ws.nnz)
    np.testing.assert_allclose(float(gs.thresh), float(ws.thresh), rtol=1e-6)
    np.testing.assert_allclose(float(gs.mu), float(ws.mu), rtol=1e-6)
    _same_ternary(got, want)


def test_sign_compress_tree_exact():
    tree = _tree(7)
    tree["blocks"][0]["norm1"]["g"][:3] = [0.0, 1e-40, -1e-40]  # subnormals
    want = ref_dist.sign_compress_tree(_ref(tree), 2e-4)
    got = dist_mod.sign_compress_tree(_port(tree), 2e-4)
    np.testing.assert_array_equal(_flat(got), _flat(want))


def test_tree_helpers():
    a, b = _tree(8), _tree(9)
    assert dist_mod.tree_numel(_port(a)) == ref_dist.tree_numel(_ref(a))
    np.testing.assert_array_equal(
        _flat(dist_mod.tree_add(_port(a), _port(b))),
        _flat(ref_dist.tree_add(_ref(a), _ref(b))))
    np.testing.assert_array_equal(
        _flat(dist_mod.tree_scale(_port(a), 0.5)),
        _flat(ref_dist.tree_scale(_ref(a), 0.5)))


# -- the Codec tree API, no client axes ----------------------------------------

CODECS = {
    "baseline": {}, "fedavg": {"local_iters": 2}, "signsgd": {},
    "topk": {"sparsity_up": 1 / 20},
    "stc": {"sparsity_up": 1 / 20, "sparsity_down": 1 / 50},
    "ternquant": {},
}
NUMEL = 246_240


def _codecs(name, rule=None, **extra):
    kw = dict(CODECS[name], **extra)
    if rule is not None:
        kw["rule"] = rule
    ref_kw = {k: v for k, v in kw.items() if k != "backend"}
    if rule is not None:
        ref_kw["rule"] = ref_make_rule(rule)
    return ref_make_protocol(name, **ref_kw), make_protocol(name, **kw)


def _residual(codec_has, seed):
    return _tree(seed) if codec_has else None


def _close(got, want, name):
    g, w = _flat(got), _flat(want)
    if name in ("stc", "topk"):
        np.testing.assert_array_equal(g != 0, w != 0)
    np.testing.assert_array_equal(np.sign(g), np.sign(w))
    np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", list(CODECS))
def test_tree_encode_decode_match_reference(name):
    ref, port = _codecs(name)
    assert port.has_client_state() == ref.has_client_state()
    assert port.has_server_state() == ref.has_server_state()
    delta = jax.tree.map(lambda x: 0.01 * x, _tree(10))
    res = _residual(ref.has_client_state(), 11)
    r = ref.tree_encode(_ref(delta), None if res is None else _ref(res),
                        numel=NUMEL)
    g = port.tree_encode(_port(delta), None if res is None else _port(res),
                         numel=NUMEL)
    _close(g[0], r[0], name)
    if res is not None:
        # carried - message: within rtol 1e-6 of |carried| + µ
        np.testing.assert_allclose(_flat(g[1]), _flat(r[1]), rtol=0,
                                   atol=1e-6 * (np.abs(_flat(r[1])).max()
                                                + np.abs(_flat(r[0])).max()))
    assert sorted(g[2]) == sorted(r[2])
    for key in r[2]:
        assert int(g[2][key]) == int(r[2][key])
    sres = _residual(ref.has_server_state(), 12)
    r = ref.tree_decode(_ref(delta), None if sres is None else _ref(sres),
                        numel=NUMEL)
    g = port.tree_decode(_port(delta), None if sres is None else _port(sres),
                         numel=NUMEL)
    _close(g[0], r[0], name)
    for key in r[2]:
        assert int(g[2][key]) == int(r[2][key])


MASKS = [(None, None), ([1.0], None), ([0.0], None), ([1.0], [2.0]),
         (None, [3.0])]


@pytest.mark.parametrize("name", list(CODECS))
@pytest.mark.parametrize("mask,stal", MASKS)
def test_tree_reduce_no_axes_matches_reference(name, mask, stal):
    ref, port = _codecs(name)
    msgs = _tree(13)
    r = ref.tree_reduce(_ref(msgs), (), 1,
                        mask=None if mask is None else jnp.asarray(mask),
                        staleness=None if stal is None else jnp.asarray(stal))
    g = port.tree_reduce(_port(msgs), None, 1,
                         mask=None if mask is None else torch.tensor(mask),
                         staleness=None if stal is None
                         else torch.tensor(stal))
    np.testing.assert_allclose(_flat(g), _flat(r), rtol=1e-6, atol=0)


@pytest.mark.parametrize("rule", ["coordinate_median", "trimmed_mean"])
@pytest.mark.parametrize("mask,stal", MASKS[:2])
def test_tree_reduce_gathered_rules_no_axes(rule, mask, stal):
    ref, port = _codecs("stc", rule=rule)
    msgs = _tree(14)
    r = ref.tree_reduce(_ref(msgs), (), 1,
                        mask=None if mask is None else jnp.asarray(mask),
                        staleness=None)
    g = port.tree_reduce(_port(msgs), None, 1,
                         mask=None if mask is None else torch.tensor(mask))
    np.testing.assert_allclose(_flat(g), _flat(r), rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", ["stc", "signsgd", "topk"])
def test_chunked_codec_delegates_the_tree_path(name):
    _, base = _codecs(name)
    tree = _port(_tree(15))
    wrapped = chunk_codec(base, chunk_spec_from_tree(tree, 4096))
    delta = _port(jax.tree.map(lambda x: 0.01 * x, _tree(16)))
    res = tree if base.has_client_state() else None
    for a, b in ((wrapped.tree_encode(delta, res, numel=NUMEL),
                  base.tree_encode(delta, res, numel=NUMEL)),
                 (wrapped.tree_decode(delta, res, numel=NUMEL),
                  base.tree_decode(delta, res, numel=NUMEL))):
        np.testing.assert_array_equal(_flat(a[0]), _flat(b[0]))
    np.testing.assert_array_equal(
        _flat(wrapped.tree_reduce(delta, None, 1, mask=torch.tensor([1.0]))),
        _flat(base.tree_reduce(delta, None, 1, mask=torch.tensor([1.0]))))


@pytest.mark.parametrize("route", ROUTES)
def test_stc_codec_tree_path_chunk_size(route):
    """StcCodec(chunk_size=) selects per (leaf, chunk) block on the tree
    path, as the reference's codec does."""
    ref, port = _codecs("stc", chunk_size=4096, backend=route)
    delta = _tree(17)
    r = ref.tree_encode(_ref(delta), _ref(_tree(18)), numel=NUMEL)
    g = port.tree_encode(_port(delta), _port(_tree(18)), numel=NUMEL)
    assert int(g[2]["nnz_up"]) == int(r[2]["nnz_up"])
    _close(g[0], r[0], "stc")


# -- two gloo ranks on the CPU ------------------------------------------------

REDUCE_JOBS = [(name, None, mask, stal) for name in CODECS
               for mask, stal in ((None, None), ([1.0, 0.0], None),
                                  ([1.0, 1.0], [0.0, 2.0]),
                                  ([0.0, 0.0], None))] + \
    [("stc", rule, mask, None) for rule in ("coordinate_median",
                                            "trimmed_mean")
     for mask in (None, [1.0, 0.0])]


def _run_worker(case, inp, tmp_path):
    src = os.path.join(os.path.dirname(HERE), "src")
    inp_path, out_path = tmp_path / "in.pt", tmp_path / "out.pt"
    torch.save(inp, inp_path)
    out = subprocess.run([sys.executable,
                          os.path.join(HERE, "_torch_mesh_worker.py"), case,
                          str(inp_path), str(out_path)],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": src})
    assert out.returncode == 0, out.stderr[-3000:]
    return [torch.load(f"{out_path}.{r}", weights_only=False)
            for r in range(2)]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    msgs = [_tree(20), _tree(21)]
    full = _tree(22)
    leaves = jax.tree.leaves(full)
    cut = len(leaves) // 2            # rank 0 holds the first leaves
    inp = {"msgs": [_port(m) for m in msgs], "jobs": REDUCE_JOBS,
           "numel": NUMEL, "p": 1 / 20,
           "shards": [{"a": [torch.from_numpy(x) for x in leaves[:cut]]},
                      {"a": [torch.from_numpy(x) for x in leaves[cut:]]}]}
    outs = _run_worker("reduce", inp, tmp_path_factory.mktemp("reduce"))
    return msgs, full, outs


def _weights(ref, mask, stal, r):
    if mask is None and stal is None:
        return None
    m = jnp.asarray(mask if mask is not None else [1.0, 1.0])[r:r + 1]
    s = None if stal is None else jnp.asarray(stal)[r:r + 1]
    return jnp.sum(ref.participation_weights(m, s))


def _two_client_reference(name, rule, mask, stal, msgs):
    """The reference's arithmetic of tree_reduce over two client shards."""
    ref, _ = _codecs(name, rule=rule)
    a, b = _ref(msgs[0]), _ref(msgs[1])
    w = [_weights(ref, mask, stal, r) for r in range(2)]
    if rule is not None:
        ws = jnp.stack([jnp.float32(1.0) if x is None else x for x in w])
        return jax.tree.map(lambda x, y: ref.rule.combine(
            jnp.stack([x, y]), ws), a, b)
    if name == "signsgd":
        if w[0] is None:
            return jax.tree.map(lambda x, y: jnp.sign(x) + jnp.sign(y), a, b)
        return jax.tree.map(lambda x, y: w[0] * jnp.sign(x)
                            + w[1] * jnp.sign(y), a, b)
    if w[0] is None:
        return jax.tree.map(lambda x, y: (x + y) / 2, a, b)
    total = w[0] + w[1]
    denom = jnp.where(total > 0, total, 1.0)
    return jax.tree.map(lambda x, y: (w[0] * x + w[1] * y) / denom, a, b)


@pytest.mark.parametrize("job", range(len(REDUCE_JOBS)))
def test_tree_reduce_two_gloo_ranks(two_ranks, job):
    msgs, _, outs = two_ranks
    name, rule, mask, stal = REDUCE_JOBS[job]
    want = _flat(_two_client_reference(name, rule, mask, stal, msgs))
    for out in outs:                  # every rank holds the same result
        np.testing.assert_array_equal(_flat(out["reduce"][job]), want)


def test_sharded_tree_compressors_two_gloo_ranks(two_ranks):
    """A tree sharded over the ranks selects as the whole tree does."""
    _, full, outs = two_ranks
    whole, st = dist_mod.stc_compress_tree(
        {"a": [torch.from_numpy(x) for x in jax.tree.leaves(full)]}, 1 / 20,
        backend="torch")
    tq, tq_st = dist_mod.ternary_quantize_tree(
        {"a": [torch.from_numpy(x) for x in jax.tree.leaves(full)]}, 0.75)
    got = np.concatenate([_flat(o["stc"][0]) for o in outs])
    np.testing.assert_array_equal(got, _flat(whole))
    got = np.concatenate([_flat(o["tq"][0]) for o in outs])
    np.testing.assert_array_equal(got, _flat(tq))
    for out in outs:
        assert int(out["stc"][1][0]) == int(st.nnz)
        assert float(out["stc"][1][3]) == float(st.thresh)
        assert int(out["tq"][1][0]) == int(tq_st.nnz)
