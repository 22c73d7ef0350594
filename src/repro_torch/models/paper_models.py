"""The paper's benchmark models, functional in PyTorch.

Counterpart of ``repro/models/paper_models.py``: logistic regression, a
small MLP, the reduced VGG11*-style CNN and a 2-layer LSTM.  Every model
has the interface

    init(gen: torch.Generator) -> params ;  apply(params, x) -> logits

with ``params`` a dict of tensors in the reference's layout -- the same
keys, HWIO convolution kernels, ``(d_in, d_out)`` dense weights and the
lstm ``layers`` list -- so that :func:`repro_torch.core.compression.
flatten_pytree` lines the flat vector up with the reference's.  Inputs keep
the reference's layout too (NHWC images); the cnn permutes to NCHW / OIHW
inside ``apply`` and back to NHWC before the flatten that feeds ``fc1``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .layers import dense_init

__all__ = ["logreg_init", "logreg_apply", "mlp_init_model", "mlp_apply_model",
           "cnn_init", "cnn_apply", "lstm_init", "lstm_apply", "MODEL_ZOO",
           "params_from_jax"]


def params_from_jax(tree, device=None, *, mesh=None, model_rank: int = 0):
    """A parameter tree of numpy arrays (e.g. a JAX model's initial values
    through ``np.asarray``) as the port's dict of fp32 tensors: the paper
    models' dicts and the TransformerLM's nested tree alike (its ``blocks``
    list of ``norm1`` / ``mix`` / ``norm2`` / ``mlp`` or ``moe`` dicts: the
    attention's ``wq``, ``wk``, ... leaves, MLA's ``w_dkv``, ``w_kr``,
    ``w_uk``, ``w_uv``, ``wo``, ``wq``, the MoE's ``router``, stacked
    ``w_down`` / ``w_gate`` / ``w_up`` and ``shared_i`` MLPs), keys and
    list order kept, so ``tree_leaves`` gives ``jax.tree.flatten``'s
    order.  With a ``mesh`` whose ``model`` axis is > 1, model rank
    ``model_rank``'s blocks of a TransformerLM tree
    (:func:`repro_torch.sharding.rules.shard_tree`), each its own
    contiguous tensor."""
    if mesh is not None and mesh.shape.get("model", 1) > 1:
        from ..core.compression import tree_map
        from ..sharding.rules import shard_tree
        return tree_map(lambda t: t.contiguous().clone(),
                        shard_tree(params_from_jax(tree), mesh, model_rank))
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return torch.as_tensor(np.array(tree, np.float32), device=device)


# -- logistic regression (paper: 7850 params on 784->10) ---------------------

def logreg_init(gen, d_in: int = 784, n_classes: int = 10):
    return {"w": dense_init(gen, d_in, n_classes, scale=0.01),
            "b": torch.zeros(n_classes)}


def logreg_apply(params, x):
    return x.reshape(x.shape[0], -1) @ params["w"] + params["b"]


# -- small MLP ----------------------------------------------------------------

def mlp_init_model(gen, d_in: int = 784, d_hidden: int = 128,
                   n_classes: int = 10):
    return {"w1": dense_init(gen, d_in, d_hidden),
            "b1": torch.zeros(d_hidden),
            "w2": dense_init(gen, d_hidden, n_classes),
            "b2": torch.zeros(n_classes)}


def mlp_apply_model(params, x):
    h = torch.relu(x.reshape(x.shape[0], -1) @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


# -- VGG11*-style CNN (reduced filters, no BN/dropout -- paper Sec. VI) -------

_VGG_FILTERS = (32, 64, 128, 128)   # reduced VGG11* column for 32x32 inputs


def cnn_init(gen, in_ch: int = 3, n_classes: int = 10, hidden: int = 128,
             img: int = 32):
    params = {}
    ch = in_ch
    for i, f in enumerate(_VGG_FILTERS):
        params[f"conv{i}"] = (torch.randn((3, 3, ch, f), generator=gen)
                              * math.sqrt(2.0 / (9 * ch)))
        ch = f
    spatial = img // (2 ** len(_VGG_FILTERS))
    params["fc1"] = dense_init(gen, ch * spatial * spatial, hidden)
    params["fc1b"] = torch.zeros(hidden)
    params["fc2"] = dense_init(gen, hidden, n_classes)
    params["fc2b"] = torch.zeros(n_classes)
    return params


def cnn_apply(params, x):
    """x: (B, H, W, C), kernels HWIO; computed in NCHW / OIHW."""
    h = x.permute(0, 3, 1, 2)
    for i in range(len(_VGG_FILTERS)):
        w = params[f"conv{i}"].permute(3, 2, 0, 1)          # HWIO -> OIHW
        h = F.max_pool2d(torch.relu(F.conv2d(h, w, padding=1)), 2)
    # back to NHWC so the flatten matches fc1's rows in the reference layout
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = torch.relu(h @ params["fc1"] + params["fc1b"])
    return h @ params["fc2"] + params["fc2b"]


# -- 2-layer LSTM (paper: rows of the image as a 28-step sequence) ------------

def lstm_init(gen, d_in: int = 28, d_hidden: int = 128, n_layers: int = 2,
              n_classes: int = 10):
    params = {"layers": []}
    d = d_in
    for _ in range(n_layers):
        params["layers"].append({
            "wx": dense_init(gen, d, 4 * d_hidden),
            "wh": dense_init(gen, d_hidden, 4 * d_hidden),
            "b": torch.zeros(4 * d_hidden),
        })
        d = d_hidden
    params["out"] = dense_init(gen, d_hidden, n_classes)
    params["out_b"] = torch.zeros(n_classes)
    return params


def _lstm_layer(lp, xs):
    """xs: (T, B, d) -> (T, B, h)."""
    h_dim = lp["wh"].shape[0]
    h = xs.new_zeros((xs.shape[1], h_dim))
    c = xs.new_zeros((xs.shape[1], h_dim))
    hs = []
    for x in xs:
        gates = x @ lp["wx"] + h @ lp["wh"] + lp["b"]
        i, f, g, o = torch.split(gates, h_dim, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs)


def lstm_apply(params, x):
    """x: (B, T, d) image rows as sequence -> logits (B, n_classes)."""
    xs = x.reshape(x.shape[0], 28, -1).permute(1, 0, 2)
    for lp in params["layers"]:
        xs = _lstm_layer(lp, xs)
    return xs[-1] @ params["out"] + params["out_b"]


MODEL_ZOO = {
    "logreg": (logreg_init, logreg_apply),
    "mlp": (mlp_init_model, mlp_apply_model),
    "cnn": (cnn_init, cnn_apply),
    "lstm": (lstm_init, lstm_apply),
}
