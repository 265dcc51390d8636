"""Sharding rules: parameter and input PartitionSpecs per workload family
(the port's copy of ``repro.runtime.sharding``).

Scheme: FSDP over the data axis (params and optimizer state sharded on a
non-contracting dim), Megatron TP over the model axis (attention's
combined head dim, the FFN's inner dim, the vocabulary), EP for MoE
experts, sequence sharding for long-context KV caches. The pod axis
composes with data for cross-pod DP.

The rules read only a mesh's ``axis_names`` and ``shape``, so they take
the port's ``launch.mesh.Mesh`` (or anything with those two) and give the
same specs as JAX's, as ``launch.mesh.PartitionSpec`` tuples.
:func:`shardings_from_rules` turns them into ``launch.mesh.Placement``s:
``place_tree`` then splits each leaf over the mesh as JAX's
``NamedSharding`` would, evenly or not at all (an uneven split raises).
"""
from __future__ import annotations

import re

from repro_torch.launch.mesh import Mesh, PartitionSpec as P, Placement
from repro_torch.optim.optimizers import tree_paths as _dict_paths


def batch_axes(mesh: Mesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _match(rules, path: str):
    for pat, spec in rules:
        if re.search(pat, path):
            return spec
    return P()


def tree_paths(tree) -> tuple[list, list]:
    """(/-joined paths, leaves) of a nested dict, in ``jax.tree.leaves``
    order (keys sorted at every level)."""
    pairs = list(_dict_paths(tree))
    return ["/".join(str(k) for k in p) for p, _ in pairs], \
        [v for _, v in pairs]


def _map_paths(tree: dict, fn) -> dict:
    """``fn(/-joined path)`` at every leaf of a nested dict."""
    out: dict = {}
    for path, _ in _dict_paths(tree):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = fn("/".join(str(k) for k in path))
    return out


def specs_from_rules(tree, rules) -> dict:
    """Nested dict of PartitionSpecs, matched by /-joined param path."""
    return _map_paths(tree, lambda p: _match(rules, p))


def shardings_from_rules(tree, rules, mesh: Mesh) -> dict:
    """Nested dict of ``Placement(mesh, spec=...)``: ``place_tree(tree,
    shardings_from_rules(tree, rules, mesh))`` splits every leaf over
    ``mesh`` by its rule."""
    return _map_paths(tree, lambda p: Placement(mesh, spec=_match(rules, p)))


# --------------------------------------------------------------------------
# LM rules. Layer-stacked params carry a leading (L,) axis → specs start
# with None. fsdp = the data axis (or ("pod","data") multi-pod).
# --------------------------------------------------------------------------

def lm_param_rules(mesh: Mesh, *, fsdp: bool = True) -> list:
    da = batch_axes(mesh)
    d = da if fsdp else None
    return [
        (r"embed$",            P("model", d)),       # (V, d)
        (r"lm_head$",          P(d, "model")),       # (d, V)
        (r"attn/wq$",          P(None, d, "model")),  # (L, d, H·hd)
        (r"attn/wk$",          P(None, d, "model")),
        (r"attn/wv$",          P(None, d, "model")),
        (r"attn/wo$",          P(None, "model", d)),  # (L, H·hd, d)
        (r"mlp/w[ig]$",        P(None, d, "model")),  # (L, d, ff)
        (r"mlp/wo$",           P(None, "model", d)),  # (L, ff, d)
        (r"moe/router$",       P(None, d, None)),     # (L, d, E)
        (r"moe/w[ig]$",        P(None, "model", d, None)),  # (L, E, d, f) EP
        (r"moe/wo$",           P(None, "model", d, None)),  # (L, E, f, d) EP
        (r"ln", P()),
    ]


def lm_param_rules_zero(mesh: Mesh) -> list:
    """ZeRO-3 rules: dense layer weights sharded on ONE dim over the WHOLE
    mesh, so the forward all-gathers each layer's weights once and the
    backward reduce-scatters the gradients. Embedding and head keep the
    vocab-TP layout; MoE experts keep EP on model, their ff dim on data."""
    da = batch_axes(mesh)
    allax = da + ("model",)
    return [
        (r"embed$",            P("model", da)),
        (r"lm_head$",          P(da, "model")),
        (r"attn/w[qkvo]$",     P(None, allax, None)),
        (r"mlp/w[ig]$",        P(None, allax, None)),   # (L, d, ff)
        (r"mlp/wo$",           P(None, None, allax)),   # (L, ff, d): ff may
        # not divide the whole mesh (deepseek 19200), d always does
        (r"moe/router$",       P(None, da, None)),
        (r"moe/w[ig]$",        P(None, "model", None, da)),  # (L,E,d,f)
        (r"moe/wo$",           P(None, "model", da, None)),  # (L,E,f,d)
        (r"ln", P()),
    ]


def _n_dp(mesh: Mesh) -> int:
    n = 1
    for a in batch_axes(mesh):
        n *= mesh.shape[a]
    return n


def lm_input_specs(mesh: Mesh, *, batch: int) -> dict:
    da = batch_axes(mesh)
    bspec = P(da) if batch % _n_dp(mesh) == 0 else (
        P("data") if batch % mesh.shape["data"] == 0 else P())
    return {"tokens": bspec, "labels": bspec}


def lm_cache_spec(mesh: Mesh, *, batch: int, seq: int) -> P:
    """KV cache stored (L, B, S, H, hd): batch on data when divisible,
    else the sequence over (data, model)."""
    da = batch_axes(mesh)
    if batch % _n_dp(mesh) == 0:
        return P(None, da, "model", None, None)   # seq also on model
    # long-context, tiny batch: shard sequence over everything
    return P(None, None, da + ("model",), None, None)


# --------------------------------------------------------------------------
# GNN rules: node/edge arrays sharded on data(+pod); weights replicated
# (they are tiny); the SDP halo path is runtime.gnn_sharded.
# --------------------------------------------------------------------------

def gnn_param_rules(mesh: Mesh) -> list:
    return [(r".*", P())]


def gnn_input_specs(mesh: Mesh) -> dict:
    da = batch_axes(mesh)
    return {
        "senders": P(da), "receivers": P(da),
        "node_feat": P(da, None), "node_mask": P(da),
        "targets": P(da, None), "positions": P(da, None),
        "species": P(da), "graph_id": P(da),
    }


# --------------------------------------------------------------------------
# RecSys rules: embedding tables row-sharded over the whole mesh; towers
# replicated (small); batch on data(+pod).
# --------------------------------------------------------------------------

def recsys_param_rules(mesh: Mesh) -> list:
    rows = batch_axes(mesh) + ("model",)
    return [
        (r"(user|item)_table$", P(rows, None)),
        (r"tower", P()),
    ]


def recsys_input_specs(mesh: Mesh, *, batch: int) -> dict:
    da = batch_axes(mesh)
    bspec = P(da) if batch % _n_dp(mesh) == 0 else P()
    return {
        "user_ids": P(*bspec, None, None) if bspec != P() else P(),
        "item_ids": P(*bspec, None, None) if bspec != P() else P(),
        "log_q": bspec,
        "cand_item_emb": P(("data", "model"), None),
    }
