"""Per-family sharding rules, as data (the counterpart of
``repro.launch.sharding``).

The reference pins each parameter, optimizer moment and batch array to a
``PartitionSpec`` on a production mesh (16 x 16 ``data`` x ``model``, or 2
x 16 x 16 with ``pod``): 2-D FSDP x TP for LMs (reduction dim -> ``data``,
output dim -> ``model``), experts over ``model``, optimizer state mirroring
the parameters, GNN nodes and edges over the data axes, DLRM tables
row-sharded over every axis.  The port runs on one card, where nothing
shards, so it keeps the same rules as data for the dry run
(``launch/dryrun.py``) to read: each function takes a mesh *shape*, an
ordered ``{axis name: size}`` such as ``{"data": 16, "model": 16}``
(``mesh_shape``), and returns a tree of spec tuples, per dimension an axis
name, a tuple of axis names or ``None``, leaf by leaf as the reference's
``NamedSharding.spec`` reads.  Rules are name-based over the same path
names (``layers/wq``, ``mu/tables/0``), so they apply to parameters,
gradients and moments alike.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, Tuple

from repro_torch.tree import _is_namedtuple

MeshShape = Mapping[str, int]
Spec = Tuple[Any, ...]

MESHES: Dict[str, Dict[str, int]] = {
    "single": {"data": 1, "model": 1},
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}


def mesh_shape(name: str) -> Dict[str, int]:
    """``single`` (one card), ``16x16`` or ``2x16x16``."""
    return dict(MESHES[name])


def n_devices(mesh: MeshShape) -> int:
    return math.prod(mesh.values())


def data_axes(mesh: MeshShape) -> tuple:
    """The axes the batch dimension shards over (``pod`` folds into
    data)."""
    return tuple(a for a in mesh if a in ("pod", "data"))


def map_with_path(fn: Callable[[str, Any], Any], tree, path: str = ""):
    """``fn(path, leaf)`` over a tree of dicts, lists, tuples and
    NamedTuples, with the reference's path strings (keys, indices and
    field names joined by ``/``); the result keeps the tree's shape."""
    def join(piece):
        return f"{path}/{piece}" if path else str(piece)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, join(k)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*[map_with_path(fn, getattr(tree, f), join(f))
                            for f in tree._fields])
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, join(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def leaf_specs(tree, specs, path: str = "") -> list:
    """[(path, leaf, spec)] over a tree of tensors and the tree of spec
    tuples that shards it (a spec tuple is a leaf of ``specs``); leaves
    that are not tensors (a host int) are skipped."""
    def join(piece):
        return f"{path}/{piece}" if path else str(piece)
    if isinstance(tree, dict):
        return [x for k in tree for x in leaf_specs(tree[k], specs[k],
                                                    join(k))]
    if _is_namedtuple(tree):
        return [x for f in tree._fields for x in leaf_specs(
            getattr(tree, f), getattr(specs, f), join(f))]
    if isinstance(tree, (list, tuple)):
        return [x for i, (t, sp) in enumerate(zip(tree, specs))
                for x in leaf_specs(t, sp, join(i))]
    return [(path, tree, specs)] if hasattr(tree, "element_size") else []


def spec(*entries) -> Spec:
    """A spec tuple as ``NamedSharding.spec`` reads it: an entry that names
    one axis in a tuple becomes that name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _rule_map(rule, tree):
    return map_with_path(lambda name, leaf: spec(*rule(name, leaf)), tree)


def _rep(leaf) -> Spec:
    return (None,) * len(leaf.shape)


# --------------------------------------------------------------------------
# LM rules
# --------------------------------------------------------------------------
def lm_param_sharding(mesh: MeshShape, params) -> Any:
    del mesh        # the LM rules name axes only

    def rule(name, leaf):
        nd = len(leaf.shape)
        if "embed" in name:
            return ("model", None)
        if "lm_head" in name:
            return (None, "model")
        if name.endswith("final_norm") or "norm" in name:
            return (None,) * nd
        if any(k in name for k in ("we_gate", "we_up")):      # [L, E, D, F]
            return (None, "model", "data", None)
        if "we_down" in name:                                  # [L, E, F, D]
            return (None, "model", None, "data")
        if name.endswith("/gate"):
            return (None, "data", None)                        # router [L, D, E]
        if any(k in name for k in ("wq", "wk", "wv", "w_gate", "w_up",
                                   "wr_gate", "wr_up")):
            return (None, "data", "model")                     # [L, D, out]
        if any(k in name for k in ("wo", "w_down", "wr_down")):
            return (None, "model", "data")                     # [L, in, D]
        if any(k in name for k in ("bq", "bk", "bv")):
            return (None, "model")
        return (None,) * nd

    return _rule_map(rule, params)


def lm_opt_sharding(mesh: MeshShape, opt_state, param_specs) -> Any:
    """AdamWState(step, mu, nu): the moments mirror the parameter rule."""
    return type(opt_state)(step=(), mu=param_specs, nu=param_specs)


def lm_batch_sharding(mesh: MeshShape) -> Any:
    d = data_axes(mesh)
    return {"tokens": spec(d, None), "labels": spec(d, None)}


def _batch_devices(mesh: MeshShape) -> int:
    return math.prod(mesh[a] for a in data_axes(mesh))


def lm_cache_sharding(mesh: MeshShape, batch: int, seq: int) -> Any:
    """KV cache [L, B, T, Hkv, dh]: B over the data axes when it divides,
    otherwise the sequence axis (long-context decode)."""
    d = data_axes(mesh)
    ndev = _batch_devices(mesh)
    if batch % ndev == 0 and batch >= ndev:
        kv = ((None, d, "model", None, None) if seq % mesh["model"] == 0
              else (None, d, None, None, None))
    else:
        kv = ((None, None, d + ("model",), None, None)
              if seq % (ndev * mesh["model"]) == 0
              else (None, None, d, None, None))
    return {"k": spec(*kv), "v": spec(*kv)}


def lm_token_sharding(mesh: MeshShape, batch: int) -> Spec:
    ndev = _batch_devices(mesh)
    return (spec(data_axes(mesh), None) if batch % ndev == 0
            and batch >= ndev else (None, None))


# --------------------------------------------------------------------------
# GNN rules
# --------------------------------------------------------------------------
def gnn_param_sharding(mesh: MeshShape, params) -> Any:
    """GNN parameters are tiny (< 1M): replicated."""
    return map_with_path(lambda name, leaf: _rep(leaf), params)


def gnn_batch_sharding(mesh: MeshShape, batch) -> Any:
    d = data_axes(mesh)

    def rule(name, leaf):
        if name.startswith("edge_"):
            return (d + ("model",),)      # edges over every device
        if name in ("node_feat", "pos"):
            return (d, None)              # nodes over the data axes
        if name in ("atom_z", "node_mask", "labels", "label_mask",
                    "graph_ids"):
            return (d,)
        return _rep(leaf)

    return _rule_map(rule, batch)


# --------------------------------------------------------------------------
# DLRM rules
# --------------------------------------------------------------------------
def dlrm_param_sharding(mesh: MeshShape, params) -> Any:
    """Tables row-shard over every mesh axis (``model`` alone where the
    rows do not divide the device count); the MLPs are replicated.
    Matches parameters and moments (``tables/0``, ``mu/tables/0``)."""
    all_axes = tuple(mesh)
    ndev = n_devices(mesh)

    def rule(name, leaf):
        if "tables/" in name + "/":
            if leaf.shape[0] % ndev == 0:
                return (all_axes, None)
            return ("model", None)
        return _rep(leaf)

    return _rule_map(rule, params)


def dlrm_batch_sharding(mesh: MeshShape, batch: int) -> Any:
    """The batch is replicated: every table shard sees every id for its
    masked gather, and the batch is ~10 MB against 96 GB of tables."""
    return {"dense": (None, None), "sparse_ids": (None, None),
            "labels": (None,)}


# --------------------------------------------------------------------------
# ANNS (the reference's ``make_serve_step`` in_shardings)
# --------------------------------------------------------------------------
def anns_serve_sharding(mesh: MeshShape) -> tuple:
    """The ten per-shard tables split their leading (shard) axis over
    every mesh axis; the queries, ``cos_theta`` and the valid mask are
    replicated."""
    return (spec(tuple(mesh)),) * 10 + ((),) * 3


def spec_devices(mesh: MeshShape, sp: Spec) -> list:
    """How many ways each dimension of a leaf splits under ``sp``."""
    out = []
    for entry in sp:
        axes = (() if entry is None else (entry,) if isinstance(entry, str)
                else entry)
        out.append(math.prod(mesh[a] for a in axes))
    return out


def per_device_bytes(mesh: MeshShape, leaf, sp: Spec) -> float:
    """A leaf's bytes on one device under ``sp`` (its split dimensions
    rounded up, as an uneven shard pads)."""
    n = 1
    splits = spec_devices(mesh, sp) + [1] * (len(leaf.shape) - len(sp))
    for size, ways in zip(leaf.shape, splits):
        n *= -(-size // ways)
    return float(n * leaf.element_size())
