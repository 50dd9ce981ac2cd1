"""Cell builder: (architecture x input shape) -> a step, its arguments on
the meta device and their sharding specs (the counterpart of
``repro.models.api``).

The dry run (``launch/dryrun.py``) and the roofline consume Cells; smoke
tests consume ``build_smoke``.  A cell holds no parameter data: its
arguments are meta tensors (shapes and dtypes) for the full configs, and
its shardings are the spec tuples of ``launch/sharding.py``.  ``mesh`` is a
mesh shape, ``{axis: size}`` (``sharding.mesh_shape``).

Two steps read a tensor on the host and cannot run on meta: the ANNS hop
loop (it stops on ``done.all()``), whose cell carries analytic per-hop
terms (``body_terms``) that the dry run multiplies by ``body_multiplier``;
and the LM decode, whose ``cur_len`` is a host int (its cell passes one).
``model_flops``, ``_lm_analytic_extra``, ``_gnn_flops`` and the ANNS
``hops = 1.5 * efs`` are the reference's formulas, copied.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import ArchSpec, ShapeSpec
from repro_torch.launch import sharding as SH
from repro_torch.train import optimizer as opt

META = torch.device("meta")


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_id: str
    step_name: str
    step_fn: Callable
    arg_specs: Tuple           # trees of meta tensors (a host int for cur_len)
    in_shardings: Any          # trees of spec tuples (launch/sharding.py)
    out_shardings: Any         # None: no constraint
    model_flops: float         # "useful" flops (the 6*N*D convention)
    notes: str = ""
    static_argnums: Tuple[int, ...] = ()
    # The reference's loop-corrected accounting: ``loop_fit`` = (L, build(L)
    # -> Cell) for the two-point fit of the per-layer cost; ``analytic_extra``
    # is what XLA's cost analysis missed in the attention and loss scans
    # (the port's meta count walks every tile, so the dry run records it
    # beside and adds nothing); ``body_multiplier`` scales a data-dependent
    # loop's body (one ANNS hop).
    loop_fit: Optional[Tuple[int, Callable]] = None
    analytic_extra: Optional[Dict[str, float]] = None
    body_multiplier: float = 1.0
    # per body execution, for a step that cannot run on meta: flops and
    # bytes (one ANNS hop over the batch)
    body_terms: Optional[Dict[str, float]] = None


def meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=getattr(torch, dtype)
                       if isinstance(dtype, str) else dtype, device=META)


OCFG = opt.AdamWConfig()
OCFG_BF16 = opt.AdamWConfig(state_dtype="bfloat16")


def _gen() -> torch.Generator:
    """A CPU generator: the meta inits draw nothing from it."""
    return torch.Generator()


# ==========================================================================
# LM family
# ==========================================================================
def _lm_analytic_extra(cfg, B, S, mesh, train: bool) -> Dict[str, float]:
    """The reference's per-device flops/bytes for the attention tile scans
    and the loss-chunk scan, which XLA's cost analysis counts once."""
    H, dh, D = cfg.n_heads, cfg.dh, cfg.d_model
    L = cfg.n_layers
    n_dev = int(np.prod([mesh[a] for a in mesh]))
    dp = n_dev // mesh.get("model", 1)
    # attention work replicates over 'model' when H doesn't shard evenly
    attn_div = n_dev if H % mesh.get("model", 1) == 0 else dp
    nq = max(S // min(cfg.block_q, S), 1)
    nk = max(S // min(cfg.block_k, S), 1)
    miss = 1.0 - 1.0 / (nq * nk)
    pass_f = 4.5 if train else 1.0     # fwd + remat-recompute + flash bwd
    attn_flops = pass_f * 4.0 * B * H * S * S * dh * L * miss / attn_div
    attn_bytes = (3.0 if train else 1.0) * nq * nk * B * H * dh \
        * (min(cfg.block_q, S) + 2 * min(cfg.block_k, S)) * 4.0 * L \
        * miss / attn_div
    out = {"flops": attn_flops, "bytes": attn_bytes}
    if train:
        nc = max(S // min(cfg.loss_chunk, S), 1)
        mc = 1.0 - 1.0 / nc
        V = cfg.padded_vocab
        out["flops"] += mc * 6.0 * B * S * D * V / n_dev
        out["bytes"] += mc * nc * (D * V * 2.0 + B * (S // nc) * V * 4.0) \
            * 2.0 / n_dev
    return out


def _lm_cell(spec: ArchSpec, shape: ShapeSpec, mesh, _cfg_override=None) -> Cell:
    from repro_torch.models import transformer as T

    cfg = _cfg_override or spec.model_cfg
    B, S = shape.dims["global_batch"], shape.dims["seq_len"]
    ocfg = OCFG_BF16 if cfg.param_count() > 1e11 else OCFG
    params = T.init_params(cfg, _gen(), device=META)
    p_sh = SH.lm_param_sharding(mesh, params)
    n_act = cfg.active_param_count()

    def fit_builder(L):
        sub = dataclasses.replace(cfg, n_layers=L)
        return _lm_cell(spec, shape, mesh, _cfg_override=sub)

    loop_fit = None if _cfg_override else (cfg.n_layers, fit_builder)

    if shape.step == "train":
        state = opt.adamw_init(params, ocfg)
        o_sh = SH.lm_opt_sharding(mesh, state, p_sh)
        b_sh = SH.lm_batch_sharding(mesh)
        batch = {"tokens": meta((B, S), "int32"),
                 "labels": meta((B, S), "int32")}
        return Cell(spec.arch_id, shape.shape_id, "train_step",
                    T.make_train_step(cfg, ocfg), (params, state, batch),
                    (p_sh, o_sh, b_sh), (p_sh, o_sh, None),
                    model_flops=6.0 * n_act * B * S,
                    notes=f"N_active={n_act:.3e}",
                    loop_fit=loop_fit,
                    analytic_extra=_lm_analytic_extra(cfg, B, S, mesh, True))

    if shape.step == "prefill":
        tok_sh = SH.lm_token_sharding(mesh, B)
        return Cell(spec.arch_id, shape.shape_id, "prefill_step",
                    T.make_prefill_step(cfg),
                    (params, meta((B, S), "int32")),
                    (p_sh, tok_sh), None,
                    model_flops=2.0 * n_act * B * S,
                    loop_fit=loop_fit,
                    analytic_extra=_lm_analytic_extra(cfg, B, S, mesh, False))

    # serve: one-token decode against a KV cache of length S; cur_len is a
    # host int (the last slot: the token attends over the whole cache)
    kv = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.dh)
    cache = {"k": meta(kv, cfg.dtype), "v": meta(kv, cfg.dtype)}
    c_sh = SH.lm_cache_sharding(mesh, B, S)
    tok_sh = SH.lm_token_sharding(mesh, B)
    attn_flops = 4.0 * B * cfg.n_layers * cfg.n_heads * cfg.dh * S
    return Cell(spec.arch_id, shape.shape_id, "serve_step",
                T.make_serve_step(cfg),
                (params, cache, meta((B, 1), "int32"), S - 1),
                (p_sh, c_sh, tok_sh, ()), None,
                model_flops=2.0 * n_act * B + attn_flops,
                notes="decode; KV " + ("seq-sharded" if B == 1 else "batch-sharded"),
                loop_fit=loop_fit)


# ==========================================================================
# GNN family
# ==========================================================================
def _pad512(x: int) -> int:
    """Node and edge counts padded to a multiple of 512 (the largest device
    count), as the reference pads them; pad entries carry zero masks."""
    return -(-x // 512) * 512


def _gnn_dims(shape: ShapeSpec):
    d = shape.dims
    if shape.shape_id == "minibatch_lg":
        n, e = d["sub_nodes"], d["sub_edges"]
        f, c, g = d["d_feat"], d.get("n_classes", 16), 1
    elif shape.shape_id == "molecule":
        n, e = d["n_nodes"] * d["batch"], d["n_edges"] * d["batch"]
        f, c, g = d["d_feat"], 16, d["batch"]
    else:
        n, e = d["n_nodes"], d["n_edges"]
        f, c, g = d["d_feat"], d.get("n_classes", 16), 1
    return _pad512(n), _pad512(e), f, c, g


def _gnn_batch(n, e, f, g, task):
    return {
        "node_feat": meta((n, f), "float32"),
        "pos": meta((n, 3), "float32"),
        "atom_z": meta((n,), "int32"),
        "edge_src": meta((e,), "int32"),
        "edge_dst": meta((e,), "int32"),
        "node_mask": meta((n,), "float32"),
        "edge_mask": meta((e,), "float32"),
        "labels": meta((n,), "int32"),
        "label_mask": meta((n,), "float32"),
        "graph_ids": meta((n,), "int32"),
        "g_labels": meta((g,), "int32" if task == "graph_class"
                         else "float32"),
    }


def _gnn_flops(cfg, n, e, f):
    d = cfg.d_hidden
    if cfg.arch == "gin":
        return cfg.n_layers * (2 * e * d + 4 * n * d * d) + 2 * n * f * d
    if cfg.arch == "gat":
        h = cfg.n_heads
        return cfg.n_layers * (2 * n * f * h * d + 4 * e * h * d)
    if cfg.arch == "schnet":
        return cfg.n_layers * (2 * e * (cfg.n_rbf * d + d * d) + 4 * n * d * d)
    if cfg.arch == "egnn":
        return cfg.n_layers * (2 * e * (2 * d + 1) * d + 2 * e * d * d
                               + 4 * n * d * d)
    return 2.0 * e * d


def _gnn_cell(spec: ArchSpec, shape: ShapeSpec, mesh) -> Cell:
    from repro_torch.models import gnn as G

    n, e, f, ncls, g = _gnn_dims(shape)
    task = spec.model_cfg.task
    if shape.shape_id == "molecule" and task == "node_class":
        task = "graph_class"
    cfg = dataclasses.replace(spec.model_cfg, n_classes=ncls, task=task)
    params = G.init_gnn(cfg, f, _gen(), device=META)
    p_sh = SH.gnn_param_sharding(mesh, params)
    batch = _gnn_batch(n, e, f, g, task)
    b_sh = SH.gnn_batch_sharding(mesh, batch)
    state = opt.adamw_init(params, OCFG)
    o_sh = SH.gnn_param_sharding(mesh, state)
    return Cell(spec.arch_id, shape.shape_id, "train_step",
                G.make_gnn_train_step(cfg, OCFG), (params, state, batch),
                (p_sh, o_sh, b_sh), (p_sh, o_sh, None),
                model_flops=3.0 * _gnn_flops(cfg, n, e, f),
                notes=f"task={task} n={n} e={e}")


# ==========================================================================
# RecSys family
# ==========================================================================
def _dlrm_cell(spec: ArchSpec, shape: ShapeSpec, mesh) -> Cell:
    from repro_torch.models import dlrm as R

    cfg = spec.model_cfg
    params = R.init_dlrm(cfg, _gen(), device=META)
    p_sh = SH.dlrm_param_sharding(mesh, params)

    if shape.step == "retrieval":
        Bq, Nc = shape.dims["batch"], shape.dims["n_candidates"]
        d = cfg.embed_dim
        # 1e6 rows shard evenly over the data axes (16 / 32), not over model
        cand_sh = SH.spec(SH.data_axes(mesh), None)
        return Cell(spec.arch_id, shape.shape_id, "retrieval_step",
                    R.make_retrieval_step(cfg),
                    (meta((Bq, d), "float32"), meta((Nc, d), "float32")),
                    ((None, None), cand_sh), None,
                    model_flops=2.0 * Bq * Nc * d,
                    notes="brute-force scorer; CRouting-ANN variant in examples")

    B = shape.dims["batch"]
    mlp_flops = 0
    dims = (cfg.n_dense,) + cfg.bot_mlp
    mlp_flops += sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    n_int = cfg.n_sparse + 1
    dims = (n_int * (n_int - 1) // 2 + cfg.embed_dim,) + cfg.top_mlp
    mlp_flops += sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    mlp_flops += 2 * n_int * n_int * cfg.embed_dim
    batch = {"dense": meta((B, cfg.n_dense), "float32"),
             "sparse_ids": meta((B, cfg.n_sparse), "int32"),
             "labels": meta((B,), "float32")}
    b_sh = SH.dlrm_batch_sharding(mesh, B)

    if shape.step == "train":
        state = opt.adamw_init(params, OCFG)
        o_sh = SH.dlrm_param_sharding(mesh, state)
        return Cell(spec.arch_id, shape.shape_id, "train_step",
                    R.make_dlrm_train_step(cfg, OCFG), (params, state, batch),
                    (p_sh, o_sh, b_sh), (p_sh, o_sh, None),
                    model_flops=3.0 * B * mlp_flops)

    del batch["labels"]
    del b_sh["labels"]
    return Cell(spec.arch_id, shape.shape_id, "serve_step",
                R.make_dlrm_serve_step(cfg),
                (params, batch), (p_sh, b_sh), None,
                model_flops=1.0 * B * mlp_flops)


# ==========================================================================
# ANNS family (the paper's own system)
# ==========================================================================
def make_anns_serve(cfg, ns: int):
    """The cell's step over the stacked shard arrays (the reference's
    ``shard_map`` step's thirteen arguments): each shard's search on the
    device its arrays lie on, then the efs-wide merge on the first one
    (``core.sharded_index.make_serve_step``).  Returns (dists [B, efs],
    global ids [B, efs], the counter vector)."""
    from repro_torch.core.sharded_index import make_serve_step

    local_search, merge = make_serve_step(cfg, ns)

    def serve(vectors, neighbors, edge_eu, norms, entries, offsets,
              sq8_codes, sq8_lo, sq8_scale, sq8_eps, queries, cos_theta,
              valid):
        parts = []
        for s in range(vectors.shape[0]):
            shard = {"vectors": vectors[s], "neighbors": neighbors[s],
                     "edge_eu": edge_eu[s], "norms": norms[s],
                     "entry": int(entries[s]), "n": ns,
                     "sq8_codes": sq8_codes[s], "sq8_lo": sq8_lo[s],
                     "sq8_scale": sq8_scale[s], "sq8_eps": sq8_eps[s],
                     "offset": int(offsets[s])}
            dev = vectors[s].device
            parts.append(local_search(shard, queries.to(dev),
                                      float(cos_theta), valid.to(dev)))
        return merge(parts)

    return serve


def _anns_cell(spec: ArchSpec, shape: ShapeSpec, mesh) -> Cell:
    from repro_torch.core.spec import SearchSpec

    d = shape.dims
    n_shards = SH.n_devices(mesh)
    ns = -(-d["n_total"] // n_shards)
    m = d["max_degree"]
    dim, B, efs, k = d["dim"], d["batch"], d["efs"], d["k"]
    cfg = SearchSpec(efs=efs, k=k, router=spec.model_cfg.router, metric="l2",
                     max_hops=2 * efs, use_hierarchy=False)
    # k is request-only: the step merges efs-wide and the host slices to k
    serve = make_anns_serve(cfg.canonical(), ns)
    vdt = getattr(spec.model_cfg, "vec_dtype", "float32")
    arg_specs = (
        meta((n_shards, ns + 1, dim), vdt),
        meta((n_shards, ns + 1, m), "int32"),
        meta((n_shards, ns + 1, m), vdt),      # stored edge dists follow
        meta((n_shards, ns + 1), "float32"),
        meta((n_shards,), "int32"),
        meta((n_shards,), "int32"),
        meta((n_shards, ns + 1, dim), "uint8"),   # SQ8 code table
        meta((n_shards, dim), "float32"),         # SQ8 grid lo
        meta((n_shards, dim), "float32"),         # SQ8 grid scale
        meta((n_shards, dim), "float32"),         # SQ8 error radius
        meta((B, dim), "float32"),
        meta((), "float32"),
        meta((B,), "bool"),                       # bucket-pad valid mask
    )
    # useful work ~ exact distance evals: efs expansions x m neighbors x 2d
    flops = 2.0 * B * efs * m * dim
    # the best-first loop body == ONE expansion (hop) across all query
    # lanes; empirical hops/query ~= 1.5*efs (benchmarks/bench_paper.py)
    hops = 1.5 * efs
    # one hop reads, per lane, its node's m neighbour ids and stored edge
    # lengths and (at most) the m neighbour rows, and computes m distances
    vbytes = torch.empty((), dtype=getattr(torch, vdt)).element_size()
    body = {"flops": 2.0 * B * m * dim,
            "bytes": float(B * m * (4 + vbytes + dim * vbytes))}
    return Cell(spec.arch_id, shape.shape_id, "anns_serve_step", serve,
                arg_specs, SH.anns_serve_sharding(mesh), ((),) * 3,
                model_flops=flops,
                notes=f"shards={n_shards} ns={ns} router={spec.model_cfg.router} "
                      f"hop_multiplier={hops:.0f}",
                body_multiplier=hops, body_terms=body)


# ==========================================================================
# public API
# ==========================================================================
_BUILDERS = {"lm": _lm_cell, "gnn": _gnn_cell, "recsys": _dlrm_cell,
             "anns": _anns_cell}


def build_cell(spec: ArchSpec, shape_id: str, mesh) -> Cell:
    """The cell of ``spec`` at ``shape_id`` on a mesh shape (``{axis:
    size}``, ``sharding.mesh_shape("single")`` for one card)."""
    return _BUILDERS[spec.family](spec, spec.shape(shape_id), mesh)


def cell_arg_bytes(cell: Cell) -> float:
    """Bytes of every tensor argument of a cell, each counted once."""
    from repro_torch.tree import tree_leaves
    return float(sum(t.numel() * t.element_size()
                     for t in tree_leaves(cell.arg_specs)
                     if isinstance(t, torch.Tensor)))


# --------------------------------------------------------------------------
# smoke builders: reduced config + real (tiny) data, one step
# --------------------------------------------------------------------------
def build_smoke(spec: ArchSpec, seed: int = 0, device=None):
    """Returns ``run()``: one reduced-config step of the arch's family on
    ``device`` (``None``: the GPU), returning a dict of outputs."""
    from repro_torch.data import synthetic as syn
    from repro_torch.device import resolve_device

    dev = resolve_device(device)

    def on_dev(tree):
        return {k: torch.as_tensor(np.asarray(v), device=dev)
                for k, v in tree.items()}

    gen = torch.Generator(device=dev).manual_seed(seed)
    if spec.family == "lm":
        from repro_torch.models import transformer as T
        cfg = spec.smoke_cfg
        params = T.init_params(cfg, gen, device=dev)
        ocfg = opt.AdamWConfig(lr=1e-3)
        state = opt.adamw_init(params, ocfg)
        batch = on_dev(syn.lm_batch(cfg.vocab, 2, 32, seed))
        ts = T.make_train_step(cfg, ocfg)

        def run():
            p2, _, m = ts(params, state, batch)
            kv = (cfg.n_layers, 2, 16, cfg.n_kv_heads, cfg.dh)
            cache = {"k": torch.zeros(kv, dtype=cfg.torch_dtype, device=dev),
                     "v": torch.zeros(kv, dtype=cfg.torch_dtype, device=dev)}
            logits, _ = T.make_serve_step(cfg)(p2, cache,
                                               batch["tokens"][:, :1], 0)
            return {"loss": m["loss"], "logits": logits}
        return run

    if spec.family == "gnn":
        from repro_torch.models import gnn as G
        cfg = spec.smoke_cfg
        b = on_dev(syn.random_graph_batch(64, 256, 8, cfg.n_classes,
                                          n_graphs=4, seed=seed,
                                          task=cfg.task))
        params = G.init_gnn(cfg, 8, gen, device=dev)
        state = opt.adamw_init(params, OCFG)
        ts = G.make_gnn_train_step(cfg, OCFG)

        def run():
            _, _, m = ts(params, state, b)
            with torch.no_grad():
                out = G.gnn_forward(params, b, cfg)
            return {"loss": m["loss"], "out": out}
        return run

    if spec.family == "recsys":
        from repro_torch.models import dlrm as R
        cfg = spec.smoke_cfg
        params = R.init_dlrm(cfg, gen, device=dev)
        state = opt.adamw_init(params, OCFG)
        b = on_dev(syn.dlrm_batch(cfg.n_dense, cfg.table_rows(), 64, seed))
        ts = R.make_dlrm_train_step(cfg, OCFG)

        def run():
            _, _, m = ts(params, state, b)
            with torch.no_grad():
                scores = R.make_dlrm_serve_step(cfg)(
                    params, {k: b[k] for k in ("dense", "sparse_ids")})
            return {"loss": m["loss"], "out": scores}
        return run

    # anns
    from repro_torch.core.index import AnnIndex
    from repro_torch.core.spec import SearchSpec
    from repro_torch.data.vectors import make_dataset

    def run():
        ds = make_dataset(n_base=600, n_query=8, dim=32, n_clusters=8,
                          seed=seed)
        idx = AnnIndex.build(ds.base, graph=spec.smoke_cfg.graph,
                             m=spec.smoke_cfg.m, efc=spec.smoke_cfg.efc,
                             device=dev)
        ids, dists, stats = idx.search(
            ds.queries, spec=SearchSpec(k=5, efs=32,
                                        router=spec.smoke_cfg.router))
        return {"loss": torch.zeros(()), "out": torch.as_tensor(dists),
                "ids": ids, "dist_calls": stats.dist_calls}
    return run


def count_dtype(cell: Cell) -> str:
    """The dtype whose peak bounds the cell's products: the LM configs'
    parameter dtype (bf16 at full width); the GNN, DLRM and ANNS cells
    multiply in fp32 (TF32 off)."""
    if cell.arg_specs and isinstance(cell.arg_specs[0], dict):
        from repro_torch.tree import tree_leaves
        leaves = [t for t in tree_leaves(cell.arg_specs[0])
                  if isinstance(t, torch.Tensor) and t.is_floating_point()]
        if leaves and all(t.dtype == torch.bfloat16 for t in leaves):
            return "bfloat16"
    return "float32"

