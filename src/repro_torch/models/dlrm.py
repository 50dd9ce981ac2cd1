"""DLRM (Naumov et al., arXiv:1906.00091), the MLPerf recsys config:
inference (forward, serve, retrieval) and training in PyTorch.

The counterpart of ``repro.models.dlrm``.  The JAX lookups become
``F.embedding`` (single-hot; its backward repeats bit for bit on the CPU,
but on the GPU not for a row looked up thousands of times in a batch, as
the small tables' rows are) and ``index_select`` + ``index_add_``
(multi-hot bags); no hand-written kernel stands behind them, as no Pallas
kernel stood behind the JAX ones.  Parameters keep the JAX package's
layout so that the two can be compared: ``{"tables": [[rows, dim]],
"bot": [{"w": [in, out], "b": [out]}], "top": [...]}`` with ``x @ w +
b``.  ``dlrm_loss`` / ``make_dlrm_train_step`` train it with the port's
AdamW.

Not ported yet: the table-parallel ``shard_map`` lookup (the sharding
slice, with the cells and the dry run).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.train import optimizer as opt
from repro_torch.tree import value_and_grad

# Criteo-1TB per-feature vocabulary sizes (MLPerf reference, max-ind-range=40M)
CRITEO_VOCAB_SIZES = [
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36,
]


@dataclasses.dataclass(frozen=True)
class DlrmConfig:
    name: str = "dlrm-mlperf"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 128
    bot_mlp: Tuple[int, ...] = (512, 256, 128)
    top_mlp: Tuple[int, ...] = (1024, 1024, 512, 256, 1)
    vocab_sizes: Tuple[int, ...] = tuple(CRITEO_VOCAB_SIZES)
    vocab_cap: int = 0          # >0: cap rows per table
    dtype: str = "float32"

    def table_rows(self) -> List[int]:
        rows = [min(v, self.vocab_cap) if self.vocab_cap else v
                for v in self.vocab_sizes]
        # padded as the JAX package pads them for an even row sharding
        # (pad rows are never looked up): big tables to /512, small to /16
        return [-(-r // 512) * 512 if r > 512 else -(-r // 16) * 16
                for r in rows]

    def interaction_dim(self) -> int:
        n_int = self.n_sparse + 1
        return n_int * (n_int - 1) // 2 + self.embed_dim

    def param_count(self) -> int:
        n = sum(self.table_rows()) * self.embed_dim
        for dims in ((self.n_dense,) + self.bot_mlp,
                     (self.interaction_dim(),) + self.top_mlp):
            n += sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
        return n


Params = Dict[str, Any]


def _mlp_init(dims, dt, gen, dev):
    return [{"w": torch.randn((a, b), generator=gen, device=dev,
                              dtype=torch.float32).div_(math.sqrt(a)).to(dt),
             "b": torch.zeros((b,), dtype=dt, device=dev)}
            for a, b in zip(dims[:-1], dims[1:])]


def init_dlrm(cfg: DlrmConfig, generator: torch.Generator,
              device: DeviceLike = None) -> Params:
    """Random parameters, made on ``device`` (``None``: the GPU) from
    ``generator``, which must live on that device.  The tables are drawn
    there directly: at the full vocabulary they cannot pass through the
    host.  N(0, 1/dim) tables and N(0, 1/fan_in) weights, as the JAX
    package draws them (other numbers: the generators differ)."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    tables = [torch.randn((r, cfg.embed_dim), generator=generator, device=dev,
                          dtype=torch.float32)
              .div_(math.sqrt(cfg.embed_dim)).to(dt)
              for r in cfg.table_rows()]
    return {"tables": tables,
            "bot": _mlp_init((cfg.n_dense,) + cfg.bot_mlp, dt, generator, dev),
            "top": _mlp_init((cfg.interaction_dim(),) + cfg.top_mlp, dt,
                             generator, dev)}


def params_from_jax(tree, device: DeviceLike = None) -> Params:
    """The JAX package's parameters (arrays of any kind numpy can read:
    ``tables``, ``bot``/``top`` lists of ``{"w", "b"}``) as the port's, on
    ``device``."""
    dev = resolve_device(device)

    def t(a):
        return torch.tensor(np.asarray(a), device=dev)

    return {"tables": [t(a) for a in tree["tables"]],
            **{k: [{"w": t(layer["w"]), "b": t(layer["b"])}
                   for layer in tree[k]] for k in ("bot", "top")}}


def _mlp(params, x):
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = torch.relu(x)
    return x


def embedding_bag(table, ids, bag_ids, n_bags: int, combiner: str = "sum"):
    """Multi-hot lookup: ids [L] rows of table, bag_ids [L] -> [n_bags, dim]
    (``sum``, or ``mean`` over each bag's rows; empty bags are zero)."""
    if combiner not in ("sum", "mean"):
        raise ValueError(f"unknown combiner {combiner!r}; use sum or mean")
    bag_ids = bag_ids.long()
    rows = table.index_select(0, ids.long())
    out = torch.zeros((n_bags, table.shape[1]), dtype=rows.dtype,
                      device=rows.device).index_add_(0, bag_ids, rows)
    if combiner == "mean":
        cnt = torch.zeros((n_bags,), dtype=torch.float32,
                          device=rows.device).index_add_(
            0, bag_ids, torch.ones_like(bag_ids, dtype=torch.float32))
        out = out / torch.clamp_min(cnt, 1.0)[:, None]
    return out


def table_parallel_lookup(tables, ids):
    """Single-hot lookup of ids [B, n_sparse] in each table, on one device
    (the JAX function's no-mesh branch; its row-sharded form waits for the
    sharding slice)."""
    return [F.embedding(ids[:, i], t) for i, t in enumerate(tables)]


def dot_interaction(vectors):
    """vectors [B, n, d] -> lower-triangle pairwise dots [B, n(n-1)/2], in
    ``np.tril_indices(n, k=-1)`` order."""
    n = vectors.shape[1]
    z = torch.bmm(vectors, vectors.transpose(1, 2))
    iu, ju = torch.tril_indices(n, n, offset=-1, device=vectors.device)
    return z[:, iu, ju]


def dlrm_forward(params: Params, batch, cfg: DlrmConfig):
    """batch: dense [B, 13] float, sparse_ids [B, 26] int (single-hot);
    returns the logits [B]."""
    x = _mlp(params["bot"], batch["dense"])                  # [B, 128]
    embs = table_parallel_lookup(params["tables"], batch["sparse_ids"])
    z = torch.stack([x] + embs, dim=1)                       # [B, 27, 128]
    feat = torch.cat([x, dot_interaction(z)], dim=-1)        # [B, 479]
    return _mlp(params["top"], feat)[:, 0]


def dlrm_loss(params: Params, batch, cfg: DlrmConfig):
    """Mean binary cross-entropy of the logits against ``labels`` [B], in
    the reference's stable form."""
    logits = dlrm_forward(params, batch, cfg).float()
    y = batch["labels"].float()
    return (torch.relu(logits) - logits * y
            + torch.log1p(torch.exp(-logits.abs()))).mean()


def make_dlrm_train_step(cfg: DlrmConfig, ocfg: opt.AdamWConfig,
                         donate: bool = False):
    """One AdamW step on ``dlrm_loss``.  ``donate`` writes the new
    parameters and moments into the ones passed in (``adamw_update``'s
    donate form): at 4M rows a table the tables, their gradients and two
    moments take ~49 GB, and a second copy of three of them would not fit
    one 80 GB card."""
    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(dlrm_loss, params, batch, cfg)
        new_params, new_state, metrics = opt.adamw_update(
            grads, opt_state, params, ocfg, donate=donate)
        metrics["loss"] = loss
        return new_params, new_state, metrics
    return train_step


def make_dlrm_serve_step(cfg: DlrmConfig):
    def serve_step(params: Params, batch):
        return torch.sigmoid(dlrm_forward(params, batch, cfg).float())
    return serve_step


def make_retrieval_step(cfg: DlrmConfig, k: int = 100):
    """Score query embeddings against candidate item embeddings (one
    matrix product, never a loop) and return the top-k.  The CRouting-ANN
    alternative lives in examples/dlrm_retrieval_torch.py."""

    def retrieval_step(query, candidates):
        # query [Bq, d], candidates [Nc, d] -> (scores [Bq, k], ids [Bq, k])
        top, idx = torch.topk(query @ candidates.T, k, dim=1)
        return top, idx

    return retrieval_step
