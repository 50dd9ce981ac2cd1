"""DLRM (Naumov et al., arXiv:1906.00091), the MLPerf recsys config:
inference (forward, serve, retrieval) and training in PyTorch.

The counterpart of ``repro.models.dlrm``.  The JAX lookups become
``lookup.embedding`` (single-hot) and ``lookup.embedding`` +
``lookup.segment_sum`` (multi-hot bags): each backward, and the bag sum,
adds a row's duplicates in a fixed order (the ``segment_sum`` kernel on
the card), so a training step repeats bit for bit on the GPU too, where
``F.embedding``'s backward did not for the small tables' rows, each
looked up thousands of times a batch.  Parameters keep the JAX package's
layout so that the two can be compared: ``{"tables": [[rows, dim]],
"bot": [{"w": [in, out], "b": [out]}], "top": [...]}`` with ``x @ w +
b``.  ``dlrm_loss`` / ``make_dlrm_train_step`` train it with the port's
AdamW.

Tables row-shard over the slots of a ``LocalMesh`` with ``shard_tables``
(the counterpart of the reference's ``shard_map`` lookup):
``table_parallel_lookup`` then gathers on each slot the rows it owns and
sums the partials in slot order, with the same bits as the lookup of the
whole tables.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import LocalMesh
from repro_torch.models import lookup
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
    (``sum``, or ``mean`` over each bag's rows; empty bags are zero), each
    bag's rows added in increasing position."""
    if combiner not in ("sum", "mean"):
        raise ValueError(f"unknown combiner {combiner!r}; use sum or mean")
    bag_ids = bag_ids.long()
    rows = lookup.embedding(ids.long(), table)
    out = lookup.segment_sum(rows, bag_ids, n_bags)
    if combiner == "mean":
        cnt = lookup.segment_sum(torch.ones_like(bag_ids, dtype=torch.float32),
                                 bag_ids, n_bags)
        out = out / torch.clamp_min(cnt, 1.0)[:, None]
    return out


def shard_tables(tables, mesh: LocalMesh):
    """The tables row-sharded over ``mesh``'s S slots, as the reference's
    ``dlrm_param_sharding`` places them: a table whose rows divide S (and
    number at least S) becomes a tuple of S row blocks, block s on slot
    s's device (a view of the table where that is its device); any other
    table stays whole on the first slot's device."""
    devs = mesh.devices
    S = len(devs)
    out = []
    for t in tables:
        if t.shape[0] % S == 0 and t.shape[0] >= S:
            out.append(tuple(b.to(d) for b, d in zip(t.chunk(S), devs)))
        else:
            out.append(t.to(devs[0]))
    return out


def _row_sharded(tables, ids):
    """The counterpart of the reference's ``shard_map`` branch: each slot
    gathers, for every row-sharded table, the rows it owns (a clamped id
    and a 0/1 mask for the rest), and the [n_sharded, B, d] partials are
    summed in slot order on the first slot's device: no atomics, one
    batch-sized sum.  Exactly one slot holds each row, and x + 0 = x, so
    the result and its gradient (``lookup.embedding``'s fixed-order
    backward) have the bits of the unsharded lookup."""
    big = [i for i, t in enumerate(tables) if isinstance(t, (tuple, list))]
    n_slots = len(tables[big[0]])
    if any(len(tables[i]) != n_slots for i in big):
        raise ValueError("row-sharded tables must share one slot count")
    home = tables[big[0]][0].device
    summed = None
    for s in range(n_slots):
        ids_s = ids.to(tables[big[0]][s].device).long()
        parts = []
        for i in big:
            blk = tables[i][s]
            rows = blk.shape[0]
            idx = ids_s[:, i] - s * rows
            ok = (idx >= 0) & (idx < rows)
            parts.append(lookup.embedding(idx.clamp(0, rows - 1), blk)
                         * ok[:, None].to(blk.dtype))
        part = torch.stack(parts).to(home)
        summed = part if summed is None else summed + part
    out, j = [], 0
    for i, t in enumerate(tables):
        if i in big:
            out.append(summed[j])
            j += 1
        else:
            out.append(lookup.embedding(ids[:, i].to(t.device), t).to(home))
    return out


def table_parallel_lookup(tables, ids):
    """Single-hot lookup of ids [B, n_sparse] in each table: of whole
    tables on one device (the JAX function's no-mesh branch), or, where
    ``shard_tables`` split some into row blocks, the row-sharded lookup
    (``_row_sharded``)."""
    if any(isinstance(t, (tuple, list)) for t in tables):
        return _row_sharded(tables, ids)
    return [lookup.embedding(ids[:, i], t) for i, t in enumerate(tables)]


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
