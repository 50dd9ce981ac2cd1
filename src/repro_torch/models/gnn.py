"""GNN family: message passing over an edge list, in PyTorch.

The counterpart of ``repro.models.gnn``.  Adjacency is an edge list (src
[E], dst [E]); a node's row is gathered per edge with ``F.embedding``
and messages are aggregated over the dst index: JAX's ``segment_sum``
becomes ``index_add`` (``segment_sum``, which keeps only the ids for its
backward) and its
``segment_max`` ``scatter_reduce(..., "amax", include_self=False)`` from
``-inf`` (so an empty segment reads ``-inf`` as in JAX).  No hand-written
kernel stands behind them, as no Pallas kernel stood behind the JAX ones.
On the GPU ``index_add`` adds with atomics (and ``F.embedding``'s backward
does not fix the order of a row's many duplicates either), so two
identical steps there may differ by rounding.  Covers the four archs:

  gin-tu   5L d=64 sum-agg, learnable eps (GIN, arXiv:1810.00826)
  gat-cora 2L d_hidden=8, 8 heads, edge-softmax attention (arXiv:1710.10903)
  schnet   3 interactions, d=64, 300 RBF, cutoff 10 (arXiv:1706.08566)
  egnn     4L d=64, E(n)-equivariant coordinate updates (arXiv:2102.09844)

All share one batch layout (padded edge lists with masks; a padded edge
still indexes a real node and its mask multiplies it out):
  node_feat [N, F] | atom_z [N] int, pos [N, 3]
  edge_src [E], edge_dst [E] int; node_mask [N]; edge_mask [E]
  labels [N] int + label_mask [N] (node_class) | graph_ids [N] + g_labels [G]
Parameters keep the JAX package's tree (``params_from_jax`` carries it
over), with ``x @ w + b`` layers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.train import optimizer as opt
from repro_torch.tree import (numpy_to_tensor, tensor_to_numpy, tree_map,
                              value_and_grad)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class GnnConfig:
    name: str
    arch: str                  # gin | gat | schnet | egnn
    n_layers: int
    d_hidden: int
    n_heads: int = 1
    n_rbf: int = 300
    cutoff: float = 10.0
    n_classes: int = 16
    task: str = "node_class"   # node_class | graph_class | graph_reg
    dtype: str = "float32"


# --------------------------------------------------------------------------
# gathers and segment ops
# --------------------------------------------------------------------------
def gather_rows(x, idx):
    """x[idx] along the first axis, through ``F.embedding`` (any trailing
    shape)."""
    rows = F.embedding(idx, x.reshape(x.shape[0], -1))
    return rows.reshape(idx.shape + x.shape[1:])


class _SegmentSum(torch.autograd.Function):
    """``index_add`` into zeros, whose backward gathers the gradient rows
    back.  It saves only the segment ids: autograd's own ``index_add``
    also keeps ``data`` for its backward, an [E, d] tensor a layer (15.8 GB
    a layer for gin-tu at ogb_products)."""

    @staticmethod
    def forward(ctx, data, seg_ids, num_segments):
        ctx.save_for_backward(seg_ids)
        return data.new_zeros((num_segments,) + data.shape[1:]).index_add_(
            0, seg_ids, data)

    @staticmethod
    def backward(ctx, grad):
        (seg_ids,) = ctx.saved_tensors
        return grad.index_select(0, seg_ids), None, None


def segment_sum(data, seg_ids, num_segments: int):
    return _SegmentSum.apply(data, seg_ids, num_segments)


def segment_max(data, seg_ids, num_segments: int):
    """Per-segment max of 1-D ``data``; ``-inf`` where a segment is empty."""
    return data.new_full((num_segments,), -math.inf).scatter_reduce(
        0, seg_ids, data, "amax", include_self=False)


def segment_softmax(scores, seg_ids, num_segments: int):
    """Softmax of 1-D ``scores`` within each segment.  A segment whose
    scores are all ``-inf`` (every edge masked) gives 0s, and so does an
    empty one; gradients stay finite through both."""
    seg_ids = seg_ids.long()
    smax = segment_max(scores, seg_ids, num_segments)
    smax = torch.where(torch.isfinite(smax), smax, torch.zeros_like(smax))
    ex = torch.exp(scores - gather_rows(smax, seg_ids))
    den = segment_sum(ex, seg_ids, num_segments)
    return ex / torch.clamp_min(gather_rows(den, seg_ids), 1e-12)


def _mlp_init(dims, dt, gen, dev):
    return [{"w": torch.randn((a, b), generator=gen, device=dev,
                              dtype=torch.float32).div_(math.sqrt(a)).to(dt),
             "b": torch.zeros((b,), dtype=dt, device=dev)}
            for a, b in zip(dims[:-1], dims[1:])]


def _mlp(params, x, act=torch.relu, final_act=False):
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1 or final_act:
            x = act(x)
    return x


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------
def init_gnn(cfg: GnnConfig, d_in: int, generator: torch.Generator,
             device: DeviceLike = None) -> Params:
    """Random parameters in the JAX package's tree, made on ``device``
    (``None``: the GPU) from ``generator``, which must live there; the
    reference's scales (other numbers: the generators differ)."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    d = cfg.d_hidden

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32) * scale).to(dt)

    def mlp(*dims):
        return _mlp_init(dims, dt, generator, dev)

    p: Params = {}
    if cfg.arch == "gin":
        p["embed"] = mlp(d_in, d)
        p["eps"] = torch.zeros((cfg.n_layers,), dtype=dt, device=dev)
        p["mlps"] = [mlp(d, d, d) for _ in range(cfg.n_layers)]
        p["out"] = mlp(d, cfg.n_classes)
    elif cfg.arch == "gat":
        dims_in = d_in
        p["layers"] = []
        for i in range(cfg.n_layers):
            last = i == cfg.n_layers - 1
            heads = 1 if last else cfg.n_heads
            dout = cfg.n_classes if last else d
            p["layers"].append({
                "w": randn(dims_in, heads, dout, scale=1 / math.sqrt(dims_in)),
                "a_l": randn(heads, dout, scale=0.1),
                "a_r": randn(heads, dout, scale=0.1)})
            dims_in = heads * dout
    elif cfg.arch == "schnet":
        p["embed"] = randn(100, d, scale=0.1)              # z -> d
        p["interactions"] = [{"filter": mlp(cfg.n_rbf, d, d),
                              "in_lin": mlp(d, d), "out": mlp(d, d, d)}
                             for _ in range(cfg.n_layers)]
        p["head"] = mlp(d, d // 2, 1)
    elif cfg.arch == "egnn":
        p["embed"] = mlp(d_in, d)
        p["layers"] = [{"phi_e": mlp(2 * d + 1, d, d), "phi_x": mlp(d, d, 1),
                        "phi_h": mlp(2 * d, d, d)}
                       for _ in range(cfg.n_layers)]
        p["head"] = mlp(d, d // 2, 1)
    else:
        raise ValueError(cfg.arch)
    return p


def params_from_jax(tree, device: DeviceLike = None) -> Params:
    """The JAX package's parameter tree (leaves any array numpy can read)
    as the port's, on ``device`` (``None``: the GPU)."""
    dev = resolve_device(device)
    return tree_map(lambda a: numpy_to_tensor(np.asarray(a), dev), tree)


def params_to_numpy(params: Params):
    """The port's parameters as numpy arrays, in the JAX package's tree."""
    return tree_map(tensor_to_numpy, params)


# --------------------------------------------------------------------------
# forward passes
# --------------------------------------------------------------------------
def _rbf_expand(dist, n_rbf: int, cutoff: float):
    centers = torch.linspace(0.0, cutoff, n_rbf, dtype=dist.dtype,
                             device=dist.device)
    gamma = 10.0 / cutoff
    return torch.exp(-gamma * (dist[:, None] - centers[None, :]) ** 2)


def gnn_forward(params: Params, batch, cfg: GnnConfig):
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    emask = batch["edge_mask"][:, None]
    n = batch["node_mask"].shape[0]
    n_graphs = batch["g_labels"].shape[0]

    if cfg.arch == "gin":
        h = _mlp(params["embed"], batch["node_feat"], final_act=True)
        for i in range(cfg.n_layers):
            agg = segment_sum(gather_rows(h, src) * emask, dst, n)
            h = _mlp(params["mlps"][i], (1.0 + params["eps"][i]) * h + agg)
            h = torch.relu(h)
        if cfg.task == "graph_class":
            pooled = segment_sum(h * batch["node_mask"][:, None],
                                 batch["graph_ids"].long(), n_graphs)
            return _mlp(params["out"], pooled)
        return _mlp(params["out"], h)

    if cfg.arch == "gat":
        h = batch["node_feat"]
        emask_pos = batch["edge_mask"][:, None] > 0
        for li, lp in enumerate(params["layers"]):
            z = torch.einsum("nf,fhd->nhd", h, lp["w"])         # [N, H, D]
            el = torch.einsum("nhd,hd->nh", z, lp["a_l"])
            er = torch.einsum("nhd,hd->nh", z, lp["a_r"])
            e = F.leaky_relu(gather_rows(el, src) + gather_rows(er, dst),
                             0.2)                                # [E, H]
            e = torch.where(emask_pos, e, torch.full_like(e, -math.inf))
            # edge-softmax per (dst, head): fold head into segment id
            H = e.shape[1]
            seg = dst[:, None] * H + torch.arange(H, device=dst.device)
            alpha = segment_softmax(e.reshape(-1), seg.reshape(-1), n * H)
            alpha = alpha.reshape(-1, H) * batch["edge_mask"][:, None]
            msg = alpha[..., None] * gather_rows(z, src)         # [E, H, D]
            out = segment_sum(msg, dst, n)
            last = li == len(params["layers"]) - 1
            h = out.mean(dim=1) if last else F.elu(out.reshape(n, -1))
        if cfg.task == "graph_class":
            gids = batch["graph_ids"].long()
            cnt = segment_sum(batch["node_mask"], gids, n_graphs)
            pooled = segment_sum(h * batch["node_mask"][:, None], gids,
                                 n_graphs)
            return pooled / torch.clamp_min(cnt, 1.0)[:, None]
        return h

    if cfg.arch == "schnet":
        pos = batch["pos"]
        h = F.embedding(batch["atom_z"].long(), params["embed"])
        dvec = gather_rows(pos, src) - gather_rows(pos, dst)
        dist = torch.sqrt(torch.clamp_min((dvec * dvec).sum(-1), 1e-12))
        rbf = _rbf_expand(dist, cfg.n_rbf, cfg.cutoff)
        # cosine cutoff envelope
        env = 0.5 * (torch.cos(math.pi * torch.clamp(dist / cfg.cutoff, 0, 1))
                     + 1.0)
        for ip in params["interactions"]:
            w = _mlp(ip["filter"], rbf) * (env * batch["edge_mask"])[:, None]
            xin = _mlp(ip["in_lin"], h)
            m = segment_sum(gather_rows(xin, src) * w, dst, n)
            h = h + _mlp(ip["out"], m)
        atom_e = _mlp(params["head"], h)[:, 0] * batch["node_mask"]
        return segment_sum(atom_e, batch["graph_ids"].long(), n_graphs)

    if cfg.arch == "egnn":
        pos = batch["pos"]
        h = _mlp(params["embed"], batch["node_feat"], final_act=True)
        for lp in params["layers"]:
            dvec = gather_rows(pos, src) - gather_rows(pos, dst)
            d2 = (dvec * dvec).sum(-1, keepdim=True)
            m = _mlp(lp["phi_e"], torch.cat([gather_rows(h, src),
                                             gather_rows(h, dst), d2], -1),
                     final_act=True) * emask
            coef = torch.tanh(_mlp(lp["phi_x"], m))             # bounded update
            pos = pos + segment_sum(dvec * coef * emask, dst, n) / 16.0
            magg = segment_sum(m, dst, n)
            h = h + _mlp(lp["phi_h"], torch.cat([h, magg], -1))
        atom_e = _mlp(params["head"], h)[:, 0] * batch["node_mask"]
        return segment_sum(atom_e, batch["graph_ids"].long(), n_graphs)

    raise ValueError(cfg.arch)


def _class_loss(logits, labels):
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(1, labels.long()[:, None])[:, 0]
    return lse - gold


def gnn_loss(params: Params, batch, cfg: GnnConfig):
    out = gnn_forward(params, batch, cfg)
    if cfg.task == "node_class":
        mask = batch["label_mask"]
        nll = _class_loss(out.float(), batch["labels"])
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    if cfg.task == "graph_class":
        return _class_loss(out.float(), batch["g_labels"]).mean()
    # graph regression (energy): MSE
    return ((out.float() - batch["g_labels"].float()) ** 2).mean()


def make_gnn_train_step(cfg: GnnConfig, ocfg: opt.AdamWConfig):
    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(gnn_loss, params, batch, cfg)
        new_params, new_state, metrics = opt.adamw_update(grads, opt_state,
                                                          params, ocfg)
        metrics["loss"] = loss
        return new_params, new_state, metrics
    return train_step


def make_gnn_serve_step(cfg: GnnConfig):
    @torch.no_grad()
    def serve_step(params, batch):
        return gnn_forward(params, batch, cfg)
    return serve_step
