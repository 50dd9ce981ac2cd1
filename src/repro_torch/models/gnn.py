"""GNN family: message passing over an edge list, in PyTorch.

The counterpart of ``repro.models.gnn``.  Adjacency is an edge list (src
[E], dst [E]); a node's row is gathered per edge and messages are
aggregated over the dst index through ``models/lookup.py``: JAX's row
takes become ``lookup.embedding`` and its ``segment_sum`` becomes
``lookup.segment_sum``, both of which sum rows by id in a fixed order
(the ``segment_sum`` kernel on the card), so two identical steps repeat
bit for bit there as on the CPU.
JAX's ``segment_max`` becomes ``scatter_reduce(..., "amax",
include_self=False)`` from ``-inf`` (so an empty segment reads ``-inf`` as
in JAX).  Covers the four archs:

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
from repro_torch.models import lookup
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
    ex = torch.exp(scores - lookup.embedding(seg_ids, smax))
    den = lookup.segment_sum(ex, seg_ids, num_segments)
    return ex / torch.clamp_min(lookup.embedding(seg_ids, den), 1e-12)


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
            agg = lookup.segment_sum(lookup.embedding(src, h) * emask, dst,
                                     n)
            h = _mlp(params["mlps"][i], (1.0 + params["eps"][i]) * h + agg)
            h = torch.relu(h)
        if cfg.task == "graph_class":
            pooled = lookup.segment_sum(h * batch["node_mask"][:, None],
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
            e = F.leaky_relu(lookup.embedding(src, el)
                             + lookup.embedding(dst, er), 0.2)   # [E, H]
            e = torch.where(emask_pos, e, torch.full_like(e, -math.inf))
            # edge-softmax per (dst, head): fold head into segment id
            H = e.shape[1]
            seg = dst[:, None] * H + torch.arange(H, device=dst.device)
            alpha = segment_softmax(e.reshape(-1), seg.reshape(-1), n * H)
            alpha = alpha.reshape(-1, H) * batch["edge_mask"][:, None]
            msg = alpha[..., None] * lookup.embedding(src, z)   # [E, H, D]
            out = lookup.segment_sum(msg, dst, n)
            last = li == len(params["layers"]) - 1
            h = out.mean(dim=1) if last else F.elu(out.reshape(n, -1))
        if cfg.task == "graph_class":
            gids = batch["graph_ids"].long()
            cnt = lookup.segment_sum(batch["node_mask"], gids, n_graphs)
            pooled = lookup.segment_sum(h * batch["node_mask"][:, None], gids,
                                 n_graphs)
            return pooled / torch.clamp_min(cnt, 1.0)[:, None]
        return h

    if cfg.arch == "schnet":
        pos = batch["pos"]
        h = lookup.embedding(batch["atom_z"].long(), params["embed"])
        dvec = lookup.embedding(src, pos) - lookup.embedding(dst, pos)
        dist = torch.sqrt(torch.clamp_min((dvec * dvec).sum(-1), 1e-12))
        rbf = _rbf_expand(dist, cfg.n_rbf, cfg.cutoff)
        # cosine cutoff envelope
        env = 0.5 * (torch.cos(math.pi * torch.clamp(dist / cfg.cutoff, 0, 1))
                     + 1.0)
        for ip in params["interactions"]:
            w = _mlp(ip["filter"], rbf) * (env * batch["edge_mask"])[:, None]
            xin = _mlp(ip["in_lin"], h)
            m = lookup.segment_sum(lookup.embedding(src, xin) * w, dst, n)
            h = h + _mlp(ip["out"], m)
        atom_e = _mlp(params["head"], h)[:, 0] * batch["node_mask"]
        return lookup.segment_sum(atom_e, batch["graph_ids"].long(), n_graphs)

    if cfg.arch == "egnn":
        pos = batch["pos"]
        h = _mlp(params["embed"], batch["node_feat"], final_act=True)
        for lp in params["layers"]:
            dvec = lookup.embedding(src, pos) - lookup.embedding(dst, pos)
            d2 = (dvec * dvec).sum(-1, keepdim=True)
            m = _mlp(lp["phi_e"], torch.cat([lookup.embedding(src, h),
                                             lookup.embedding(dst, h), d2], -1),
                     final_act=True) * emask
            coef = torch.tanh(_mlp(lp["phi_x"], m))             # bounded update
            pos = pos + lookup.segment_sum(dvec * coef * emask, dst, n) / 16.0
            magg = lookup.segment_sum(m, dst, n)
            h = h + _mlp(lp["phi_h"], torch.cat([h, magg], -1))
        atom_e = _mlp(params["head"], h)[:, 0] * batch["node_mask"]
        return lookup.segment_sum(atom_e, batch["graph_ids"].long(), n_graphs)

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
