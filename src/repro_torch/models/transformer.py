"""Decoder-only LM family (dense + MoE), layers stacked on a leading axis.

Covers the five LM architectures (granite-8b, phi4-mini-3.8b, qwen1.5-4b,
granite-moe-1b-a400m, arctic-480b).  The counterpart of
``repro.models.transformer``: the parameters keep the reference's names and
its stacked ``[L, ...]`` layout, so ``params_from_numpy`` carries a JAX
parameter tree over as it is.  The reference's ``lax.scan`` over layers
becomes a Python loop over one ``unbind(0)`` of each stacked leaf per
forward (indexing ``v[i]`` a layer would make every layer's backward
allocate a zero tensor the size of the whole stack), with
``torch.utils.checkpoint`` per layer when ``cfg.remat``.  Row lookups go
through ``F.embedding``, whose backward sums in a fixed order on the CPU
(an indexing backward there adds with atomics in parallel), and a MoE
layer combines its experts' rows by a gather and a sum in choice order
(``layers.moe_layer``), so a resumed run repeats an uninterrupted one bit
for bit on the CPU and on the GPU, for dense and MoE configs alike
(``chip_smoke.py``'s ``lm.launch``).  One limit on the GPU: there
``F.embedding``'s backward did not repeat for rows looked up thousands of
times in one batch (DLRM's small tables), which a token batch of that
size would also do.

Steps:
  train_step    causal-LM loss + AdamW update (train_* shapes)
  prefill_step  full-sequence forward that also emits the KV cache (prefill_*)
  serve_step    one-token decode against a KV cache (decode_* / long_*)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.train import optimizer as opt
from repro_torch.tree import (numpy_to_tensor, tensor_to_numpy, tree_map,
                              value_and_grad)


@dataclasses.dataclass(frozen=True)
class MoeSpec:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    dense_residual: bool = False   # arctic: dense FFN in parallel with MoE


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    moe: Optional[MoeSpec] = None
    rope_theta: float = 10000.0
    dtype: str = "bfloat16"
    remat: bool = True
    block_q: int = 256
    block_k: int = 1024
    loss_chunk: int = 512

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded to 128 (the reference's even 'model' sharding); the
        loss masks the pad columns (granite-moe's 49155 -> 49280)."""
        return -(-self.vocab // 128) * 128

    def param_count(self) -> int:
        D, F, V, H, Hkv, dh = (self.d_model, self.d_ff, self.vocab,
                               self.n_heads, self.n_kv_heads, self.dh)
        attn = D * (H + 2 * Hkv) * dh + H * dh * D
        if self.moe:
            ffn = self.moe.n_experts * 3 * D * F + D * self.moe.n_experts
            if self.moe.dense_residual:
                ffn += 3 * D * F
        else:
            ffn = 3 * D * F
        per_layer = attn + ffn + 2 * D
        return self.n_layers * per_layer + 2 * V * D + D

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k of E experts)."""
        if not self.moe:
            return self.param_count()
        D, F = self.d_model, self.d_ff
        dense = self.param_count() - self.n_layers * self.moe.n_experts * 3 * D * F
        act = self.n_layers * self.moe.top_k * 3 * D * F
        return dense + act

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


Params = Dict[str, Any]


# --------------------------------------------------------------------------
# init and carry-over
# --------------------------------------------------------------------------
def init_params(cfg: LMConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """Random parameters on ``device`` (``None``: the GPU), drawn from
    ``generator``, which must live on that device; the reference's
    distributions and layout (not its random stream)."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, params on {dev}")
    dt = cfg.torch_dtype
    D, F, V = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    H, Hkv, dh, Ln = cfg.n_heads, cfg.n_kv_heads, cfg.dh, cfg.n_layers

    def w(shape, scale=1.0):
        return L.dense_init(generator, shape, scale).to(dt)

    def const(shape, value):
        return torch.full(shape, value, dtype=dt, device=dev)

    layer = {
        "wq": w((Ln, D, H * dh)),
        "wk": w((Ln, D, Hkv * dh)),
        "wv": w((Ln, D, Hkv * dh)),
        "wo": w((Ln, H * dh, D)),
        "norm1": const((Ln, D), 1.0),
        "norm2": const((Ln, D), 1.0),
    }
    if cfg.qkv_bias:
        layer["bq"] = const((Ln, H * dh), 0.0)
        layer["bk"] = const((Ln, Hkv * dh), 0.0)
        layer["bv"] = const((Ln, Hkv * dh), 0.0)
    if cfg.moe:
        E = cfg.moe.n_experts
        layer["gate"] = w((Ln, D, E))
        layer["we_gate"] = w((Ln, E, D, F))
        layer["we_up"] = w((Ln, E, D, F))
        layer["we_down"] = w((Ln, E, F, D))
        if cfg.moe.dense_residual:
            layer["wr_gate"] = w((Ln, D, F))
            layer["wr_up"] = w((Ln, D, F))
            layer["wr_down"] = w((Ln, F, D))
    else:
        layer["w_gate"] = w((Ln, D, F))
        layer["w_up"] = w((Ln, D, F))
        layer["w_down"] = w((Ln, F, D))
    return {
        "embed": w((V, D), scale=np.sqrt(D)),  # the reference's scale
        "layers": layer,
        "final_norm": const((D,), 1.0),
        "lm_head": w((D, V)),
    }


def params_from_numpy(tree, device: DeviceLike = None) -> Params:
    """The JAX package's parameter tree (leaves as numpy arrays) as the
    port's, on ``device`` (``None``: the GPU)."""
    dev = resolve_device(device)
    return tree_map(lambda a: numpy_to_tensor(np.asarray(a), dev), tree)


def params_to_numpy(params: Params):
    """The port's parameters as numpy arrays, in the JAX package's tree."""
    return tree_map(tensor_to_numpy, params)


# --------------------------------------------------------------------------
# one transformer block (operating on a single layer's slice)
# --------------------------------------------------------------------------
def _attn(x, lp, cfg: LMConfig, positions, kv_cache=None, kv_mask=None,
          cache_pos=None):
    """Returns (attn_out, (k, v)).  Training/prefill: k/v are the fresh
    per-layer cache slices.  Decode: kv_cache is written in place at
    cache_pos *before* attending, so the token attends to itself."""
    B, S, D = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    q = x @ lp["wq"]
    k = x @ lp["wk"]
    v = x @ lp["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = q.reshape(B, S, H, dh)
    k = k.reshape(B, S, Hkv, dh)
    v = v.reshape(B, S, Hkv, dh)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    if kv_cache is None:
        o = L.blockwise_causal_attention(q, k, v, block_q=cfg.block_q,
                                         block_k=cfg.block_k)
        out_kv = (k, v)
    else:
        kc, vc = kv_cache   # [B, T, Hkv, dh]
        kc[:, cache_pos:cache_pos + S] = k
        vc[:, cache_pos:cache_pos + S] = v
        o = L.decode_attention(q, kc, vc, kv_mask)
        out_kv = (kc, vc)
    return o.reshape(B, S, H * dh) @ lp["wo"], out_kv


def _ffn(x, lp, cfg: LMConfig):
    B, S, D = x.shape
    if cfg.moe:
        m = cfg.moe
        y = L.moe_layer(x.reshape(B * S, D), lp["gate"], lp["we_gate"],
                        lp["we_up"], lp["we_down"],
                        L.MoeConfig(m.n_experts, m.top_k, m.capacity_factor))
        y = y.reshape(B, S, D)
        if m.dense_residual:
            y = y + L.swiglu(x, lp["wr_gate"], lp["wr_up"], lp["wr_down"])
        return y
    return L.swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"])


def _block(x, lp, cfg: LMConfig, positions, kv_cache=None, kv_mask=None,
           cache_pos=None):
    a, kv = _attn(L.rms_norm(x, lp["norm1"]), lp, cfg, positions, kv_cache,
                  kv_mask, cache_pos)
    x = x + a
    x = x + _ffn(L.rms_norm(x, lp["norm2"]), lp, cfg)
    return x, kv


def _layer_slices(stacked: Dict[str, torch.Tensor], n_layers: int):
    """One dict a layer, from one ``unbind(0)`` of each stacked leaf."""
    per_key = {k: v.unbind(0) for k, v in stacked.items()}
    return [{k: per_key[k][i] for k in per_key} for i in range(n_layers)]


# --------------------------------------------------------------------------
# forward passes
# --------------------------------------------------------------------------
def forward(params, tokens, cfg: LMConfig, collect_cache: bool = False):
    """tokens [B, S] -> hidden [B, S, D] (and the stacked KV cache, each
    [L, B, S, Hkv, dh], if asked)."""
    B, S = tokens.shape
    x = F.embedding(tokens, params["embed"])
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    remat = cfg.remat and torch.is_grad_enabled()
    ks, vs = [], []
    for lp in _layer_slices(params["layers"], cfg.n_layers):
        if remat:
            x, (k, v) = checkpoint(_block, x, lp, cfg, positions,
                                   use_reentrant=False)
        else:
            x, (k, v) = _block(x, lp, cfg, positions)
        if collect_cache:
            ks.append(k)
            vs.append(v)
    x = L.rms_norm(x, params["final_norm"])
    if collect_cache:
        return x, (torch.stack(ks), torch.stack(vs))
    return x


def _chunk_ce(hb, lb, lm_head, vocab: int):
    logits = (hb @ lm_head).float()                      # [B, chunk, Vpad]
    if lm_head.shape[1] != vocab:
        col_ok = torch.arange(lm_head.shape[1], device=logits.device) < vocab
        logits = torch.where(col_ok, logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lb[..., None].long())[..., 0]
    return (lse - gold).sum()


def chunked_ce_loss(h, lm_head, labels, chunk: int, vocab: int):
    """Sequence-chunked causal-LM cross entropy: one chunk's [B, chunk, V]
    logits at a time, recomputed in the backward; pad-vocab columns are
    masked out of the logsumexp."""
    B, S, D = h.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"loss chunk {chunk}")
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(S // chunk):
        hb = h[:, c * chunk:(c + 1) * chunk]
        lb = labels[:, c * chunk:(c + 1) * chunk]
        if torch.is_grad_enabled():
            part = checkpoint(_chunk_ce, hb, lb, lm_head, vocab,
                              use_reentrant=False)
        else:
            part = _chunk_ce(hb, lb, lm_head, vocab)
        total = total + part
    return total / (B * S)


def loss_fn(params, batch, cfg: LMConfig):
    h = forward(params, batch["tokens"], cfg)
    return chunked_ce_loss(h, params["lm_head"], batch["labels"],
                           cfg.loss_chunk, cfg.vocab)


def make_train_step(cfg: LMConfig, ocfg: opt.AdamWConfig):
    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(loss_fn, params, batch, cfg)
        new_params, new_state, metrics = opt.adamw_update(grads, opt_state,
                                                          params, ocfg)
        metrics["loss"] = loss
        return new_params, new_state, metrics
    return train_step


def make_prefill_step(cfg: LMConfig):
    @torch.no_grad()
    def prefill_step(params, tokens):
        h, (kc, vc) = forward(params, tokens, cfg, collect_cache=True)
        logits = (h[:, -1, :] @ params["lm_head"]).float()[:, :cfg.vocab]
        return logits, {"k": kc, "v": vc}   # each [L, B, S, Hkv, dh]
    return prefill_step


def make_serve_step(cfg: LMConfig):
    """One-token decode. cache k/v: [L, B, T, Hkv, dh], written in place at
    ``cur_len`` (the returned cache is the same tensors); cur_len an int."""

    @torch.no_grad()
    def serve_step(params, cache, token, cur_len):
        cur_len = int(cur_len)
        B = token.shape[0]
        x = F.embedding(token, params["embed"])            # [B, 1, D]
        positions = torch.full((B, 1), cur_len, dtype=torch.int32,
                               device=token.device)
        T = cache["k"].shape[2]
        kv_mask = (torch.arange(T, device=token.device) <= cur_len
                   )[None, :].expand(B, T)
        for i, lp in enumerate(_layer_slices(params["layers"],
                                             cfg.n_layers)):
            x, _ = _block(x, lp, cfg, positions,
                          kv_cache=(cache["k"][i], cache["v"][i]),
                          kv_mask=kv_mask, cache_pos=cur_len)
        x = L.rms_norm(x, params["final_norm"])
        logits = (x[:, 0, :] @ params["lm_head"]).float()[:, :cfg.vocab]
        return logits, cache

    return serve_step
