"""Transformer building blocks: RMSNorm, RoPE, GQA attention (blockwise
train path + KV-cache decode path), SwiGLU, and the token-sorted MoE layer.

The counterpart of ``repro.models.layers``, in plain PyTorch: no Pallas
kernel stood behind any of these in the reference, so none stands behind
them here, and the matrix products are ``torch.matmul``/``einsum``.
Parameters are plain dicts of tensors; shapes follow [batch, seq, heads,
head_dim].
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------
def dense_init(generator: torch.Generator, shape,
               scale: float = 1.0) -> torch.Tensor:
    """N(0, scale^2 / fan_in) in fp32 from ``generator``, on its device
    (fan_in = shape[0], as the reference takes it)."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    x = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return x.mul_(scale / np.sqrt(fan_in))


# --------------------------------------------------------------------------
# activation-sharding hints
# --------------------------------------------------------------------------
BATCH_AXES = ("pod", "data")


def shard_hint(x, *spec):
    """The identity.  In the reference this pins an activation's layout on
    the device mesh (and is a no-op without one); the port has no mesh yet:
    the sharding rules come with ``launch/sharding.py`` in a later slice."""
    assert len(spec) == x.ndim, (spec, x.shape)
    return x


def rms_norm(x, gamma, eps: float = 1e-6):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * gamma


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float = 10000.0):
    """x [B, S, H, dh], positions [B, S] -> rotated x."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)                 # [dh/2]
    ang = positions[..., None].float() * freqs                     # [B, S, dh/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------
def _kv_blocks(iq: int, block_q: int, block_k: int) -> range:
    """The kv blocks that hold a causal pair for q block ``iq``.  A tile with
    none leaves the reference's online-softmax carry exactly as it was
    (p = 0, corr = 1: kv block 0 is never fully masked) and adds exact
    zeros in its backward, so the loops skip it."""
    return range((iq * block_q + block_q - 1) // block_k + 1)


def _causal_tile(s, iq, ik, block_q, block_k, fill):
    """``s`` [.., bq, bk] with the non-causal pairs set to ``fill``; only a
    tile that straddles the diagonal has any."""
    if ik * block_k + block_k - 1 <= iq * block_q:
        return s
    qpos = iq * block_q + torch.arange(block_q, device=s.device)
    kpos = ik * block_k + torch.arange(block_k, device=s.device)
    return s.masked_fill(qpos[:, None] < kpos[None, :], fill)


def _fa_fwd_core(q, k, v, block_q: int, block_k: int):
    """Causal flash forward. q/k/v [B, S, H, dh] (kv pre-repeated to H).
    Returns (o [B,S,H,dh], lse [B,S,H] fp32).  Double loop over (q x kv)
    blocks with an online-softmax carry; the largest temporary is one
    [B, H, bq, bk] tile."""
    B, S, H, dh = q.shape
    scale = 1.0 / np.sqrt(dh)
    q32 = q.float().transpose(1, 2) * scale                  # [B, H, S, dh]
    k32 = k.float().transpose(1, 2)
    v32 = v.float().transpose(1, 2)
    o = torch.empty(B, H, S, dh, device=q.device)
    lse = torch.empty(B, H, S, device=q.device)
    for iq in range(S // block_q):
        qs = slice(iq * block_q, (iq + 1) * block_q)
        m = torch.full((B, H, block_q), -math.inf, device=q.device)
        l = torch.zeros(B, H, block_q, device=q.device)
        acc = torch.zeros(B, H, block_q, dh, device=q.device)
        for ik in _kv_blocks(iq, block_q, block_k):
            ks = slice(ik * block_k, (ik + 1) * block_k)
            s = _causal_tile(q32[:, :, qs] @ k32[:, :, ks].transpose(-1, -2),
                             iq, ik, block_q, block_k, -math.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None])
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + p @ v32[:, :, ks]
            m = m_new
        o[:, :, qs] = acc / torch.clamp(l, min=1e-30)[..., None]
        lse[:, :, qs] = torch.where(
            l > 0, torch.log(torch.clamp(l, min=1e-30))
            + torch.where(torch.isfinite(m), m, 0.0), -math.inf)
    return o.transpose(1, 2).to(q.dtype), lse.transpose(1, 2)


def _fa_bwd_core(q, k, v, o, lse, do, block_q: int, block_k: int):
    """Flash backward: recompute p per (q,kv) tile from lse; never stores the
    probability stack."""
    B, S, H, dh = q.shape
    scale = 1.0 / np.sqrt(dh)
    delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2)  # [B,H,S]
    q32 = q.float().transpose(1, 2) * scale
    k32 = k.float().transpose(1, 2)
    v32 = v.float().transpose(1, 2)
    do32 = do.float().transpose(1, 2)
    lse_t = lse.transpose(1, 2)
    lse_safe = torch.where(torch.isfinite(lse_t), lse_t, 0.0)
    dq = torch.zeros(B, H, S, dh, device=q.device)
    dk = torch.zeros(B, H, S, dh, device=q.device)
    dv = torch.zeros(B, H, S, dh, device=q.device)
    nq = S // block_q
    for ik in range(S // block_k):
        ks = slice(ik * block_k, (ik + 1) * block_k)
        for iq in range(nq):
            if ik not in _kv_blocks(iq, block_q, block_k):
                continue
            qs = slice(iq * block_q, (iq + 1) * block_q)
            s = q32[:, :, qs] @ k32[:, :, ks].transpose(-1, -2)
            p = _causal_tile(torch.exp(s - lse_safe[:, :, qs, None]),
                             iq, ik, block_q, block_k, 0.0)
            dv[:, :, ks] += p.transpose(-1, -2) @ do32[:, :, qs]
            dp = do32[:, :, qs] @ v32[:, :, ks].transpose(-1, -2)
            ds = p * (dp - delta[:, :, qs, None])
            dq[:, :, qs] += (ds @ k32[:, :, ks]) * scale
            # ds @ q uses the scaled q: dk already carries 1/sqrt(dh) once
            dk[:, :, ks] += ds.transpose(-1, -2) @ q32[:, :, qs]
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    """The reference's custom VJP: the forward saves only (q, k, v, o, lse)
    and the backward recomputes each probability tile from lse."""

    @staticmethod
    def forward(ctx, q, k, v, block_q: int, block_k: int):
        o, lse = _fa_fwd_core(q, k, v, block_q, block_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.blocks = (block_q, block_k)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _fa_bwd_core(q, k, v, o, lse, do, *ctx.blocks)
        return dq, dk, dv, None, None


def blockwise_causal_attention(q, k, v, *, block_q: int = 256,
                               block_k: int = 1024) -> torch.Tensor:
    """Causal GQA flash attention (custom backward, DESIGN.md §6).

    q [B, S, H, dh]; k/v [B, S, Hkv, dh].  KV heads are repeated to H; the
    backward saves only (q, k, v, o, lse) and recomputes probability tiles,
    so the [nq*nk, ...] tile stack never materializes.
    """
    B, S, H, dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    block_q = min(block_q, S)
    block_k = min(block_k, S)
    s_orig = S
    pad = (-S) % math.lcm(block_q, block_k)
    if pad:
        # pad keys land at positions > any real query => causally masked out
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    out = _FlashAttention.apply(q, k, v, block_q, block_k)
    return out[:, :s_orig]


def decode_attention(q, k_cache, v_cache, kv_len_mask) -> torch.Tensor:
    """Single-token decode: q [B, 1, H, dh], caches [B, T, Hkv, dh].

    kv_len_mask [B, T] marks valid cache slots.
    """
    B, _, H, dh = q.shape
    Hkv = k_cache.shape[2]
    G = H // Hkv
    scale = 1.0 / np.sqrt(dh)
    qg = q.reshape(B, 1, Hkv, G, dh) * scale
    scores = torch.einsum("bshgd,bthd->bhgst", qg, k_cache).float()
    scores = torch.where(kv_len_mask[:, None, None, None, :], scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhgst,bthd->bshgd", p.to(v_cache.dtype), v_cache)
    return o.reshape(B, 1, H, dh)


# --------------------------------------------------------------------------
# FFN / SwiGLU
# --------------------------------------------------------------------------
def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


# --------------------------------------------------------------------------
# MoE: token-sorted dispatch with static capacity (DESIGN.md §6)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MoeConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


def moe_dispatch_indices(top_idx, n_experts: int, capacity: int):
    """top_idx [T, k] expert choices -> (dest [T, k], keep [T, k], src [E*C]).

    dest = e*C + position-within-expert; src is the inverse map (gather list
    for building the per-expert token buffers), pad slots point at T (callers
    append a zero row).  Integer arithmetic only: equal on every device.
    """
    T, k = top_idx.shape
    flat_e = top_idx.reshape(-1).long()                               # [T*k]
    onehot = F.one_hot(flat_e, n_experts)                             # [T*k, E]
    pos = torch.cumsum(onehot, dim=0) - onehot                        # rank within expert
    pos = (pos * onehot).sum(dim=-1)                                  # [T*k]
    keep = pos < capacity
    dest = torch.where(keep, flat_e * capacity + pos, n_experts * capacity)
    src = torch.full((n_experts * capacity + 1,), T, dtype=torch.long,
                     device=top_idx.device)
    token_of = torch.arange(T * k, device=top_idx.device) // k
    src[dest] = torch.where(keep, token_of, T)
    return dest.reshape(T, k), keep.reshape(T, k), src[:-1]


def moe_layer(x, gate_w, w_gate, w_up, w_down, cfg: MoeConfig):
    """x [T, D]; expert weights [E, D, F] / [E, F, D]. Returns [T, D].

    Token-sorted static-capacity dispatch: gather tokens into [E, C, D]
    buffers, batched per-expert SwiGLU einsum, weighted combine.  The
    combine gathers each token's k weighted slot rows through ``dest``
    (a dropped choice reads the zero pad row) and adds them in choice
    order, so its sum, and the gather's backward (each slot belongs to at
    most one (token, choice)), run in a fixed order on every device; a
    scatter-add into token space would add with atomics on the GPU.
    """
    T, Dm = x.shape
    E, k = cfg.n_experts, cfg.top_k
    cap = max(8, int(cfg.capacity_factor * k * T / E))
    logits = (x @ gate_w).float()                                     # [T, E]
    top_val, top_idx = torch.topk(logits, k, dim=-1)
    probs = torch.softmax(top_val, dim=-1).to(x.dtype)                # [T, k]

    dest, keep, src = moe_dispatch_indices(top_idx, E, cap)
    x_pad = torch.cat([x, x.new_zeros(1, Dm)], dim=0)
    xe = F.embedding(src.reshape(E, cap), x_pad)                      # [E, cap, D]
    h = F.silu(torch.einsum("ecd,edf->ecf", xe, w_gate)) \
        * torch.einsum("ecd,edf->ecf", xe, w_up)
    ye = torch.einsum("ecf,efd->ecd", h, w_down)                      # [E, cap, D]
    slot = torch.where(keep.reshape(-1), dest.reshape(-1), E * cap)
    wslot = ye.new_zeros(E * cap + 1).index_put(
        (slot,), (probs * keep).reshape(-1).to(ye.dtype))             # [E*cap]
    upd = ye.reshape(E * cap, Dm) * wslot[:-1, None]
    rows = F.embedding(dest, torch.cat([upd, upd.new_zeros(1, Dm)]))  # [T, k, D]
    y = rows[:, 0]
    for j in range(1, k):
        y = y + rows[:, j]
    return y.to(x.dtype)
