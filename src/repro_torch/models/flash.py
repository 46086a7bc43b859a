"""Flash attention with a hand-written backward: the training attention.

The port of ``repro.models.flash``. Autograd through a blockwise-softmax
loop would save every per-block probability matrix for the backward pass
and rebuild the O(S^2) memory the blockwise loop exists to avoid.
:class:`FlashTrain` is the standard flash backward (Dao et al.) as a
``torch.autograd.Function``: the forward saves only (q, k, v, the f32
output, L = m + log l); the backward recomputes each block's probabilities
and accumulates dq, dk and dv block by block, so the activation memory is
O(S * Dh), never O(S^2).

Plain PyTorch, as the reference is plain ``jnp`` under ``jax.custom_vjp``;
no fused library attention stands in for it. The reference scans every
(q block, KV block) pair; a pair that the causal mask or the window masks
entirely adds exact zeros there (``p`` is multiplied by the mask), so both
loops here skip such pairs, with the bounds of the inference path
(``attention.flash_attention``).

GQA layout as in ``attention.py``: q (B, Sq, H, Dh); k, v (B, Skv, KV, Dh);
query head h reads KV head h // rep. ``window`` 0 is unbounded, > 0 keeps
``q_pos - k_pos < window``; keys at or past ``skv_true`` (the wrapper's
padding) stay masked.

Under a mesh, q, k and v are DTensors. :func:`sharded_attention` runs the
plain function on each rank's own heads and batch rows (``local_map``): a
mesh dim that shards q's batch or heads shards all three alike; one that
shards q's sequence keeps each rank's query rows against the whole k and v
(their causal offset moved by the rank's first row); any other layout is
gathered first. Where a head shard would cut k's KV heads apart
(the smoke config's 2 KV heads on 4 ranks), k and v are expanded to one KV
head a query head first (``repeat_interleave``: the same pairs, and the
expansion's backward sums each KV head's gradient over its query heads).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _block_mask(q_pos, k_pos, skv: int, causal: bool, window: int):
    mask = k_pos[None, :] < skv
    if causal:
        mask = mask & (q_pos[:, None] >= k_pos[None, :])
    if window > 0:
        mask = mask & ((q_pos[:, None] - k_pos[None, :]) < window)
    return mask


def _kv_range(qi: int, nkv: int, causal: bool, window: int, q_offset: int,
              bq: int, bkv: int) -> range:
    """The KV blocks a query block can see (Python floor division, as
    jnp's): causality bounds them above, the window below. The blocks
    outside are masked entirely."""
    q_start = q_offset + qi * bq
    hi = min((q_start + bq + bkv - 1) // bkv, nkv) if causal else nkv
    lo = max((q_start - window + 1) // bkv, 0) if window > 0 else 0
    return range(lo, max(hi, lo))


def _flash_fwd_impl(q, k, v, window, causal, q_offset, bq, bkv, scale,
                    skv_true):
    """(out (B, Sq, H, Dv) f32, lse (nq, B, KV, rep, bq) f32)."""
    B, Sq, H, Dh = q.shape
    _, Skv, KV, _ = k.shape
    Dv = v.shape[-1]
    rep = H // KV
    nq, nkv = Sq // bq, Skv // bkv
    dev = q.device

    qf = (q.float() * scale).reshape(B, Sq, KV, rep, Dh)
    kf = k.float()
    vf = v.float()
    out = torch.empty((B, Sq, KV, rep, Dv), dtype=torch.float32, device=dev)
    lse = torch.empty((nq, B, KV, rep, bq), dtype=torch.float32, device=dev)
    ar_q = torch.arange(bq, device=dev)
    ar_kv = torch.arange(bkv, device=dev)
    for qi in range(nq):
        qblk = qf[:, qi * bq:(qi + 1) * bq]               # (B,bq,KV,rep,Dh)
        q_pos = q_offset + qi * bq + ar_q
        m = torch.full((B, KV, rep, bq), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, rep, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KV, rep, bq, Dv), dtype=torch.float32,
                          device=dev)
        for t in _kv_range(qi, nkv, causal, window, q_offset, bq, bkv):
            kblk = kf[:, t * bkv:(t + 1) * bkv]
            vblk = vf[:, t * bkv:(t + 1) * bkv]
            s = torch.einsum("bqkrd,bjkd->bkrqj", qblk, kblk)
            mask = _block_mask(q_pos, t * bkv + ar_kv, skv_true, causal,
                               window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None]) * mask.float()
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bkrqj,bjkd->bkrqd",
                                                       p, vblk)
            m = m_new
        lsafe = torch.clamp_min(l, 1e-30)
        out[:, qi * bq:(qi + 1) * bq] = (acc / lsafe[..., None]).permute(
            0, 3, 1, 2, 4)
        lse[qi] = m + torch.log(lsafe)
    return out.reshape(B, Sq, H, Dv), lse


def _flash_bwd(q, k, v, out, lse, dout, window, causal, q_offset, bq, bkv,
               scale, skv_true):
    """(dq, dk, dv) in q's, k's and v's dtypes."""
    B, Sq, H, Dh = q.shape
    _, Skv, KV, _ = k.shape
    Dv = v.shape[-1]
    rep = H // KV
    nq, nkv = Sq // bq, Skv // bkv
    dev = q.device

    qf = (q.float() * scale).reshape(B, Sq, KV, rep, Dh)
    kf = k.float()
    vf = v.float()
    do = dout.float().reshape(B, Sq, KV, rep, Dv)
    # delta[row] = sum_d dout * out, over the f32 output the forward saved
    delta = torch.einsum("bqkrd,bqkrd->bkrq", do,
                         out.reshape(B, Sq, KV, rep, Dv))
    dq = torch.zeros((B, Sq, KV, rep, Dh), dtype=torch.float32, device=dev)
    dk = torch.zeros((B, Skv, KV, Dh), dtype=torch.float32, device=dev)
    dv = torch.zeros((B, Skv, KV, Dv), dtype=torch.float32, device=dev)
    ar_q = torch.arange(bq, device=dev)
    ar_kv = torch.arange(bkv, device=dev)
    for qi in range(nq):
        rows = slice(qi * bq, (qi + 1) * bq)
        qblk, doblk = qf[:, rows], do[:, rows]
        lseblk, dblk = lse[qi], delta[..., rows]
        q_pos = q_offset + qi * bq + ar_q
        dq_acc = torch.zeros((B, bq, KV, rep, Dh), dtype=torch.float32,
                             device=dev)
        for t in _kv_range(qi, nkv, causal, window, q_offset, bq, bkv):
            cols = slice(t * bkv, (t + 1) * bkv)
            kblk, vblk = kf[:, cols], vf[:, cols]
            s = torch.einsum("bqkrd,bjkd->bkrqj", qblk, kblk)
            mask = _block_mask(q_pos, t * bkv + ar_kv, skv_true, causal,
                               window)
            s = torch.where(mask, s, NEG_INF)
            p = torch.exp(s - lseblk[..., None]) * mask.float()
            # GQA: dk and dv sum over the rep query heads of a group
            dv[:, cols] += torch.einsum("bkrqj,bqkrd->bjkd", p, doblk)
            dp = torch.einsum("bqkrd,bjkd->bkrqj", doblk, vblk)
            ds = p * (dp - dblk[..., None])               # (B,KV,rep,bq,bkv)
            dq_acc += torch.einsum("bkrqj,bjkd->bqkrd", ds, kblk)
            dk[:, cols] += torch.einsum("bkrqj,bqkrd->bjkd", ds, qblk)
        dq[:, rows] = dq_acc
    dq = (dq.reshape(B, Sq, H, Dh) * scale).to(q.dtype)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class FlashTrain(torch.autograd.Function):
    """``FlashTrain.apply(q, k, v, window, causal, q_offset, bq, bkv, scale,
    skv_true)``: q (B, Sq, H, Dh) with Sq a multiple of ``bq``, k and v
    (B, Skv, KV, Dh) with Skv a multiple of ``bkv``; returns the f32 output
    (B, Sq, H, Dv). The reference's ``flash_train`` with its
    ``_flash_fwd`` / ``_flash_bwd`` pair."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, causal: bool, q_offset: int,
                bq: int, bkv: int, scale: float, skv_true: int):
        out, lse = _flash_fwd_impl(q, k, v, int(window), causal, q_offset,
                                   bq, bkv, scale, skv_true)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (int(window), causal, q_offset, bq, bkv, scale, skv_true)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None, None


def sharded_attention(fn, q, k, v):
    """``fn(q, k, v, start)`` of plain tensors (B, S, heads, Dh) on
    DTensors: each rank runs it on its batch rows and query heads (see the
    module docstring) and, where q's sequence is sharded (the pure-FSDP
    rules), on its own query rows against the whole k and v; ``start`` is
    the first query row a rank holds (0 unless the queries are cut). The
    result is a DTensor laid out as q."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    place = [p if p in (Shard(0), Shard(1), Shard(2)) else Replicate()
             for p in q.placements]
    heads = math.prod(n for p, n in zip(place, mesh.shape) if p == Shard(2))
    H, KV = q.shape[2], k.shape[2]
    if H % heads:
        place = [Replicate() if p == Shard(2) else p for p in place]
    elif KV % heads:
        whole = [Replicate() if p == Shard(2) else p for p in place]
        k, v = (t.redistribute(mesh, whole).repeat_interleave(H // KV, dim=2)
                for t in (k, v))
    rows, start = 1, 0
    for i, p in enumerate(place):
        if p == Shard(1):
            rows *= mesh.size(i)
            start = start * mesh.size(i) + mesh.get_local_rank(i)
    start *= -(-q.shape[1] // rows)
    place = tuple(place)
    kv = tuple(Replicate() if p == Shard(1) else p for p in place)
    # each rank's dk, dv is its query rows' share: a sum over those shards
    dkv = tuple(Partial() if p == Shard(1) else p for p in place)
    return local_map(lambda a, b, c: fn(a, b, c, start),
                     out_placements=list(place), in_placements=(place, kv, kv),
                     in_grad_placements=(place, dkv, dkv), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)


def flash_attention_trainable(q, k, v, *, causal: bool = True, window=0,
                              q_offset: int = 0, block_q: int = 512,
                              block_kv: int = 1024,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Padding and dispatch; the training path's ``flash_attention``.
    Returns q's dtype."""
    from torch.distributed.tensor import DTensor
    if isinstance(q, DTensor):
        return sharded_attention(
            lambda a, b, c, start: flash_attention_trainable(
                a, b, c, causal=causal, window=window,
                q_offset=q_offset + start,
                block_q=block_q, block_kv=block_kv, scale=scale), q, k, v)
    B, Sq, H, Dh = q.shape
    _, Skv, KV, _ = k.shape
    scale = scale or (1.0 / math.sqrt(Dh))
    bq = min(block_q, Sq)
    bkv = min(block_kv, Skv)
    pq, pkv = (-Sq) % bq, (-Skv) % bkv
    if pq:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pq))
    if pkv:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pkv))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pkv))
    out = FlashTrain.apply(q, k, v, int(window), causal, q_offset, bq, bkv,
                           scale, Skv)
    return out[:, :Sq].to(q.dtype)
