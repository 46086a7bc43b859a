"""GQA attention: blockwise (flash-style) prefill path + decode path.

The port of ``repro.models.attention``: self attention, and the
cross attention of the VLM groups and the enc-dec decoder
(``cross_attn_apply`` against K/V projected once by ``cross_kv``). Plain
PyTorch, as the reference is plain ``jnp``: an outer loop over query blocks
and an inner loop over KV blocks whose bounds come from causality and the
sliding window, so local-attention layers (gemma3) and causal masking skip
entire KV blocks. The online softmax carries (m, l, acc) in f32 with the
reference's ``NEG_INF`` masks, so the two packages compute the same thing;
no fused library attention stands in for it.

Layouts: activations (B, S, H, Dh); KV caches (B, S_max, KV, Dh).

GQA grouping: query head h reads KV head h // rep (rep = H // KV). A
``view(..., KV, rep, Dh)`` of the heads gives exactly that grouping (as the
reference's reshape does); ``k.repeat(1, 1, rep, 1)`` would pair h with
h % KV instead, which only KV = 1 cannot tell apart.

``window`` is a per-layer Python int: 0 means global causal attention, w > 0
attends to keys with ``q_pos - k_pos < w``.

``constrain`` puts q and k on the reference's (batch, -, model, -) layout
under a mesh's rules and is the identity otherwise.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models import flash
from repro_torch.models import layers as L
from repro_torch.models.sharding import constrain, dot, seq_of, unflatten

NEG_INF = -1e30


def attn_init(gen, d_model: int, num_heads: int, num_kv_heads: int,
              head_dim: int, dtype, qkv_bias: bool = False,
              device=None) -> dict:
    device = L.init_device(gen, device)
    p = {
        "wq": L.dense_init(gen, d_model, num_heads * head_dim, dtype,
                           device=device),
        "wk": L.dense_init(gen, d_model, num_kv_heads * head_dim, dtype,
                           device=device),
        "wv": L.dense_init(gen, d_model, num_kv_heads * head_dim, dtype,
                           device=device),
        "wo": L.dense_init(gen, num_heads * head_dim, d_model, dtype,
                           device=device),
    }
    if qkv_bias:
        for name, width in (("bq", num_heads), ("bk", num_kv_heads),
                            ("bv", num_kv_heads)):
            p[name] = torch.zeros((width * head_dim,), dtype=dtype,
                                  device=device)
    return p


def _project_qkv(params, x, num_heads, num_kv_heads, head_dim):
    B, S, _ = x.shape
    q = dot(x, params["wq"])
    k = dot(x, params["wk"])
    v = dot(x, params["wv"])
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return (split_heads(q, num_heads, head_dim),
            split_heads(k, num_kv_heads, head_dim),
            split_heads(v, num_kv_heads, head_dim))


def split_heads(t: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """(B, S, heads * head_dim) -> (B, S, heads, head_dim)
    (:func:`~repro_torch.models.sharding.unflatten`)."""
    return unflatten(t, -1, (heads, head_dim))


def write_slot(cache: torch.Tensor, pos: int, val: torch.Tensor) -> None:
    """``cache[:, pos] = val`` in place ((B, S, ...) and (B, ...)). On a
    DTensor cache each rank writes its own shard, and only the rank whose
    sequence slice holds ``pos`` writes anything (the reference's
    ``dynamic_update_slice`` on a sequence-sharded cache)."""
    if not isinstance(cache, DTensor):
        cache[:, pos] = val.to(cache.dtype)
        return
    mesh, place = cache.device_mesh, cache.placements
    # val's dims are the cache's without the sequence dim 1
    want = [Replicate() if not p.is_shard() or p.dim == 1 else
            Shard(p.dim - 1 if p.dim > 1 else 0) for p in place]
    local_val = val.redistribute(mesh, want).to_local()
    local = cache.to_local()
    coord = mesh.get_coordinate()
    start, n = 0, local.shape[1]
    for i, p in enumerate(place):           # nested in mesh order
        if p.is_shard(1):
            start = start * mesh.shape[i] + coord[i]
    lo = start * n
    if lo <= pos < lo + n:
        local[:, pos - lo] = local_val.to(local.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int = 0,
                    q_offset: int = 0,
                    block_q: int = 512,
                    block_kv: int = 1024,
                    scale: Optional[float] = None,
                    differentiable: bool = False) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k, v: (B, Skv, KV, Dh) -> (B, Sq, H, Dh).

    ``window`` 0 = unbounded; > 0 = attend only to the last ``window`` keys
    (inclusive of self). ``differentiable``: the training path,
    :func:`repro_torch.models.flash.flash_attention_trainable` (its
    backward recomputes the blocks); otherwise the inference loop below."""
    if differentiable:
        return flash.flash_attention_trainable(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            block_q=block_q, block_kv=block_kv, scale=scale)
    if isinstance(q, DTensor):
        return flash.sharded_attention(
            lambda a, b, c, start: flash_attention(
                a, b, c, causal=causal, window=window,
                q_offset=q_offset + start,
                block_q=block_q, block_kv=block_kv, scale=scale), q, k, v)
    B, Sq, H, Dh = q.shape
    _, Skv, KV, _ = k.shape
    Dv = v.shape[-1]
    rep = H // KV
    scale = scale or (1.0 / math.sqrt(Dh))
    window = int(window)

    # pad Sq and Skv to whole blocks; padded keys are masked below
    bq = min(block_q, Sq)
    bkv = min(block_kv, Skv)
    pq = (-Sq) % bq
    pkv = (-Skv) % bkv
    nq = (Sq + pq) // bq
    nkv = (Skv + pkv) // bkv

    # (B, Sq_pad, KV, rep, Dh): head h = (h // rep, h % rep), the reference's
    # reshape(B, nq, bq, KV, rep, Dh)
    qf = q.float() * scale
    qf = torch.nn.functional.pad(qf, (0, 0, 0, 0, 0, pq))
    qf = qf.reshape(B, nq * bq, KV, rep, Dh)
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pkv))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pkv))
    dev = q.device
    out = torch.empty((B, nq * bq, KV, rep, Dv), dtype=torch.float32,
                      device=dev)
    arange_q = torch.arange(bq, device=dev)
    arange_kv = torch.arange(bkv, device=dev)

    for qi in range(nq):
        qblk = qf[:, qi * bq:(qi + 1) * bq]              # (B, bq, KV, rep, Dh)
        q_start = q_offset + qi * bq
        q_pos = q_start + arange_q
        # the KV blocks this query block can see (Python floor division,
        # as jnp's): causality bounds them above, the window below
        kv_hi = min((q_start + bq + bkv - 1) // bkv, nkv) if causal else nkv
        kv_lo = max((q_start - window + 1) // bkv, 0) if window > 0 else 0

        m = torch.full((B, KV, rep, bq), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, rep, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KV, rep, bq, Dv), dtype=torch.float32,
                          device=dev)
        for t in range(kv_lo, kv_hi):
            kblk = kf[:, t * bkv:(t + 1) * bkv]
            vblk = vf[:, t * bkv:(t + 1) * bkv]
            s = torch.einsum("bqkrd,bjkd->bkrqj", qblk, kblk)
            k_pos = t * bkv + arange_kv
            mask = k_pos[None, :] < Skv                   # padded keys
            if causal:
                mask = mask & (q_pos[:, None] >= k_pos[None, :])
            if window > 0:
                mask = mask & ((q_pos[:, None] - k_pos[None, :]) < window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # the explicit mask multiply: a fully masked block (m_new still
            # NEG_INF) must add 0, not exp(0)
            p = torch.exp(s - m_new[..., None]) * mask.float()
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bkrqj,bjkd->bkrqd",
                                                       p, vblk)
            m = m_new
        blk = acc / torch.clamp_min(l[..., None], 1e-30)  # (B, KV, rep, bq, Dv)
        out[:, qi * bq:(qi + 1) * bq] = blk.permute(0, 3, 1, 2, 4)
    out = out.reshape(B, nq * bq, H, Dv)
    return out[:, :Sq].to(q.dtype)


def _like_cache(q: torch.Tensor, cache: torch.Tensor) -> torch.Tensor:
    """q (B, H, Dh) placed as the cache (B, S_max, KV, Dh) is: the batch
    sharded where the cache's batch is, the heads where its KV heads are,
    replicated over the rest (the model axis of a sequence-sharded cache).
    GSPMD reshards q there; DTensor, handed q's heads sharded against the
    cache's sequence, cannot contract the two without reading a value."""
    if not (isinstance(q, DTensor) and isinstance(cache, DTensor)):
        return q
    want = tuple(Shard(0) if p.is_shard(0) else Shard(1) if p.is_shard(2)
                 else Replicate() for p in cache.placements)
    if tuple(q.placements) == want:
        return q
    return q.redistribute(q.device_mesh, want)


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos, *, window: int = 0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token attention. q: (B, H, Dh); caches: (B, S_max, KV, Dh);
    pos: an int or (B,) current position (valid tokens = pos + 1)."""
    B, H, Dh = q.shape
    _, Smax, KV, _ = cache_k.shape
    rep = H // KV
    scale = scale or (1.0 / math.sqrt(Dh))
    dev = q.device
    # an int fills on the card (no host-to-device copy, which would wait
    # for the card's queue at every layer)
    pos = torch.full((B,), pos, dtype=torch.int64, device=dev) \
        if isinstance(pos, int) else torch.as_tensor(pos, device=dev).expand(B)
    # head h reads KV head h // rep (see the module docstring)
    qf = unflatten(_like_cache(q, cache_k).float(), 1, (KV, rep)) * scale
    s = torch.einsum("bkrd,bjkd->bkrj", qf, cache_k.float())
    idx = torch.arange(Smax, device=dev)
    mask = idx[None, :] <= pos[:, None]                  # (B, Smax)
    if window > 0:
        mask = mask & ((pos[:, None] - idx[None, :]) < window)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkrj,bjkd->bkrd", p, cache_v.float())
    return out.reshape(B, H, Dh).to(q.dtype)


# ------------------------------------------------------------- module API --

def self_attn_apply(params, x, *, num_heads, num_kv_heads, head_dim,
                    theta, window: int = 0, q_offset: int = 0,
                    positions: Optional[torch.Tensor] = None,
                    differentiable: bool = False):
    """Full-sequence causal self attention (prefill). Returns (out, (k, v)),
    k and v after RoPE in the model dtype (the prefill cache)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, x, num_heads, num_kv_heads, head_dim)
    if positions is None:
        positions = q_offset + torch.arange(S, device=x.device)[None, :]
    q = L.apply_rope(q, positions, theta)
    k = L.apply_rope(k, positions, theta)
    # the reference's (batch, None, model, None) for q and k; the queries
    # keep a sequence shard the stream brings (pure FSDP), each rank
    # attending with its own rows to the whole k and v
    q = constrain(q, "batch", seq_of(q), "model", None)
    k = constrain(k, "batch", None, "model", None)
    out = flash_attention(q, k, v, causal=True, window=window,
                          q_offset=q_offset, differentiable=differentiable)
    out = out.reshape(B, S, num_heads * head_dim)
    return dot(out, params["wo"]), (k, v)


def self_attn_decode(params, x, cache_k, cache_v, pos: int, *, num_heads,
                     num_kv_heads, head_dim, theta, window: int = 0):
    """x: (B, 1, d). Returns (out (B, 1, d), cache_k, cache_v).

    The reference returns new caches from a ``dynamic_update_slice`` at
    ``pos``; here the token's k and v are written into the given caches in
    place (the same values at the same slot) and those caches returned."""
    B = x.shape[0]
    pos = int(pos)
    q, k, v = _project_qkv(params, x, num_heads, num_kv_heads, head_dim)
    posv = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q = L.apply_rope(q, posv, theta)
    k = L.apply_rope(k, posv, theta)
    write_slot(cache_k, pos, k[:, 0])
    write_slot(cache_v, pos, v[:, 0])
    out = decode_attention(q[:, 0], cache_k, cache_v, pos, window=window)
    out = out.reshape(B, 1, num_heads * head_dim)
    return out @ params["wo"], cache_k, cache_v


def cross_attn_apply(params, x, kv_k, kv_v, *, num_heads, num_kv_heads,
                     head_dim, differentiable: bool = False
                     ) -> torch.Tensor:
    """Non-causal cross attention against precomputed K/V (B, S_kv, KV,
    Dh); ``bq`` is added where the params have it."""
    B, S, _ = x.shape
    q = dot(x, params["wq"])
    if "bq" in params:
        q = q + params["bq"]
    q = split_heads(q, num_heads, head_dim)
    out = flash_attention(q, kv_k, kv_v, causal=False, window=0,
                          differentiable=differentiable)
    out = out.reshape(B, S, num_heads * head_dim)
    return dot(out, params["wo"])


def cross_kv(params, src, *, num_kv_heads, head_dim):
    """Project encoder or image features (B, S, d) to the cross attention's
    K/V once: two (B, S, KV, Dh) tensors."""
    B, S, _ = src.shape
    k = src @ params["wk"]
    v = src @ params["wv"]
    if "bk" in params:
        k = k + params["bk"]
        v = v + params["bv"]
    return (split_heads(k, num_kv_heads, head_dim),
            split_heads(v, num_kv_heads, head_dim))
