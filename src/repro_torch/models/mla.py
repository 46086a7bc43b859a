"""Multi-head Latent Attention (DeepSeek-V2).

The port of ``repro.models.mla``. The prefill path expands the compressed
latent to full per-head K/V and runs the blockwise ``flash_attention``
(value head dim 128 != qk head dim 192). The decode path uses the absorbed
form in f32: the k up-projection is folded into the query and the v
up-projection into the output, so the per-token cache is the latent and
the shared RoPE key, (kv_lora_rank + rope_head_dim) values. The softmax
scale is ``1 / sqrt(nope_head_dim + rope_head_dim)`` on both paths.

Caches: ``ckv`` (B, S_max, r) and ``krope`` (B, S_max, dr) in the model
dtype; ``mla_decode`` writes position ``pos`` in place, as the port's
dense decode does, and returns them.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import MLACfg
from repro_torch.models import layers as L
from repro_torch.models.attention import flash_attention, write_slot
from repro_torch.models.sharding import constrain

NEG_INF = -1e30


def mla_init(gen, d_model: int, num_heads: int, cfg: MLACfg, dtype,
             device=None) -> dict:
    device = L.init_device(gen, device)
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    return {
        # queries: full-rank (v2-lite has no q compression)
        "wq": L.dense_init(gen, d_model, num_heads * (dn + dr), dtype,
                           device=device),
        # kv path: compress, plus the shared rope key
        "w_dkv": L.dense_init(gen, d_model, r, dtype, device=device),
        "w_krope": L.dense_init(gen, d_model, dr, dtype, device=device),
        "kv_norm": L.rmsnorm_init(r, device),
        "w_uk": L.dense_init(gen, r, num_heads * dn, dtype, device=device),
        "w_uv": L.dense_init(gen, r, num_heads * dv, dtype, device=device),
        "wo": L.dense_init(gen, num_heads * dv, d_model, dtype,
                           device=device),
    }


def _split_q(params, x, num_heads: int, cfg: MLACfg):
    B, S, _ = x.shape
    dn, dr = cfg.nope_head_dim, cfg.rope_head_dim
    q = (x @ params["wq"]).reshape(B, S, num_heads, dn + dr)
    return q[..., :dn], q[..., dn:]


def _latent(params, x):
    c_kv = L.rmsnorm(params["kv_norm"], x @ params["w_dkv"])
    k_rope = x @ params["w_krope"]                     # (B, S, dr) shared head
    return c_kv, k_rope


def mla_prefill(params, x, *, num_heads: int, cfg: MLACfg, theta: float,
                q_offset: int = 0, differentiable: bool = False):
    """Returns (out (B, S, d), (c_kv (B, S, r), k_rope (B, S, dr))): the
    compressed cache."""
    B, S, _ = x.shape
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    pos = q_offset + torch.arange(S, device=x.device)[None, :]

    q_nope, q_rope = _split_q(params, x, num_heads, cfg)
    q_rope = L.apply_rope(q_rope, pos, theta)
    c_kv, k_rope = _latent(params, x)
    k_rope = L.apply_rope(k_rope[:, :, None, :], pos, theta)   # (B,S,1,dr)

    k_nope = (c_kv @ params["w_uk"]).reshape(B, S, num_heads, dn)
    v = (c_kv @ params["w_uv"]).reshape(B, S, num_heads, dv)
    k = torch.cat([k_nope, k_rope.expand(B, S, num_heads, dr)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    q = constrain(q, "batch", None, "model", None)
    out = flash_attention(q, k, v, causal=True, q_offset=q_offset,
                          scale=1.0 / math.sqrt(dn + dr),
                          differentiable=differentiable)
    out = out.reshape(B, S, num_heads * dv) @ params["wo"]
    return out, (c_kv, k_rope[:, :, 0, :])


def mla_decode(params, x, cache_ckv, cache_krope, pos: int, *,
               num_heads: int, cfg: MLACfg, theta: float):
    """Absorbed decode. x: (B, 1, d); caches (B, S_max, r) and (B, S_max,
    dr), written at ``pos`` in place. Returns (out (B, 1, d), cache_ckv,
    cache_krope)."""
    B = x.shape[0]
    pos = int(pos)
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    posv = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)

    q_nope, q_rope = _split_q(params, x, num_heads, cfg)       # (B,1,H,*)
    q_rope = L.apply_rope(q_rope, posv, theta)
    c_kv, k_rope = _latent(params, x)               # (B,1,r), (B,1,dr)
    k_rope = L.apply_rope(k_rope[:, :, None, :], posv, theta)[:, :, 0, :]
    write_slot(cache_ckv, pos, c_kv[:, 0])
    write_slot(cache_krope, pos, k_rope[:, 0])

    # absorb W_uk into the query: q_c (B, H, r)
    w_uk = params["w_uk"].reshape(r, num_heads, dn)
    q_c = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(), w_uk.float())
    scale = 1.0 / math.sqrt(dn + dr)
    ckv = cache_ckv.float()
    s = (torch.einsum("bhr,bsr->bhs", q_c, ckv)
         + torch.einsum("bhd,bsd->bhs", q_rope[:, 0].float(),
                        cache_krope.float())) * scale
    Smax = cache_ckv.shape[1]
    mask = torch.arange(Smax, device=x.device) <= pos
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhs,bsr->bhr", p, ckv)
    # absorb W_uv into the output: per-head (r -> dv)
    w_uv = params["w_uv"].reshape(r, num_heads, dv)
    out = torch.einsum("bhr,rhv->bhv", ctx, w_uv.float())
    out = out.reshape(B, 1, num_heads * dv).to(x.dtype) @ params["wo"]
    return out, cache_ckv, cache_krope
