"""Decoder-only transformer assembly: the dense, MoE, MLA and VLM families.

The port of ``repro.models.transformer``. The reference stacks the layers'
parameters on a leading axis and scans over it; here a :class:`Transformer`
holds a ``ModuleList`` of per-layer nodes and the forward pass is a Python
loop over them. Per-layer heterogeneity (gemma3's 5:1 local:global window
pattern and its per-layer RoPE theta) comes from ``cfg.layer_windows()`` and
``cfg.layer_thetas()`` as Python numbers.

A layer's attention is GQA or, with ``cfg.mla``, Multi-head Latent
Attention (``models/mla.py``); its FFN a dense MLP or, with ``cfg.moe``, the
routed experts of ``models/moe.py``, whose load-balancing losses sum into
the forward's ``aux``. VLM (llama-3.2-vision style): with
``cfg.cross_attn_every = per`` the layers form groups of ``per - 1`` self
layers (window 0, ``cfg.rope_theta``) and one cross-attention layer on the
projected image embeddings, with a gate that is zero at init.

The functions keep the reference's names and signatures, with the model
module in the place of the params pytree: ``transformer_forward(params, cfg,
tokens)`` reads ``params["embed"]``, ``params["layers"][i]["attn"]["wq"]``
and so on from a :class:`Transformer` exactly as the reference reads its
dict (``params["groups"]["self"][g][j]`` for a VLM's self layer j of group
g).

Caches, in the model dtype: ``{"k", "v"}`` of (num_layers, B, max_len, KV,
Dh); with MLA ``{"ckv", "krope"}`` of (num_layers, B, max_len, r) and (...,
dr); a VLM's ``{"k", "v"}`` of (groups, per - 1, B, max_len, KV, Dh) with
the cross layers' ``{"xk", "xv"}`` of (groups, B, num_image_tokens, KV,
Dh). ``transformer_prefill`` returns the prompt's cache zero-padded to
``max_len`` as the reference does; ``transformer_decode_step`` writes the
new token into that cache in place and returns it.

The residual stream, the embedded tokens and the logits carry the
reference's ``constrain`` annotations (``models/sharding.py``): the identity
on one device, a ``redistribute`` of a DTensor under a mesh's rules.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.convert import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models.sharding import constrain


class Transformer(L.ParamTree):
    """A decoder's weights, laid out as the reference's params: ``embed``
    (V, d), ``ln_f``, then ``layers`` (one node of ``ln1``, ``attn``,
    ``ln2``, ``ffn`` a layer) or, for a VLM, ``groups`` (``self``: groups
    of per - 1 layers, ``cross``: one cross layer a group) and
    ``img_proj`` (d, d); untied, ``lm_head`` (d, V). It is read as the
    reference's tree, ``params["layers"][i]["attn"]["wq"]``; the weights are
    frozen. ``forward(tokens)`` is :func:`transformer_forward`'s logits."""

    def __init__(self, cfg: ModelCfg, params: dict):
        super().__init__(params)
        self.cfg = cfg
        self.requires_grad_(False)

    def forward(self, tokens: torch.Tensor,
                image_embed: Optional[torch.Tensor] = None) -> torch.Tensor:
        return transformer_forward(self, self.cfg, tokens,
                                   image_embed=image_embed)[0]


# ------------------------------------------------------------------ init ---

def _layer_init(gen, cfg: ModelCfg, device) -> dict:
    """One decoder layer's params."""
    dt = L.model_dtype(cfg)
    if cfg.mla is not None:
        attn = MLA.mla_init(gen, cfg.d_model, cfg.num_heads, cfg.mla, dt,
                            device=device)
    else:
        attn = A.attn_init(gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                           cfg.resolved_head_dim, dt, qkv_bias=cfg.qkv_bias,
                           device=device)
    if cfg.moe is not None:
        ffn = MOE.moe_init(gen, cfg.d_model, cfg.moe, cfg.d_ff, dt,
                           device=device)
    else:
        ffn = L.mlp_init(gen, cfg.d_model, cfg.d_ff, dt, gated=cfg.gated_mlp,
                         device=device)
    return {"ln1": L.rmsnorm_init(cfg.d_model, device),
            "ln2": L.rmsnorm_init(cfg.d_model, device),
            "attn": attn, "ffn": ffn}


def _cross_layer_init(gen, cfg: ModelCfg, device) -> dict:
    dt = L.model_dtype(cfg)
    return {
        "ln1": L.rmsnorm_init(cfg.d_model, device),
        "ln2": L.rmsnorm_init(cfg.d_model, device),
        "attn": A.attn_init(gen, cfg.d_model, cfg.num_heads,
                            cfg.num_kv_heads, cfg.resolved_head_dim, dt,
                            device=device),
        "ffn": L.mlp_init(gen, cfg.d_model, cfg.d_ff, dt,
                          gated=cfg.gated_mlp, device=device),
        # zero-init cross-attn gate
        "gate": torch.zeros((), dtype=torch.float32, device=device),
    }


def transformer_init(gen, cfg: ModelCfg, device=None) -> Transformer:
    """The model's weights, drawn from the ``torch.Generator`` ``gen``, on
    ``device``, else on the generator's device, else by the port's device
    rule (CUDA, or raise). On the meta device ``gen`` may be None: nothing
    is drawn, and the weights give only their shapes and dtypes."""
    device = L.init_device(gen, device)
    dt = L.model_dtype(cfg)
    params: Dict[str, Any] = {
        "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dt, device),
        "ln_f": L.rmsnorm_init(cfg.d_model, device),
    }
    if cfg.cross_attn_every:
        per = cfg.cross_attn_every
        groups = cfg.num_layers // per
        params["groups"] = {
            "self": [[_layer_init(gen, cfg, device) for _ in range(per - 1)]
                     for _ in range(groups)],
            "cross": [_cross_layer_init(gen, cfg, device)
                      for _ in range(groups)],
        }
        params["img_proj"] = L.dense_init(gen, cfg.d_model, cfg.d_model, dt,
                                          device=device)
    else:
        params["layers"] = [_layer_init(gen, cfg, device)
                            for _ in range(cfg.num_layers)]
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                         dt, device=device)
    return Transformer(cfg, params)


# --------------------------------------------------------------- forward ---

def _ffn_apply(p_ffn, cfg: ModelCfg, h):
    """(y, aux): aux is the MoE load-balancing loss, 0.0 for a dense MLP."""
    if cfg.moe is not None:
        return MOE.moe_apply(p_ffn, h, cfg.moe)
    return L.mlp_apply(p_ffn, h, act=cfg.act, gated=cfg.gated_mlp), 0.0


def _self_layer(p, cfg: ModelCfg, x, window: int, theta: float,
                q_offset: int = 0, differentiable: bool = False):
    """Returns (x_out, aux, kv): kv is the prefill cache contribution,
    (k, v) or, with MLA, (c_kv, k_rope)."""
    h = L.rmsnorm(p["ln1"], x)
    if cfg.mla is not None:
        attn_out, kv = MLA.mla_prefill(p["attn"], h, num_heads=cfg.num_heads,
                                       cfg=cfg.mla, theta=theta,
                                       q_offset=q_offset,
                                       differentiable=differentiable)
    else:
        attn_out, kv = A.self_attn_apply(
            p["attn"], h, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
            theta=theta, window=window, q_offset=q_offset,
            differentiable=differentiable)
    x = L.residual(x, attn_out, seq=True)
    h = L.rmsnorm(p["ln2"], x)
    ffn_out, aux = _ffn_apply(p["ffn"], cfg, h)
    return L.residual(x, ffn_out, seq=True), aux, kv


def _cross_layer(p, cfg: ModelCfg, x, kv_k, kv_v,
                 differentiable: bool = False):
    h = L.rmsnorm(p["ln1"], x)
    attn_out = A.cross_attn_apply(p["attn"], h, kv_k, kv_v,
                                  num_heads=cfg.num_heads,
                                  num_kv_heads=cfg.num_kv_heads,
                                  head_dim=cfg.resolved_head_dim,
                                  differentiable=differentiable)
    x = L.residual(x, torch.tanh(p["gate"]).to(attn_out.dtype) * attn_out,
                   seq=True)
    h = L.rmsnorm(p["ln2"], x)
    ffn_out, _ = _ffn_apply(p["ffn"], cfg, h)
    return L.residual(x, ffn_out, seq=True)


def _stack_pairs(pairs):
    """[(a, b), ...] -> (stack of a, stack of b)."""
    return tuple(torch.stack(list(t)) for t in zip(*pairs))


def _head(params, cfg: ModelCfg, x):
    """f32 logits: the tied unembedding multiplies f32 by f32; the untied
    head multiplies in the model dtype, then casts to f32."""
    if cfg.tie_embeddings:
        return L.unembed(params["embed"], x)
    return (x @ params["lm_head"]).float()


def _image(image_embed):
    if image_embed is None:
        raise ValueError("a VLM config needs image_embed (B, "
                         "num_image_tokens, d_model)")
    return image_embed


def transformer_forward(params, cfg: ModelCfg, tokens: torch.Tensor,
                        image_embed: Optional[torch.Tensor] = None,
                        remat: bool = False,
                        collect_cache: bool = False,
                        return_hidden: bool = False):
    """tokens: (B, S) -> (logits (B, S, V) f32, aux, cache | None).
    ``aux`` is the sum of the MoE layers' load-balancing losses (an f32
    scalar; 0.0 without MoE layers). ``return_hidden``: skip the
    unembedding and return the final normed hidden states instead.
    ``cache`` (collect_cache) is the stacked prefill contributions: (k, v)
    of (num_layers, B, S, KV, Dh), with MLA (c_kv, k_rope); for a VLM
    ((k, v) of (groups, per - 1, B, S, KV, Dh), (xk, xv) of (groups, B,
    num_image_tokens, KV, Dh)). Without ``collect_cache`` the attention
    is the training path (``differentiable``), as in the reference.
    ``remat``: each layer (and a VLM's each group around its layers) is
    recomputed in the backward pass, ``jax.checkpoint``'s nesting; it
    changes memory, never values."""
    x = L.embed_lookup(params["embed"], tokens)
    x = constrain(x, "batch", "seq", None)
    diff = not collect_cache   # the training path is differentiable
    aux = 0.0
    kvs = []
    if cfg.cross_attn_every:
        img = _image(image_embed) @ params["img_proj"]

        def group(x, p_self, p_cross):
            gkv, gaux = [], 0.0
            for pl in p_self:
                x, a, kv = L.remat_call(remat, _self_layer, pl, cfg, x, 0,
                                        cfg.rope_theta, differentiable=diff)
                gaux = gaux + a
                if collect_cache:
                    gkv.append(kv)
            kk, vv = A.cross_kv(p_cross["attn"], img,
                                num_kv_heads=cfg.num_kv_heads,
                                head_dim=cfg.resolved_head_dim)
            x = _cross_layer(p_cross, cfg, x, kk, vv, differentiable=diff)
            return x, gaux, gkv, (kk, vv)

        xkvs = []
        for p_self, p_cross in zip(params["groups"]["self"],
                                   params["groups"]["cross"]):
            x, a, gkv, xkv = L.remat_call(remat, group, x, p_self, p_cross)
            aux = aux + a
            if collect_cache:
                kvs.append(_stack_pairs(gkv))
                xkvs.append(xkv)
        cache = (_stack_pairs(kvs), _stack_pairs(xkvs)) \
            if collect_cache else None
    else:
        windows = cfg.layer_windows()
        thetas = cfg.layer_thetas()
        for i, layer in enumerate(params["layers"]):
            x, a, kv = L.remat_call(remat, _self_layer, layer, cfg, x,
                                    windows[i], thetas[i],
                                    differentiable=diff)
            aux = aux + a
            if collect_cache:
                kvs.append(kv)
            del kv
        cache = _stack_pairs(kvs) if collect_cache else None
    x = L.rmsnorm(params["ln_f"], x)
    if return_hidden:
        return x, aux, cache
    return constrain(_head(params, cfg, x), "batch", None, "vocab"), aux, \
        cache


def head_matrix(params, cfg: ModelCfg) -> torch.Tensor:
    """(V, d) unembedding matrix (tied or separate)."""
    if cfg.tie_embeddings:
        return params["embed"]
    return params["lm_head"].T


# ----------------------------------------------------------------- cache ---

def init_kv_cache(cfg: ModelCfg, batch: int, max_len: int,
                  device=None) -> dict:
    """Zeroed caches on ``device`` (CUDA unless asked otherwise), in the
    layouts of the module docstring."""
    device = resolve_device(device)
    dt = L.model_dtype(cfg)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    if cfg.mla is not None:
        m = cfg.mla
        return {"ckv": zeros(cfg.num_layers, batch, max_len, m.kv_lora_rank),
                "krope": zeros(cfg.num_layers, batch, max_len,
                               m.rope_head_dim)}
    kv, kd = cfg.num_kv_heads, cfg.resolved_head_dim
    if cfg.cross_attn_every:
        per = cfg.cross_attn_every
        groups = cfg.num_layers // per
        return {"k": zeros(groups, per - 1, batch, max_len, kv, kd),
                "v": zeros(groups, per - 1, batch, max_len, kv, kd),
                "xk": zeros(groups, batch, cfg.num_image_tokens, kv, kd),
                "xv": zeros(groups, batch, cfg.num_image_tokens, kv, kd)}
    return {"k": zeros(cfg.num_layers, batch, max_len, kv, kd),
            "v": zeros(cfg.num_layers, batch, max_len, kv, kd)}


def transformer_prefill(params, cfg: ModelCfg, tokens: torch.Tensor,
                        max_len: int,
                        image_embed: Optional[torch.Tensor] = None):
    """Run the full prompt, return (last-position logits (B, V) f32, cache
    at max_len). Only the last position is unembedded."""
    B, S = tokens.shape
    x, _, kvs = transformer_forward(params, cfg, tokens,
                                    image_embed=image_embed,
                                    collect_cache=True, return_hidden=True)
    logits = _head(params, cfg, x[:, -1:])
    pad = max_len - S
    if cfg.cross_attn_every:
        (k, v), (xk, xv) = kvs
        cache = {"k": L.pad_seq(k, 3, pad), "v": L.pad_seq(v, 3, pad),
                 "xk": xk, "xv": xv}
    elif cfg.mla is not None:
        ckv, krope = kvs
        cache = {"ckv": L.pad_seq(ckv, 2, pad),
                 "krope": L.pad_seq(krope, 2, pad)}
    else:
        k, v = kvs
        cache = {"k": L.pad_seq(k, 2, pad), "v": L.pad_seq(v, 2, pad)}
    return logits[:, 0], cache


def _decode_layer(pl, cfg: ModelCfg, x, cache: dict, at, pos: int,
                  theta: float, window: int = 0):
    """One self layer of a decode step, its cache slices at index ``at``
    of the cache's leading axes, written in place."""
    h = L.rmsnorm(pl["ln1"], x)
    if cfg.mla is not None:
        attn_out, _, _ = MLA.mla_decode(
            pl["attn"], h, cache["ckv"][at], cache["krope"][at], pos,
            num_heads=cfg.num_heads, cfg=cfg.mla, theta=theta)
    else:
        attn_out, _, _ = A.self_attn_decode(
            pl["attn"], h, cache["k"][at], cache["v"][at], pos,
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.resolved_head_dim, theta=theta, window=window)
    x = x + attn_out
    h = L.rmsnorm(pl["ln2"], x)
    ffn_out, _ = _ffn_apply(pl["ffn"], cfg, h)
    return x + ffn_out


def transformer_decode_step(params, cfg: ModelCfg, token: torch.Tensor,
                            cache: dict, pos: int,
                            image_embed: Optional[torch.Tensor] = None):
    """token: (B,) ints; pos: the position to write. Returns (logits (B, V)
    f32, cache), the cache written in place. A VLM's cross layers read the
    image K/V cached by the prefill; ``image_embed`` is not read (as in the
    reference)."""
    x = L.embed_lookup(params["embed"], token)[:, None, :]   # (B, 1, d)
    if cfg.cross_attn_every:
        for g, (p_self, p_cross) in enumerate(zip(params["groups"]["self"],
                                                  params["groups"]["cross"])):
            for j, pl in enumerate(p_self):
                x = _decode_layer(pl, cfg, x, cache, (g, j), pos,
                                  cfg.rope_theta)
            x = _cross_layer(p_cross, cfg, x, cache["xk"][g],
                             cache["xv"][g])
    elif cfg.mla is not None:
        for i, pl in enumerate(params["layers"]):
            x = _decode_layer(pl, cfg, x, cache, i, pos, cfg.rope_theta)
    else:
        windows = cfg.layer_windows()
        thetas = cfg.layer_thetas()
        for i, pl in enumerate(params["layers"]):
            x = _decode_layer(pl, cfg, x, cache, i, pos, thetas[i],
                              windows[i])
    x = L.rmsnorm(params["ln_f"], x)
    return _head(params, cfg, x)[:, 0], cache
