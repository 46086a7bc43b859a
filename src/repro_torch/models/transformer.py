"""Decoder-only transformer assembly: the dense family.

The port of ``repro.models.transformer`` for dense decoders (internlm2,
qwen2.5, command-r, gemma3). The reference stacks the layers' parameters on
a leading axis and scans over it; here a :class:`Transformer` holds a
``ModuleList`` of per-layer ``ModuleDict``s and the forward pass is a Python
loop over them. Per-layer heterogeneity (gemma3's 5:1 local:global window
pattern and its per-layer RoPE theta) comes from ``cfg.layer_windows()`` and
``cfg.layer_thetas()`` as Python numbers.

The functions keep the reference's names and signatures, with the model
module in the place of the params pytree: ``transformer_forward(params, cfg,
tokens)`` reads ``params["embed"]``, ``params["layers"][i]["attn"]["wq"]``
and so on from a :class:`Transformer` exactly as the reference reads its
dict. A config with MoE or MLA layers (ROADMAP item 14b) or cross-attention
(item 14c) raises ``NotImplementedError``; nothing falls through to another
path.

Caches are dicts ``{"k", "v"}`` of ``(num_layers, B, max_len, KV, Dh)``
tensors in the model dtype. ``transformer_prefill`` returns the prompt's k/v
zero-padded to ``max_len`` as the reference does; ``transformer_decode_step``
writes the new token's k/v into that cache in place and returns it.

Without a mesh the reference's ``constrain`` calls are the identity, so they
are left out (ROADMAP item 14f).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from repro_torch.configs.base import ModelCfg
from repro_torch.convert import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L


def _dtype(cfg: ModelCfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def check_dense(cfg: ModelCfg) -> None:
    """Raise ``NotImplementedError`` for a config this module does not run
    yet, naming the ROADMAP item that ports it."""
    if cfg.moe is not None or cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE / MLA layers (models/moe.py, models/mla.py) "
            f"are not ported yet: ROADMAP item 14b")
    if cfg.cross_attn_every:
        raise NotImplementedError(
            f"{cfg.name}: cross-attention layers (cross_attn_apply, "
            f"cross_kv) are not ported yet: ROADMAP item 14c")


class Transformer(nn.Module):
    """A dense decoder's weights, laid out as the reference's params:
    ``embed`` (V, d), ``ln_f``, ``layers`` (a ``ModuleList`` with one
    ``ModuleDict`` of ``ln1``, ``attn``, ``ln2``, ``ffn`` per layer, each an
    ``nn.ParameterDict``) and, untied, ``lm_head`` (d, V). It is read as the
    reference's tree, ``params["layers"][i]["attn"]["wq"]``; the weights are
    frozen. ``forward(tokens)`` is :func:`transformer_forward`'s logits."""

    def __init__(self, cfg: ModelCfg, params: dict):
        super().__init__()
        check_dense(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(params["embed"])
        self.ln_f = nn.ParameterDict(params["ln_f"])
        self.layers = nn.ModuleList(
            nn.ModuleDict({name: nn.ParameterDict(p[name])
                           for name in ("ln1", "ln2", "attn", "ffn")})
            for p in params["layers"])
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(params["lm_head"])
        self.requires_grad_(False)

    def __getitem__(self, name: str):
        return getattr(self, name)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return transformer_forward(self, self.cfg, tokens)[0]


# ------------------------------------------------------------------ init ---

def _layer_init(gen, cfg: ModelCfg, device) -> dict:
    """One decoder layer's params."""
    dt = _dtype(cfg)
    return {
        "ln1": L.rmsnorm_init(cfg.d_model, device),
        "ln2": L.rmsnorm_init(cfg.d_model, device),
        "attn": A.attn_init(gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                            cfg.resolved_head_dim, dt, qkv_bias=cfg.qkv_bias,
                            device=device),
        "ffn": L.mlp_init(gen, cfg.d_model, cfg.d_ff, dt, gated=cfg.gated_mlp,
                          device=device),
    }


def transformer_init(gen, cfg: ModelCfg, device=None) -> Transformer:
    """The model's weights, drawn from the ``torch.Generator`` ``gen``, on
    ``device``, else on the generator's device, else by the port's device
    rule (CUDA, or raise). On the meta device ``gen`` may be None: nothing
    is drawn, and the weights give only their shapes and dtypes."""
    check_dense(cfg)
    device = L.init_device(gen, device)
    dt = _dtype(cfg)
    params: Dict[str, Any] = {
        "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dt, device),
        "ln_f": L.rmsnorm_init(cfg.d_model, device),
        "layers": [_layer_init(gen, cfg, device)
                   for _ in range(cfg.num_layers)],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                         dt, device=device)
    return Transformer(cfg, params)


# --------------------------------------------------------------- forward ---

def _ffn_apply(p_ffn, cfg: ModelCfg, h):
    return L.mlp_apply(p_ffn, h, act=cfg.act, gated=cfg.gated_mlp)


def _self_layer(p, cfg: ModelCfg, x, window: int, theta: float,
                q_offset: int = 0):
    """Returns (x_out, kv): kv is the prefill cache contribution."""
    h = L.rmsnorm(p["ln1"], x)
    attn_out, kv = A.self_attn_apply(
        p["attn"], h, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
        theta=theta, window=window, q_offset=q_offset)
    x = x + attn_out
    h = L.rmsnorm(p["ln2"], x)
    return x + _ffn_apply(p["ffn"], cfg, h), kv


def _head(params, cfg: ModelCfg, x):
    """f32 logits: the tied unembedding multiplies f32 by f32; the untied
    head multiplies in the model dtype, then casts to f32."""
    if cfg.tie_embeddings:
        return L.unembed(params["embed"], x)
    return (x @ params["lm_head"]).float()


def transformer_forward(params, cfg: ModelCfg, tokens: torch.Tensor,
                        collect_cache: bool = False,
                        return_hidden: bool = False):
    """tokens: (B, S) -> (logits (B, S, V) f32, aux, cache | None).
    ``aux`` is the reference's auxiliary loss, 0.0 here: dense layers have
    none (MoE's load-balancing loss comes with item 14b). ``return_hidden``: skip the unembedding and return the final normed
    hidden states instead. ``cache`` (collect_cache) is the pair of stacked
    (num_layers, B, S, KV, Dh) k and v."""
    check_dense(cfg)
    x = params["embed"][tokens.long()]
    windows = cfg.layer_windows()
    thetas = cfg.layer_thetas()
    ks, vs = [], []
    for i, layer in enumerate(params["layers"]):
        x, (k, v) = _self_layer(layer, cfg, x, windows[i], thetas[i])
        if collect_cache:
            ks.append(k)
            vs.append(v)
        del k, v
    cache = (torch.stack(ks), torch.stack(vs)) if collect_cache else None
    x = L.rmsnorm(params["ln_f"], x)
    if return_hidden:
        return x, 0.0, cache
    return _head(params, cfg, x), 0.0, cache


def head_matrix(params, cfg: ModelCfg) -> torch.Tensor:
    """(V, d) unembedding matrix (tied or separate)."""
    if cfg.tie_embeddings:
        return params["embed"]
    return params["lm_head"].T


# ----------------------------------------------------------------- cache ---

def init_kv_cache(cfg: ModelCfg, batch: int, max_len: int,
                  device=None) -> dict:
    """Zeroed k/v caches on ``device`` (CUDA unless asked otherwise)."""
    check_dense(cfg)
    device = resolve_device(device)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    dt = _dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def transformer_prefill(params, cfg: ModelCfg, tokens: torch.Tensor,
                        max_len: int):
    """Run the full prompt, return (last-position logits (B, V) f32, cache
    at max_len). Only the last position is unembedded."""
    B, S = tokens.shape
    x, _, (k, v) = transformer_forward(params, cfg, tokens,
                                       collect_cache=True, return_hidden=True)
    logits = _head(params, cfg, x[:, -1:])
    pad = max_len - S
    cache = {"k": torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)),
             "v": torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))}
    return logits[:, 0], cache


def transformer_decode_step(params, cfg: ModelCfg, token: torch.Tensor,
                            cache: dict, pos: int):
    """token: (B,) ints; pos: the position to write. Returns (logits (B, V)
    f32, cache), the cache written in place."""
    check_dense(cfg)
    x = params["embed"][token.long()][:, None, :]        # (B, 1, d)
    windows = cfg.layer_windows()
    thetas = cfg.layer_thetas()
    for i, pl in enumerate(params["layers"]):
        h = L.rmsnorm(pl["ln1"], x)
        attn_out, _, _ = A.self_attn_decode(
            pl["attn"], h, cache["k"][i], cache["v"][i], pos,
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.resolved_head_dim, theta=thetas[i],
            window=windows[i])
        x = x + attn_out
        h = L.rmsnorm(pl["ln2"], x)
        x = x + _ffn_apply(pl["ffn"], cfg, h)
    x = L.rmsnorm(params["ln_f"], x)
    return _head(params, cfg, x)[:, 0], cache
