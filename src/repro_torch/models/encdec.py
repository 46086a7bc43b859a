"""Whisper-style encoder-decoder backbone.

The port of ``repro.models.encdec``. The conv audio frontend is a stub, as
in the reference: the caller feeds precomputed frame embeddings (B, S_enc,
d_model). The backbone is Whisper's: pre-LN transformer (LayerNorm), q/k/v
with biases, a non-causal encoder self attention, a decoder with causal self
attention and cross attention, non-gated tanh-GELU MLPs, sinusoidal encoder
positions and a learned decoder position table of 8192 rows.

The weights are an :class:`EncDec` module laid out as the reference's tree:
``embed`` (V, d), ``pos_dec`` (8192, d), ``enc`` and ``dec`` (a
``ModuleList`` of layer nodes each), ``ln_enc``, ``ln_f``. Caches, in the
model dtype: ``{"k", "v"}`` of (num_layers, B, max_len, KV, Dh) and the
cross K/V ``{"xk", "xv"}`` of (num_layers, B, num_audio_frames, KV, Dh);
``encdec_decode_step`` writes the new token's k/v in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelCfg
from repro_torch.convert import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.sharding import constrain, dot

POS_DEC_ROWS = 8192


class EncDec(L.ParamTree):
    """An encoder-decoder's weights (see the module docstring), frozen and
    read as the reference's tree (``params["dec"][i]["cross"]["wq"]``)."""

    def __init__(self, cfg: ModelCfg, params: dict):
        super().__init__(params)
        self.cfg = cfg
        self.requires_grad_(False)


def _sinusoid(length: int, d: int, device=None) -> torch.Tensor:
    pos = torch.arange(length, device=device)[:, None].float()
    dim = torch.arange(d // 2, device=device)[None, :].float()
    ang = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _attn_init(gen, cfg: ModelCfg, dt, device) -> dict:
    return A.attn_init(gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.resolved_head_dim, dt, qkv_bias=True,
                       device=device)


def _enc_layer_init(gen, cfg: ModelCfg, dt, device) -> dict:
    return {
        "ln1": L.layernorm_init(cfg.d_model, device),
        "attn": _attn_init(gen, cfg, dt, device),
        "ln2": L.layernorm_init(cfg.d_model, device),
        "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, dt, gated=False,
                          device=device),
    }


def _dec_layer_init(gen, cfg: ModelCfg, dt, device) -> dict:
    return {
        "ln1": L.layernorm_init(cfg.d_model, device),
        "self": _attn_init(gen, cfg, dt, device),
        "ln_x": L.layernorm_init(cfg.d_model, device),
        "cross": _attn_init(gen, cfg, dt, device),
        "ln2": L.layernorm_init(cfg.d_model, device),
        "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, dt, gated=False,
                          device=device),
    }


def encdec_init(gen, cfg: ModelCfg, device=None) -> EncDec:
    """The weights from the ``torch.Generator`` ``gen`` on ``device`` (the
    device rule of ``transformer.transformer_init``; nothing drawn on the
    meta device)."""
    device = L.init_device(gen, device)
    dt = L.model_dtype(cfg)
    enc_l = cfg.encoder_layers or cfg.num_layers
    return EncDec(cfg, {
        "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dt, device),
        "pos_dec": L.embed_init(gen, POS_DEC_ROWS, cfg.d_model, dt, device),
        "enc": [_enc_layer_init(gen, cfg, dt, device) for _ in range(enc_l)],
        "dec": [_dec_layer_init(gen, cfg, dt, device)
                for _ in range(cfg.num_layers)],
        "ln_enc": L.layernorm_init(cfg.d_model, device),
        "ln_f": L.layernorm_init(cfg.d_model, device),
    })


def _gelu_mlp(pl, x):
    return L.mlp_apply(pl["mlp"], L.layernorm(pl["ln2"], x), act="gelu",
                       gated=False)


def encode(params, cfg: ModelCfg, frames: torch.Tensor,
           differentiable: bool = False) -> torch.Tensor:
    """frames: (B, S_enc, d_model) precomputed embeddings (conv stub) ->
    the encoder's output (B, S_enc, d_model). ``differentiable``: the
    training attention (``flash.flash_attention_trainable``)."""
    B, S, d = frames.shape
    x = frames + _sinusoid(S, d, frames.device).to(frames.dtype)[None]
    x = constrain(x, "batch", None, None)
    for pl in params["enc"]:
        h = L.layernorm(pl["ln1"], x)
        q, k, v = A._project_qkv(pl["attn"], h, cfg.num_heads,
                                 cfg.num_kv_heads, cfg.resolved_head_dim)
        attn = A.flash_attention(q, k, v, causal=False, window=0,
                                 differentiable=differentiable)
        x = L.residual(x, attn.reshape(B, S, -1) @ pl["attn"]["wo"])
        x = L.residual(x, _gelu_mlp(pl, x))
    return L.layernorm(params["ln_enc"], x)


def _dec_layer(pl, cfg: ModelCfg, x, enc_out, differentiable: bool):
    """One decoder layer: (x, (k, v), (xk, xv))."""
    B, S, _ = x.shape
    h = L.layernorm(pl["ln1"], x)
    q, k, v = A._project_qkv(pl["self"], h, cfg.num_heads,
                             cfg.num_kv_heads, cfg.resolved_head_dim)
    attn = A.flash_attention(q, k, v, causal=True, window=0,
                             differentiable=differentiable)
    x = x + dot(attn.reshape(B, S, -1), pl["self"]["wo"])
    h = L.layernorm(pl["ln_x"], x)
    kk, vv = A.cross_kv(pl["cross"], enc_out,
                        num_kv_heads=cfg.num_kv_heads,
                        head_dim=cfg.resolved_head_dim)
    x = x + A.cross_attn_apply(pl["cross"], h, kk, vv,
                               num_heads=cfg.num_heads,
                               num_kv_heads=cfg.num_kv_heads,
                               head_dim=cfg.resolved_head_dim,
                               differentiable=differentiable)
    x = x + _gelu_mlp(pl, x)
    return x, (k, v), (kk, vv)


def _pos_rows(positions: torch.Tensor) -> torch.Tensor:
    """The rows of the decoder's position table for ``positions`` (on the
    device), clamped to its last row: parity with the reference's gathers
    (``repro/models/encdec.py:105, 167``, in ``decode_train`` and
    ``encdec_decode_step``), which clamp an index past the end as every JAX
    gather does. Past row ``POS_DEC_ROWS - 1`` every position reads that
    row; the decode step, whose position is a host int, clamps it there."""
    return positions.clamp(max=POS_DEC_ROWS - 1)


def decode_train(params, cfg: ModelCfg, tokens: torch.Tensor,
                 enc_out: torch.Tensor, remat: bool = False,
                 collect_cache: bool = False, return_hidden: bool = False):
    """Teacher-forced decoder pass -> (logits (B, S, V) f32 or the final
    normed hidden states, caches | None); caches (collect_cache) are
    ((k, v), (xk, xv)) stacked over the layers. Without ``collect_cache``
    the attention is the training path; ``remat`` recomputes each layer in
    the backward pass (see ``transformer.transformer_forward``)."""
    B, S = tokens.shape
    rows = _pos_rows(torch.arange(S, device=tokens.device))
    x = L.embed_lookup(params["embed"], tokens) + params["pos_dec"][rows][None]
    kvs, xkvs = [], []
    for pl in params["dec"]:
        x, kv, xkv = L.remat_call(remat, _dec_layer, pl, cfg, x, enc_out,
                                  not collect_cache)
        if collect_cache:
            kvs.append(kv)
            xkvs.append(xkv)
    caches = None
    if collect_cache:
        caches = (tuple(torch.stack(t) for t in zip(*kvs)),
                  tuple(torch.stack(t) for t in zip(*xkvs)))
    x = L.layernorm(params["ln_f"], x)
    if return_hidden:
        return x, caches
    return constrain(L.unembed(params["embed"], x), "batch", None,
                     "vocab"), caches


def encdec_init_cache(cfg: ModelCfg, batch: int, max_len: int,
                      device=None) -> dict:
    """Zeroed caches on ``device`` (CUDA unless asked otherwise)."""
    device = resolve_device(device)
    dt = L.model_dtype(cfg)
    kv, kd = cfg.num_kv_heads, cfg.resolved_head_dim
    self_shape = (cfg.num_layers, batch, max_len, kv, kd)
    cross_shape = (cfg.num_layers, batch, cfg.num_audio_frames, kv, kd)
    return {"k": torch.zeros(self_shape, dtype=dt, device=device),
            "v": torch.zeros(self_shape, dtype=dt, device=device),
            "xk": torch.zeros(cross_shape, dtype=dt, device=device),
            "xv": torch.zeros(cross_shape, dtype=dt, device=device)}


def encdec_prefill(params, cfg: ModelCfg, tokens: torch.Tensor,
                   frames: torch.Tensor, max_len: int):
    """Encode the frames, run the prompt; return (last-position logits
    (B, V) f32, cache at max_len). Every position is unembedded, as in the
    reference."""
    S = tokens.shape[1]
    enc_out = encode(params, cfg, frames)
    logits, ((k, v), (xk, xv)) = decode_train(params, cfg, tokens, enc_out,
                                              collect_cache=True)
    pad = max_len - S
    cache = {"k": F.pad(k, (0, 0, 0, 0, 0, pad)),
             "v": F.pad(v, (0, 0, 0, 0, 0, pad)),
             "xk": xk, "xv": xv}
    return logits[:, -1], cache


def encdec_decode_step(params, cfg: ModelCfg, token: torch.Tensor,
                       cache: dict, pos: int):
    """token: (B,) ints; pos: the position to write. Returns (logits (B, V)
    f32, cache), the self-attention cache written in place."""
    B = token.shape[0]
    pos = int(pos)
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    x = L.embed_lookup(params["embed"], token)[:, None, :] + \
        params["pos_dec"][min(pos, POS_DEC_ROWS - 1)][None, None]
    for i, pl in enumerate(params["dec"]):
        k_l, v_l = cache["k"][i], cache["v"][i]
        h = L.layernorm(pl["ln1"], x)
        q, k, v = A._project_qkv(pl["self"], h, H, KV, Dh)
        A.write_slot(k_l, pos, k[:, 0])
        A.write_slot(v_l, pos, v[:, 0])
        attn = A.decode_attention(q[:, 0], k_l, v_l, pos)
        x = x + attn.reshape(B, 1, -1) @ pl["self"]["wo"]
        h = L.layernorm(pl["ln_x"], x)
        x = x + A.cross_attn_apply(pl["cross"], h, cache["xk"][i],
                                   cache["xv"][i], num_heads=H,
                                   num_kv_heads=KV, head_dim=Dh)
        x = x + _gelu_mlp(pl, x)
    x = L.layernorm(params["ln_f"], x)
    return L.unembed(params["embed"], x)[:, 0], cache
