"""Recurrent-family model assemblies: xLSTM and the Zamba2-style hybrid.

The port of ``repro.models.recurrent``. The reference stacks each layer
kind's parameters on leading axes and scans over them; here the weights
are an :class:`XLSTM` or :class:`Hybrid` module of ``ModuleList`` nodes
(one per stacked index) and the passes are Python loops, the functions
keeping the reference's names and signatures with the module in the place
of the params pytree.

xLSTM: layers in G groups of (R mLSTM + 1 sLSTM) (7:1 for the 1.3b
config); ``groups.mlstm[g][r]`` and ``groups.mln[g][r]`` (the pre-norm),
``groups.slstm[g]`` and ``groups.sln[g]``. sLSTM is serial over time by
construction (see ``xlstm.py``).

Zamba2 hybrid: G groups of E Mamba2 blocks (``mamba[g][e]``, ``mln[g][e]``)
with ONE shared attention + MLP block (``shared_attn``: ``ln1``, ``attn``,
``ln2``, ``mlp``) applied after every group: the same weights at each of
the G applications, each application with its own K/V cache.

Caches keep the reference's stacked layout: xLSTM ``{"mlstm":
MLSTMState of (G, R, B, ...), "slstm": SLSTMState of (G, B, d_inner)}``;
hybrid ``{"mamba": Mamba2State of (G, E, B, ...), "k", "v": (G, B,
max_len, KV, Dh)}`` in the model dtype. A decode step writes every layer's
new state (and the new token's k / v) into its slot of the cache in place
and returns the cache. The hybrid's attention is the port's inference
``flash_attention``; the forward without ``collect_cache`` runs the
training attention, as the reference does. ``remat`` recomputes each
block, and each group around its blocks, in the backward pass (the
reference's nested ``jax.checkpoint``). The embedded tokens and the
logits carry the reference's ``constrain`` annotations
(``models/sharding.py``), the identity on one device.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.convert import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as XL
from repro_torch.models.sharding import constrain

# the (V, d) unembedding matrix, tied or separate: the transformer's rule
head_matrix = T.head_matrix


class XLSTM(L.ParamTree):
    """An xLSTM's weights (see the module docstring), frozen and read as
    the reference's tree (``params["groups"]["mlstm"][g][r]["w_q"]``)."""

    def __init__(self, cfg: ModelCfg, params: dict):
        super().__init__(params)
        self.cfg = cfg
        self.requires_grad_(False)


class Hybrid(L.ParamTree):
    """A Zamba2-style hybrid's weights (see the module docstring), frozen
    and read as the reference's tree (``params["mamba"][g][e]["w_in"]``,
    ``params["shared_attn"]["attn"]["wq"]``)."""

    def __init__(self, cfg: ModelCfg, params: dict):
        super().__init__(params)
        self.cfg = cfg
        self.requires_grad_(False)


def _head(params, cfg: ModelCfg, x):
    """Final norm, then f32 logits (tied: f32 by f32)."""
    return constrain(T._head(params, cfg, L.rmsnorm(params["ln_f"], x)),
                     "batch", None, "vocab")


def _stack_states(states, cls):
    """A list of state tuples -> one state of stacked fields."""
    return cls(*(torch.stack(list(f)) for f in zip(*states)))


# ================================ xLSTM ====================================

def _xlstm_layout(cfg: ModelCfg) -> Tuple[int, int]:
    """(groups, mlstm_per_group): the pattern tiles (mlstm * R, slstm)."""
    pat = cfg.block_pattern or ("mlstm",) * 7 + ("slstm",)
    per = len(pat)
    if cfg.num_layers % per:
        raise ValueError(f"{cfg.name}: num_layers {cfg.num_layers} must "
                         f"tile the block pattern of {per}")
    r = sum(1 for b in pat if b == "mlstm")
    if pat != ("mlstm",) * r + ("slstm",) * (per - r):
        raise ValueError(f"{cfg.name}: the xlstm pattern must be mlstm "
                         f"runs then slstm, not {pat}")
    return cfg.num_layers // per, r


def xlstm_init(gen, cfg: ModelCfg, device=None) -> XLSTM:
    """The weights from the ``torch.Generator`` ``gen`` on ``device`` (the
    device rule of ``transformer.transformer_init``; nothing drawn on the
    meta device)."""
    device = L.init_device(gen, device)
    dt = L.model_dtype(cfg)
    G, R = _xlstm_layout(cfg)
    d, H = cfg.d_model, cfg.num_heads
    params: Dict[str, Any] = {
        "embed": L.embed_init(gen, cfg.vocab_size, d, dt, device),
        "ln_f": L.rmsnorm_init(d, device),
        "groups": {
            "mlstm": [[XL.mlstm_init(gen, d, H, dt, device=device)
                       for _ in range(R)] for _ in range(G)],
            "mln": [[L.rmsnorm_init(d, device) for _ in range(R)]
                    for _ in range(G)],
            "slstm": [XL.slstm_init(gen, d, H, dt, device=device)
                      for _ in range(G)],
            "sln": [L.rmsnorm_init(d, device) for _ in range(G)],
        },
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, d, cfg.vocab_size, dt,
                                         device=device)
    return XLSTM(cfg, params)


def _mlstm_block(pl, ln, x, num_heads):
    return L.residual(x, XL.mlstm_apply(pl, L.rmsnorm(ln, x), num_heads))


def _xlstm_group(x, pm, lns, ps, sln, num_heads, remat):
    """One group's forward without states: R mLSTM blocks (each
    recomputed in the backward with ``remat``), then the sLSTM block."""
    for pl, ln in zip(pm, lns):
        x = L.remat_call(remat, _mlstm_block, pl, ln, x, num_heads)
    return L.residual(x, XL.slstm_apply(ps, L.rmsnorm(sln, x), num_heads))


def xlstm_forward(params, cfg: ModelCfg, tokens: torch.Tensor,
                  remat: bool = False, collect_state: bool = False,
                  return_hidden: bool = False):
    """tokens: (B, S) -> (logits (B, S, V) f32, states | None).
    ``collect_state``: the final states, (MLSTMState of (G, R, B, ...),
    SLSTMState of (G, B, d_inner)). ``return_hidden``: the final normed
    hidden states in place of the logits. ``remat``: see the module
    docstring (the groups only without ``collect_state``)."""
    x = L.embed_lookup(params["embed"], tokens)
    x = constrain(x, "batch", None, None)
    H = cfg.num_heads
    m_states, s_states = [], []
    groups = params["groups"]
    for pm, lns, ps, sln in zip(groups["mlstm"], groups["mln"],
                                groups["slstm"], groups["sln"]):
        if not collect_state:
            x = L.remat_call(remat, _xlstm_group, x, pm, lns, ps, sln, H,
                             remat)
            continue
        gm = []
        for pl, ln in zip(pm, lns):
            out, st = XL.mlstm_apply(pl, L.rmsnorm(ln, x), H,
                                     return_state=True)
            gm.append(st)
            x = L.residual(x, out)
        out, st = _slstm_apply_with_state(ps, x, H, sln)
        m_states.append(_stack_states(gm, XL.MLSTMState))
        s_states.append(st)
        x = L.residual(x, out)
    states = (_stack_states(m_states, XL.MLSTMState),
              _stack_states(s_states, XL.SLSTMState)) \
        if collect_state else None
    if return_hidden:
        return L.rmsnorm(params["ln_f"], x), states
    return _head(params, cfg, x), states


def _slstm_apply_with_state(p, x, num_heads, ln):
    """The sLSTM block on x under its pre-norm ``ln``: (out, the final
    SLSTMState)."""
    return XL.slstm_apply(p, L.rmsnorm(ln, x), num_heads, return_state=True)


def xlstm_init_cache(cfg: ModelCfg, batch: int, device=None) -> dict:
    """Zeroed states (stabilisers at NEG_INF) on ``device`` (CUDA unless
    asked otherwise)."""
    G, R = _xlstm_layout(cfg)
    device = resolve_device(device)
    return {"mlstm": XL.mlstm_init_state(batch, cfg.d_model, cfg.num_heads,
                                         lead=(G, R), device=device),
            "slstm": XL.slstm_init_state(batch, cfg.d_model, cfg.num_heads,
                                         lead=(G,), device=device)}


def _slot(state, *idx):
    """The views of a stacked state at ``idx`` (writes land in the cache)."""
    return type(state)(*(f[idx] for f in state))


def xlstm_decode_step(params, cfg: ModelCfg, token: torch.Tensor, cache: dict,
                      pos=None):
    """token: (B,) ints (``pos`` is not read: the state is the position).
    Returns (logits (B, V) f32, cache), the cache's states updated in
    place."""
    x = L.embed_lookup(params["embed"], token)[:, None, :]
    H = cfg.num_heads
    groups = params["groups"]
    for g, (pm, lns, ps, sln) in enumerate(zip(
            groups["mlstm"], groups["mln"], groups["slstm"], groups["sln"])):
        for r, (pl, ln) in enumerate(zip(pm, lns)):
            out, _ = XL.mlstm_decode(pl, L.rmsnorm(ln, x),
                                     _slot(cache["mlstm"], g, r), H)
            x = L.residual(x, out)
        out, _ = XL.slstm_decode(ps, L.rmsnorm(sln, x),
                                 _slot(cache["slstm"], g), H)
        x = L.residual(x, out)
    return _head(params, cfg, x)[:, 0], cache


def xlstm_prefill(params, cfg: ModelCfg, tokens: torch.Tensor,
                  max_len: int = 0):
    """Run the prompt: (last-position logits (B, V) f32, cache). Only the
    last position is unembedded; ``max_len`` is not read."""
    x, (mst, sst) = xlstm_forward(params, cfg, tokens, collect_state=True,
                                  return_hidden=True)
    logits = T._head(params, cfg, x[:, -1:])
    return logits[:, 0], {"mlstm": mst, "slstm": sst}


# ============================ Zamba2 hybrid ================================

def _hybrid_layout(cfg: ModelCfg) -> Tuple[int, int]:
    """(groups, mamba blocks per group)."""
    e = cfg.shared_attn_every or 6
    if cfg.num_layers % e:
        raise ValueError(f"{cfg.name}: num_layers {cfg.num_layers} must "
                         f"be a multiple of shared_attn_every {e}")
    return cfg.num_layers // e, e


def hybrid_init(gen, cfg: ModelCfg, device=None) -> Hybrid:
    """The weights from ``gen`` on ``device`` (as :func:`xlstm_init`)."""
    device = L.init_device(gen, device)
    dt = L.model_dtype(cfg)
    G, E = _hybrid_layout(cfg)
    d = cfg.d_model
    params: Dict[str, Any] = {
        "embed": L.embed_init(gen, cfg.vocab_size, d, dt, device),
        "ln_f": L.rmsnorm_init(d, device),
        "mamba": [[M2.mamba2_init(gen, d, cfg.ssm, dt, device=device)
                   for _ in range(E)] for _ in range(G)],
        "mln": [[L.rmsnorm_init(d, device) for _ in range(E)]
                for _ in range(G)],
        # ONE shared attention block (the Zamba trick): its weights serve
        # each of the G application points, each with its own KV cache
        "shared_attn": {
            "ln1": L.rmsnorm_init(d, device),
            "attn": A.attn_init(gen, d, cfg.num_heads, cfg.num_kv_heads,
                                cfg.resolved_head_dim, dt, device=device),
            "ln2": L.rmsnorm_init(d, device),
            "mlp": L.mlp_init(gen, d, cfg.d_ff, dt, device=device),
        },
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, d, cfg.vocab_size, dt,
                                         device=device)
    return Hybrid(cfg, params)


def _mamba_block(pl, ln, x, ssm):
    return L.residual(x, M2.mamba2_apply(pl, L.rmsnorm(ln, x), ssm))


def _shared_block(sh, cfg: ModelCfg, x, differentiable: bool):
    """The shared attention + MLP block: (x, (k, v))."""
    h = L.rmsnorm(sh["ln1"], x)
    attn_out, kv = A.self_attn_apply(
        sh["attn"], h, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
        theta=cfg.rope_theta, window=0, differentiable=differentiable)
    x = L.residual(x, attn_out)
    return L.residual(x, L.mlp_apply(sh["mlp"], L.rmsnorm(sh["ln2"], x))), kv


def _hybrid_group(x, pm, lns, sh, cfg: ModelCfg, remat: bool):
    """One group's forward without states: E Mamba2 blocks (each
    recomputed in the backward with ``remat``), then the shared block on
    the training attention."""
    for pl, ln in zip(pm, lns):
        x = L.remat_call(remat, _mamba_block, pl, ln, x, cfg.ssm)
    return _shared_block(sh, cfg, x, True)[0]


def hybrid_forward(params, cfg: ModelCfg, tokens: torch.Tensor,
                   remat: bool = False, collect_cache: bool = False,
                   return_hidden: bool = False):
    """tokens: (B, S) -> (logits (B, S, V) f32, aux | None).
    ``collect_cache``: aux is (Mamba2State of (G, E, B, ...), (k, v) of
    (G, B, S, KV, Dh)); ``return_hidden`` and ``remat`` as in
    :func:`xlstm_forward`."""
    x = L.embed_lookup(params["embed"], tokens)
    x = constrain(x, "batch", None, None)
    sh = params["shared_attn"]
    m_states, ks, vs = [], [], []
    for pm, lns in zip(params["mamba"], params["mln"]):
        if not collect_cache:
            x = L.remat_call(remat, _hybrid_group, x, pm, lns, sh, cfg,
                             remat)
            continue
        gm = []
        for pl, ln in zip(pm, lns):
            out, st = M2.mamba2_apply(pl, L.rmsnorm(ln, x), cfg.ssm,
                                      return_state=True)
            gm.append(st)
            x = L.residual(x, out)
        x, (k, v) = _shared_block(sh, cfg, x, False)
        m_states.append(_stack_states(gm, M2.Mamba2State))
        ks.append(k)
        vs.append(v)
        del k, v
    aux = (_stack_states(m_states, M2.Mamba2State),
           (torch.stack(ks), torch.stack(vs))) if collect_cache else None
    if return_hidden:
        return L.rmsnorm(params["ln_f"], x), aux
    return _head(params, cfg, x), aux


def hybrid_init_cache(cfg: ModelCfg, batch: int, max_len: int,
                      device=None) -> dict:
    """Zeroed states and K/V caches on ``device`` (CUDA unless asked
    otherwise)."""
    G, E = _hybrid_layout(cfg)
    device = resolve_device(device)
    dt = L.model_dtype(cfg)
    kv = (G, batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"mamba": M2.mamba2_init_state(batch, cfg.d_model, cfg.ssm, dt,
                                          lead=(G, E), device=device),
            "k": torch.zeros(kv, dtype=dt, device=device),
            "v": torch.zeros(kv, dtype=dt, device=device)}


def hybrid_prefill(params, cfg: ModelCfg, tokens: torch.Tensor, max_len: int):
    """Run the prompt: (last-position logits (B, V) f32, cache with K/V
    zero-padded to ``max_len``). Only the last position is unembedded."""
    S = tokens.shape[1]
    x, (mst, (k, v)) = hybrid_forward(params, cfg, tokens,
                                      collect_cache=True, return_hidden=True)
    logits = T._head(params, cfg, x[:, -1:])
    pad = max_len - S
    return logits[:, 0], {"mamba": mst, "k": L.pad_seq(k, 2, pad),
                          "v": L.pad_seq(v, 2, pad)}


def hybrid_decode_step(params, cfg: ModelCfg, token: torch.Tensor,
                       cache: dict, pos: int):
    """token: (B,) ints; pos: the position to write. Returns (logits (B, V)
    f32, cache), every Mamba2 state and group g's K/V (``cache["k"][g]``)
    written in place."""
    x = L.embed_lookup(params["embed"], token)[:, None, :]
    sh = params["shared_attn"]
    for g, (pm, lns) in enumerate(zip(params["mamba"], params["mln"])):
        for e, (pl, ln) in enumerate(zip(pm, lns)):
            out, _ = M2.mamba2_decode(pl, L.rmsnorm(ln, x),
                                      _slot(cache["mamba"], g, e), cfg.ssm)
            x = L.residual(x, out)
        h = L.rmsnorm(sh["ln1"], x)
        attn_out, _, _ = A.self_attn_decode(
            sh["attn"], h, cache["k"][g], cache["v"][g], pos,
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.resolved_head_dim, theta=cfg.rope_theta)
        x = L.residual(x, attn_out)
        x = L.residual(x, L.mlp_apply(sh["mlp"], L.rmsnorm(sh["ln2"], x)))
    return _head(params, cfg, x)[:, 0], cache
