"""Mamba2 (SSD) block.

The port of ``repro.models.mamba2``, plain PyTorch as the reference is
plain ``jnp``. Prefill runs the chunked State-Space-Dual form: the sequence
is cut into chunks of ``cfg.chunk`` steps; inside a chunk the recurrence is
a masked, attention-like product, and the state passes from chunk to chunk
in a loop of S / chunk steps. Decode is the O(1) recurrence ``h <- a h +
dt B x`` a step, plus a rolling window of the causal conv's last K - 1
inputs.

Shapes: d_inner = expand * d_model, heads = d_inner / head_dim (P =
head_dim), one scalar decay per head (A), B and C shared across heads
(ngroups = 1), state N. ``A_log``, ``D`` and ``dt_bias`` are f32, the rest
in the model dtype. ``mamba2_decode`` writes the new state into the state
it is given, in place, and returns it.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMCfg
from repro_torch.convert import resolve_device
from repro_torch.models import layers as L


class Mamba2State(NamedTuple):
    h: torch.Tensor       # (..., B, H, P, N) SSM state, f32
    conv: torch.Tensor    # (..., B, d_conv - 1, conv_dim) pre-conv inputs


def _dims(d_model: int, cfg: SSMCfg):
    d_inner = cfg.expand * d_model
    heads = d_inner // cfg.head_dim
    conv_dim = d_inner + 2 * cfg.d_state    # x, B, C all pass the conv
    return d_inner, heads, conv_dim


def mamba2_init(gen, d_model: int, cfg: SSMCfg, dtype, device=None) -> dict:
    device = L.init_device(gen, device)
    d_inner, heads, conv_dim = _dims(d_model, cfg)
    f32 = torch.float32
    # in_proj -> [z (gate), x, B, C, dt]
    d_proj = 2 * d_inner + 2 * cfg.d_state + heads
    return {
        "w_in": L.dense_init(gen, d_model, d_proj, dtype, device=device),
        "conv_w": L._normal(gen, (cfg.d_conv, conv_dim), 0.1, dtype, device),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.zeros((heads,), dtype=f32, device=device),  # A = -exp
        "D": torch.ones((heads,), dtype=f32, device=device),
        "dt_bias": torch.zeros((heads,), dtype=f32, device=device),
        "w_out": L.dense_init(gen, d_inner, d_model, dtype, device=device),
        "norm": L.rmsnorm_init(d_inner, device),
    }


def _split_proj(proj, d_inner, d_state, heads):
    """[z | x, B, C | dt] along the last axis."""
    return torch.split(proj, [d_inner, d_inner + 2 * d_state, heads], dim=-1)


def _causal_conv(xBC, w, b):
    """xBC: (B, S, conv_dim); depthwise causal conv, kernel K. A Python sum
    of the K products, so each partial sum rounds in xBC's dtype as the
    reference's does."""
    K = w.shape[0]
    S = xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + S, :] * w[i] for i in range(K))
    return L._silu(out + b)


def mamba2_apply(params, x, cfg: SSMCfg, *, return_state: bool = False):
    """x: (B, S, d) -> y (B, S, d) [, the final Mamba2State]."""
    B, S, d_model = x.shape
    d_inner, heads, conv_dim = _dims(d_model, cfg)
    N, P, C = cfg.d_state, cfg.head_dim, min(cfg.chunk, S)

    proj = x @ params["w_in"]
    z, xBC, dt = _split_proj(proj, d_inner, N, heads)
    xBC = _causal_conv(xBC, params["conv_w"], params["conv_b"])
    xs, Bm, Cm = torch.split(xBC, [d_inner, N, N], dim=-1)

    # softplus before the padding: a padded step has dt = 0 exactly and
    # leaves the state as it was
    dt = F.softplus(dt.float() + params["dt_bias"])              # (B,S,H)
    A = -torch.exp(params["A_log"])                               # (H,)
    xh = xs.reshape(B, S, heads, P).float()
    Bm = Bm.float()                                               # (B,S,N)
    Cm = Cm.float()

    pad = (-S) % C
    if pad:
        xh, Bm, Cm, dt = (L.pad_seq(t, 1, pad) for t in (xh, Bm, Cm, dt))
    nc = (S + pad) // C
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=x.device))

    h = torch.zeros((B, heads, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        sl = slice(c * C, (c + 1) * C)
        xk, Bk, Ck, dtk = xh[:, sl], Bm[:, sl], Cm[:, sl], dt[:, sl]
        la = dtk * A                   # log decay per step (B,C,H)
        cum = torch.cumsum(la, dim=1)  # (B,C,H)
        # intra-chunk: M[t,s] = (C_t . B_s) exp(cum_t - cum_s) dt_s, s <= t
        gram = torch.einsum("btn,bsn->bts", Ck, Bk)              # (B,C,C)
        decay = torch.exp(cum[:, :, None, :] - cum[:, None, :, :])  # ..,H
        M = torch.where(tri[None, :, :, None], gram[..., None] * decay, 0.0)
        M = M * dtk[:, None, :, :]                               # weight dt_s
        y = torch.einsum("btsh,bshp->bthp", M, xk)
        # inter-chunk: contribution of the incoming state
        y = y + torch.einsum("btn,bhnp,bth->bthp", Ck, h.transpose(2, 3),
                             torch.exp(cum))
        # state update:
        # h' = exp(sum la) h + sum_s exp(cum_C - cum_s) dt_s B_s x_s^T
        tail = torch.exp(cum[:, -1:, :] - cum)                   # (B,C,H)
        dB = Bk[:, :, None, :] * (dtk * tail)[..., None]         # (B,C,H,N)
        h = torch.exp(cum[:, -1, :])[:, :, None, None] * h \
            + torch.einsum("bchn,bchp->bhpn", dB, xk)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :S]
    y = y + xh[:, :S] * params["D"][None, None, :, None]
    y = y.reshape(B, S, d_inner)
    y = L.rmsnorm(params["norm"], y.to(x.dtype)) * L._silu(z)
    out = y @ params["w_out"]
    if return_state:
        K = params["conv_w"].shape[0]
        pre_conv = torch.cat(
            [torch.zeros((B, max(K - 1 - S, 0), conv_dim), dtype=x.dtype,
                         device=x.device),
             _pre_conv_tail(x, params, d_inner, N, K, S)], dim=1)
        return out, Mamba2State(h=h, conv=pre_conv)
    return out


def _pre_conv_tail(x, params, d_inner, N, K, S):
    """The last K - 1 pre-conv xBC inputs (for decode continuation),
    re-projected from x."""
    proj = x[:, max(0, S - (K - 1)):, :] @ params["w_in"]
    _, xBC, _ = _split_proj(proj, d_inner, N, params["dt_bias"].shape[0])
    return xBC.to(x.dtype)


def mamba2_init_state(batch: int, d_model: int, cfg: SSMCfg, dtype,
                      lead: tuple = (), device=None) -> Mamba2State:
    """Zeroed state with leading axes ``lead``: ``h`` f32, ``conv`` in
    ``dtype``."""
    device = resolve_device(device)
    d_inner, heads, conv_dim = _dims(d_model, cfg)
    return Mamba2State(
        h=torch.zeros((*lead, batch, heads, cfg.head_dim, cfg.d_state),
                      dtype=torch.float32, device=device),
        conv=torch.zeros((*lead, batch, cfg.d_conv - 1, conv_dim),
                         dtype=dtype, device=device))


def mamba2_decode(params, x, state: Mamba2State, cfg: SSMCfg
                  ) -> Tuple[torch.Tensor, Mamba2State]:
    """x: (B, 1, d) single-token step. Returns (out (B, 1, d), state),
    ``state`` updated in place (``h`` as the reference's ``a h + dt x B``,
    product by product)."""
    B, _, d_model = x.shape
    d_inner, heads, conv_dim = _dims(d_model, cfg)
    N, P = cfg.d_state, cfg.head_dim

    proj = x @ params["w_in"]                             # (B,1,*)
    z, xBC, dt = _split_proj(proj, d_inner, N, heads)
    window = torch.cat([state.conv, xBC], dim=1)          # (B, K, conv_dim)
    conv_out = torch.sum(window * params["conv_w"][None], dim=1) \
        + params["conv_b"]
    xBC1 = L._silu(conv_out)                              # (B, conv_dim)
    xs, Bm, Cm = torch.split(xBC1, [d_inner, N, N], dim=-1)

    dt1 = F.softplus(dt[:, 0].float() + params["dt_bias"])       # (B,H)
    A = -torch.exp(params["A_log"])
    a = torch.exp(dt1 * A)                                # (B,H)
    xh = xs.reshape(B, heads, P).float()
    state.h.mul_(a[:, :, None, None]).add_(
        torch.einsum("bh,bhp,bn->bhpn", dt1, xh, Bm.float()))
    state.conv.copy_(window[:, 1:])
    y = torch.einsum("bhpn,bn->bhp", state.h, Cm.float())
    y = y + xh * params["D"][None, :, None]
    y = y.reshape(B, 1, d_inner)
    y = L.rmsnorm(params["norm"], y.to(x.dtype)) * L._silu(z)
    return y @ params["w_out"], state
