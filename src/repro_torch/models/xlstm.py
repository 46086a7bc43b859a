"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

The port of ``repro.models.xlstm``, plain PyTorch as the reference is plain
``jnp``. mLSTM's exponential gating admits a parallel quadratic form, an
attention with the data-dependent decay ``D[t, s] = exp(cumf_t - cumf_s +
i_s)``: ``_mlstm_parallel`` computes it blockwise with the online-max
rescaling of flash attention (query blocks of ``block_q``, KV blocks of
``block_kv``), so a long prefill never holds S x S. Decode is the O(P^2)
recurrence on each head's (P, P) matrix state. The reference scans every
KV block, masking the ones after a query block; here those blocks are
skipped, which changes nothing: a fully masked block leaves the running
max, and so the carry, exactly as it was.

sLSTM is serial over time by construction (the hidden state feeds the
gates through the per-head block-diagonal ``R``): there is no parallel
form, so ``slstm_apply`` loops over the sequence.

Weights keep the reference's layout and dtypes: the projections in the
model dtype, the gate weights ``w_i``, ``w_f``, ``b_i``, ``b_f`` and sLSTM's
``R`` and ``b`` in f32. States are f32; ``NEG_INF`` starts the
stabilisers. Each f32 step widens through ``layers.wide``, so a float64
copy of the weights computes in float64 throughout. ``mlstm_decode`` and
``slstm_decode`` write the new state into the state they are given, in
place, and return it.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.convert import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.sharding import unflatten

NEG_INF = -1e30


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``F.logsigmoid``; on a DTensor, shard by shard (``local_map``:
    DTensor has no sharding rule for it, and the op is elementwise, so each
    shard's value is the whole tensor's there). A pending sum is reduced
    first."""
    if not isinstance(x, DTensor):
        return F.logsigmoid(x)
    place = [Replicate() if p.is_partial() else p for p in x.placements]
    return local_map(F.logsigmoid, out_placements=place,
                     in_placements=(place,), device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x)


def _per_shard(fn, *ts: torch.Tensor) -> torch.Tensor:
    """``fn(*ts)`` of plain tensors whose dims 0 and 2 (batch and heads)
    are independent rows, on DTensors: each rank runs ``fn`` on its own
    batch rows and heads (``local_map``); a mesh dim that shards anything
    else (the sequence, or heads it would cut unevenly) is gathered
    first. The result is laid out as the inputs."""
    if not isinstance(ts[0], DTensor):
        return fn(*ts)
    mesh = ts[0].device_mesh
    place = [p if p in (Shard(0), Shard(2)) else Replicate()
             for p in ts[0].placements]
    heads = math.prod(n for p, n in zip(place, mesh.shape) if p == Shard(2))
    if ts[0].shape[2] % heads:
        place = [Replicate() if p == Shard(2) else p for p in place]
    return local_map(fn, out_placements=place,
                     in_placements=(place,) * len(ts), device_mesh=mesh,
                     redistribute_inputs=True)(*ts)


# =============================== mLSTM =====================================

class MLSTMState(NamedTuple):
    C: torch.Tensor   # (..., B, H, P, P) matrix memory, v ⊗ k
    n: torch.Tensor   # (..., B, H, P) normalizer
    m: torch.Tensor   # (..., B, H) stabilizer


def mlstm_init(gen, d_model: int, num_heads: int, dtype, pf: float = 2.0,
               device=None) -> dict:
    device = L.init_device(gen, device)
    d_inner = int(pf * d_model)
    f32 = torch.float32

    def dense(d_in, d_out, dt):
        return L.dense_init(gen, d_in, d_out, dt, device=device)

    return {
        "w_up": dense(d_model, 2 * d_inner, dtype),
        "w_q": dense(d_inner, d_inner, dtype),
        "w_k": dense(d_inner, d_inner, dtype),
        "w_v": dense(d_inner, d_inner, dtype),
        "w_i": dense(d_inner, num_heads, f32),
        "w_f": dense(d_inner, num_heads, f32),
        "b_i": torch.zeros((num_heads,), dtype=f32, device=device),
        "b_f": torch.full((num_heads,), 3.0, dtype=f32,
                          device=device),             # open forget gates
        "w_down": dense(d_inner, d_model, dtype),
        "norm": L.rmsnorm_init(d_inner, device),
    }


def _in_dtype(c: float, dtype) -> float:
    """The Python float ``c`` rounded to ``dtype`` (on the host)."""
    return float(torch.tensor(c, dtype=dtype))


def _mlstm_qkvif(params, x, num_heads):
    B, S, _ = x.shape
    up = x @ params["w_up"]
    xi, z = torch.chunk(up, 2, dim=-1)                   # inner stream + gate
    d_inner = xi.shape[-1]
    P = d_inner // num_heads
    q = unflatten(xi @ params["w_q"], 2, (num_heads, P))
    # the reference divides by sqrt(P) taken in x's dtype (a weakly typed
    # constant): round it there, then divide
    k = unflatten(xi @ params["w_k"], 2, (num_heads, P)) \
        / _in_dtype(math.sqrt(P), x.dtype)
    v = unflatten(xi @ params["w_v"], 2, (num_heads, P))
    it = L.wide(xi) @ params["w_i"] + params["b_i"]                # (B,S,H)
    ft = L.wide(xi) @ params["w_f"] + params["b_f"]
    return q, k, v, it, ft, z, d_inner, P


def _mlstm_parallel(q, k, v, it, ft, *, block_q: int = 256,
                    block_kv: int = 512) -> torch.Tensor:
    """Blockwise stabilised quadratic mLSTM. q, k, v: (B, S, H, P); it, ft:
    (B, S, H) f32. Returns (B, S, H, P) f32."""
    B, S, H, P = q.shape
    logf = _log_sigmoid(ft)                              # (B,S,H)
    cum = torch.cumsum(logf, dim=1)                      # inclusive cumsum
    # weight for pair (t, s): exp(cum_t - cum_s + i_s), s <= t
    bq = min(block_q, S)
    bkv = min(block_kv, S)
    pq, pkv = (-S) % bq, (-S) % bkv
    qf = L.pad_seq(L.wide(q), 1, pq)
    cumq = L.pad_seq(cum, 1, pq)
    kf = L.pad_seq(L.wide(k), 1, pkv)
    vf = L.pad_seq(L.wide(v), 1, pkv)
    cumk = L.pad_seq(cum, 1, pkv)
    itp = L.pad_seq(it, 1, pkv, NEG_INF)             # padded keys: i = -inf
    nq, nkv = (S + pq) // bq, (S + pkv) // bkv
    dev, acc = q.device, qf.dtype
    out = torch.empty((B, nq * bq, H, P), dtype=acc, device=dev)
    arange_q = torch.arange(bq, device=dev)
    arange_kv = torch.arange(bkv, device=dev)

    for qi in range(nq):
        q_start = qi * bq
        qblk = qf[:, q_start:q_start + bq]               # (B,bq,H,P)
        cq = cumq[:, q_start:q_start + bq]               # (B,bq,H)
        q_pos = q_start + arange_q
        m = torch.full((B, bq, H), NEG_INF, dtype=acc, device=dev)
        num = torch.zeros((B, bq, H, P), dtype=acc, device=dev)
        den = torch.zeros((B, bq, H), dtype=acc, device=dev)
        # KV blocks past the query block's last row are fully masked
        for t in range(min((q_start + bq + bkv - 1) // bkv, nkv)):
            sl = slice(t * bkv, (t + 1) * bkv)
            kblk, vblk, ck, ik = kf[:, sl], vf[:, sl], cumk[:, sl], itp[:, sl]
            k_pos = t * bkv + arange_kv
            causal = q_pos[:, None] >= k_pos[None, :]    # (bq,bkv)
            # logD: (B,bq,bkv,H)
            logD = cq[:, :, None, :] - ck[:, None, :, :] + ik[:, None, :, :]
            logD = torch.where(causal[None, :, :, None], logD, NEG_INF)
            m_new = torch.maximum(m, logD.amax(dim=2))   # (B,bq,H)
            # explicit mask: a masked pair must add 0, never exp(0)
            w = torch.exp(logD - m_new[:, :, None, :]) \
                * causal[None, :, :, None].to(acc)
            corr = torch.exp(m - m_new)
            qk = torch.einsum("bqhp,bjhp->bqjh", qblk, kblk)   # (B,bq,bkv,H)
            wqk = w * qk
            num = num * corr[..., None] + torch.einsum("bqjh,bjhp->bqhp",
                                                       wqk, vblk)
            den = den * corr + wqk.sum(dim=2)
            m = m_new
        y = num / torch.maximum(den.abs(), torch.exp(-m))[..., None]
        out[:, q_start:q_start + bq] = y
    return out[:, :S]


def mlstm_apply(params, x, num_heads: int, return_state: bool = False):
    """x: (B, S, d) -> out (B, S, d) [, the final MLSTMState]."""
    B, S, _ = x.shape
    q, k, v, it, ft, z, d_inner, P = _mlstm_qkvif(params, x, num_heads)
    y = _per_shard(_mlstm_parallel, q, k, v, it, ft)
    y = y.reshape(B, S, d_inner).to(x.dtype)
    y = L.rmsnorm(params["norm"], y) * L._silu(z)
    out = y @ params["w_down"]
    if not return_state:
        return out
    # closed-form final state:
    # C_S = sum_s exp(cum_S - cum_s + i_s - m) v_s k_s^T
    logf = _log_sigmoid(ft)
    cum = torch.cumsum(logf, dim=1)                      # (B,S,H)
    logw = cum[:, -1:, :] - cum + it                     # (B,S,H)
    m_fin = logw.amax(dim=1)                             # (B,H)
    w = torch.exp(logw - m_fin[:, None, :])              # (B,S,H)
    kf = L.wide(k)
    C = torch.einsum("bshp,bshq->bhpq", w[..., None] * L.wide(v), kf)
    n = torch.einsum("bsh,bshq->bhq", w, kf)
    return out, MLSTMState(C=C, n=n, m=m_fin)


def mlstm_init_state(batch: int, d_model: int, num_heads: int,
                     pf: float = 2.0, lead: tuple = (),
                     device=None) -> MLSTMState:
    """Zeroed state (``m`` at NEG_INF) with leading axes ``lead``."""
    device = resolve_device(device)
    P = int(pf * d_model) // num_heads
    shape = (*lead, batch, num_heads)
    f32 = torch.float32
    return MLSTMState(
        C=torch.zeros((*shape, P, P), dtype=f32, device=device),
        n=torch.zeros((*shape, P), dtype=f32, device=device),
        m=torch.full(shape, NEG_INF, dtype=f32, device=device))


def mlstm_decode(params, x, state: MLSTMState, num_heads: int
                 ) -> Tuple[torch.Tensor, MLSTMState]:
    """x: (B, 1, d). Returns (out (B, 1, d), state), ``state`` updated in
    place (each product rounded as the reference's ``a * C + b * v k^T``)."""
    B = x.shape[0]
    q, k, v, it, ft, z, d_inner, P = _mlstm_qkvif(params, x, num_heads)
    q1, k1, v1 = (L.wide(t[:, 0]) for t in (q, k, v))       # (B,H,P)
    i1, f1 = it[:, 0], ft[:, 0]                          # (B,H)
    logf = _log_sigmoid(f1)
    m_new = torch.maximum(state.m + logf, i1)
    a = torch.exp(state.m + logf - m_new)                # decay of old state
    b = torch.exp(i1 - m_new)                            # write strength
    vk = torch.einsum("bhp,bhq->bhpq", v1, k1)
    state.C.mul_(a[..., None, None]).add_(b[..., None, None] * vk)
    state.n.mul_(a[..., None]).add_(b[..., None] * k1)
    state.m.copy_(m_new)
    num = torch.einsum("bhpq,bhq->bhp", state.C, q1)
    den = torch.maximum(torch.einsum("bhq,bhq->bh", state.n, q1).abs(),
                        torch.exp(-m_new))
    y = (num / den[..., None]).reshape(B, 1, d_inner).to(x.dtype)
    y = L.rmsnorm(params["norm"], y) * L._silu(z)
    return y @ params["w_down"], state


# =============================== sLSTM =====================================

class SLSTMState(NamedTuple):
    c: torch.Tensor   # (..., B, d_inner)
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor


def slstm_dims(d_model: int, num_heads: int,
               pf: float = 4.0 / 3.0) -> Tuple[int, int]:
    """(d_inner, P): d_inner is int(pf d) rounded down to whole heads."""
    d_inner = (int(pf * d_model) // num_heads) * num_heads
    return d_inner, d_inner // num_heads


def slstm_init(gen, d_model: int, num_heads: int, dtype,
               pf: float = 4.0 / 3.0, device=None) -> dict:
    device = L.init_device(gen, device)
    d_inner, P = slstm_dims(d_model, num_heads, pf)
    f32 = torch.float32
    return {
        "w_in": L.dense_init(gen, d_model, 4 * d_inner, dtype, device=device),
        # block-diagonal recurrent weights per head: h (P) -> gates (4P)
        "R": L._normal(gen, (num_heads, P, 4 * P), 1.0 / math.sqrt(P), f32,
                       device),
        "b": torch.cat([torch.zeros((2 * d_inner,), dtype=f32, device=device),
                        torch.full((d_inner,), 3.0, dtype=f32, device=device),
                        torch.zeros((d_inner,), dtype=f32, device=device)]),
        "w_down": L.dense_init(gen, d_inner, d_model, dtype, device=device),
        "norm": L.rmsnorm_init(d_inner, device),
    }


def _slstm_cell(gates, st: SLSTMState, d_inner: int) -> SLSTMState:
    zt, it, ft, ot = torch.split(gates, d_inner, dim=-1)   # each (B, d_inner)
    logf = _log_sigmoid(ft)
    m_new = torch.maximum(logf + st.m, it)
    i = torch.exp(it - m_new)
    f = torch.exp(logf + st.m - m_new)
    c = f * st.c + i * torch.tanh(zt)
    n = torch.clamp_min(f * st.n + i, 1.0)
    h = torch.sigmoid(ot) * c / n
    return SLSTMState(c=c, n=n, h=h, m=m_new)


def _slstm_gates(params, xt, h_prev, num_heads, d_inner):
    """xt: (B, 4 d_inner) pre-projected input; h_prev: (B, d_inner). The
    recurrent term is per head (B, H, 4, P), laid out gate-major (B, 4, H,
    P) before the flatten, as the input projection's [z | i | f | o]."""
    B = h_prev.shape[0]
    P = d_inner // num_heads
    hh = h_prev.reshape(B, num_heads, P)
    rec = torch.einsum("bhp,hpg->bhg", hh, params["R"]) \
        .reshape(B, num_heads, 4, P)
    rec = rec.transpose(1, 2).reshape(B, 4 * d_inner)
    return L.wide(xt) + rec + params["b"]


def slstm_init_state(batch: int, d_model: int, num_heads: int,
                     pf: float = 4.0 / 3.0, lead: tuple = (),
                     device=None, dtype=torch.float32) -> SLSTMState:
    """Zeroed state (``m`` at NEG_INF) with leading axes ``lead``."""
    device = resolve_device(device)
    d_inner, _ = slstm_dims(d_model, num_heads, pf)
    shape = (*lead, batch, d_inner)

    def z():
        return torch.zeros(shape, dtype=dtype, device=device)

    return SLSTMState(c=z(), n=z(), h=z(),
                      m=torch.full(shape, NEG_INF, dtype=dtype,
                                   device=device))


def _slstm_scan(xin, R, b):
    """sLSTM's loop over time on plain tensors, the arithmetic of
    ``_slstm_gates`` and ``_slstm_cell`` a step. xin: (B, S, 4 d_inner)
    in the state's dtype; R: (H, P, 4P); b: (4 d_inner,). Returns hs (B, S,
    d_inner) and the final c, n, h, m, each (B, d_inner).

    ``b`` is added once, before the loop, and the gates are laid out head-
    major, (S, H, B, 4P) with each head's 4P gate-major as ``R``'s columns,
    so a step's recurrent product is one ``baddbmm`` straight into its
    gates, and the state stays (H, B, P) throughout: 18 ops a step, none a
    copy of the layout. ``logsigmoid(f) + m`` is taken once for both of
    its uses, as the reference's two are the same sum."""
    B, S, _ = xin.shape
    H, P, _ = R.shape
    gx = (xin + b).unflatten(-1, (4, H, P)).permute(1, 3, 0, 2, 4) \
        .reshape(S, H, B, 4 * P)
    c = torch.zeros((H, B, P), dtype=xin.dtype, device=xin.device)
    n, h = torch.zeros_like(c), torch.zeros_like(c)
    m = torch.full_like(c, NEG_INF)
    hs = []
    for t in range(S):
        zt, it, ft, ot = torch.baddbmm(gx[t], h, R).split(P, dim=-1)
        logf_m = F.logsigmoid(ft) + m
        m_new = torch.maximum(logf_m, it)
        i = torch.exp(it - m_new)
        f = torch.exp(logf_m - m_new)
        c = torch.addcmul(f * c, i, torch.tanh(zt))
        n = torch.clamp_min(torch.addcmul(i, f, n), 1.0)
        h = torch.sigmoid(ot) * c / n
        m = m_new
        hs.append(h)

    def rows(t):                                         # (H,B,P)->(B,H P)
        return t.transpose(0, 1).reshape(B, H * P)
    hs = torch.stack(hs, dim=2).permute(1, 2, 0, 3).reshape(B, S, H * P)
    return (hs, *map(rows, (c, n, h, m)))


def slstm_apply(params, x, num_heads: int, return_state: bool = False):
    """A serial loop over time (no parallel form exists; ``_slstm_scan``).
    x: (B, S, d) -> out (B, S, d) [, the final SLSTMState]. On DTensors
    each rank runs the loop on its own batch rows (``local_map``; ``R``
    and ``b`` whole), so the S steps' small ops do not each go through
    DTensor's dispatch."""
    xin = L.wide(x @ params["w_in"])                     # (B,S,4 d_inner)
    scan = _slstm_scan
    if isinstance(xin, DTensor):
        rows = [p if p == Shard(0) else Replicate() for p in xin.placements]
        whole = [Replicate()] * len(rows)
        scan = local_map(scan, out_placements=(rows,) * 5,
                         in_placements=(rows, whole, whole),
                         device_mesh=xin.device_mesh,
                         redistribute_inputs=True)
    hs, *st = scan(xin, params["R"], params["b"])
    y = hs.to(x.dtype)
    y = L.rmsnorm(params["norm"], y)
    out = y @ params["w_down"]
    return (out, SLSTMState(*st)) if return_state else out


def slstm_decode(params, x, state: SLSTMState, num_heads: int):
    """x: (B, 1, d). Returns (out (B, 1, d), state), ``state`` overwritten
    in place with the new one."""
    d_inner = params["w_in"].shape[1] // 4
    xt = L.wide(x[:, 0] @ params["w_in"])
    gates = _slstm_gates(params, xt, state.h, num_heads, d_inner)
    st = _slstm_cell(gates, state, d_inner)
    for dst, src in zip(state, st):
        dst.copy_(src)
    y = L.rmsnorm(params["norm"], st.h[:, None, :].to(x.dtype))
    return y @ params["w_down"], state
