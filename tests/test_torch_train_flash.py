"""The training attention: ``repro_torch.models.flash.FlashTrain`` (a
``torch.autograd.Function`` whose backward recomputes each block) against
``jax.grad`` of ``repro.models.flash.flash_attention_trainable`` on the
same inputs, and against float64 autograd through a plain softmax
attention. Cases cover causal / non-causal, a sliding window, a query
offset, GQA with rep 1 and 2, a value width other than the key width
(MLA), and Sq, Skv that are not multiples of the (small) blocks, so the
padded queries and keys are exercised.

Tolerances: the output and dq, dk, dv agree with JAX's within rtol 1e-4
and atol 1e-5 of the largest |value| of each (both f32; the two packages
contract in their own orders), and with float64 autograd within rtol 1e-4
and atol 2e-5 of the largest |value|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.flash import flash_attention_trainable as jflash
from repro_torch.models import attention as A
from repro_torch.models.flash import flash_attention_trainable

pytestmark = pytest.mark.torch_port

JAX_TOL = (1e-4, 1e-5)
F64_TOL = (1e-4, 2e-5)

# name: (B, Sq, Skv, H, KV, Dh, Dv, causal, window, q_offset, bq, bkv)
CASES = {
    "causal_gqa2": (2, 37, 37, 4, 2, 16, 16, True, 0, 0, 8, 16),
    "causal_rep1": (1, 29, 29, 3, 3, 8, 8, True, 0, 0, 8, 8),
    "window": (2, 50, 50, 4, 2, 16, 16, True, 10, 0, 8, 16),
    "q_offset": (1, 20, 27, 4, 2, 8, 8, True, 0, 7, 8, 8),
    "window_q_offset": (1, 21, 40, 2, 1, 8, 8, True, 6, 19, 4, 8),
    "noncausal_pad": (2, 19, 45, 4, 4, 8, 8, False, 0, 0, 8, 16),
    "noncausal_window": (1, 24, 24, 4, 2, 8, 8, False, 5, 0, 8, 8),
    "mla_dv": (1, 33, 33, 4, 4, 24, 16, True, 0, 0, 16, 16),
}


def _inputs(case, seed=0):
    B, Sq, Skv, H, KV, Dh, Dv = case[:7]
    rs = np.random.RandomState(seed)
    q = rs.randn(B, Sq, H, Dh).astype(np.float32)
    k = rs.randn(B, Skv, KV, Dh).astype(np.float32)
    v = rs.randn(B, Skv, KV, Dv).astype(np.float32)
    cot = rs.randn(B, Sq, H, Dv).astype(np.float32)
    return q, k, v, cot


def _close(got, want, tol):
    want = np.asarray(want, np.float64)
    rtol, atol = tol
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=atol * np.abs(want).max())


def _port(case, q, k, v, cot):
    causal, window, q_offset, bq, bkv = case[7:]
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = flash_attention_trainable(qt, kt, vt, causal=causal, window=window,
                                    q_offset=q_offset, block_q=bq,
                                    block_kv=bkv)
    (out * torch.tensor(cot)).sum().backward()
    return out.detach().numpy(), qt.grad.numpy(), kt.grad.numpy(), \
        vt.grad.numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_flash_train_matches_jax_grad(name):
    case = CASES[name]
    causal, window, q_offset, bq, bkv = case[7:]
    q, k, v, cot = _inputs(case)

    def f(q, k, v):
        return jflash(q, k, v, causal=causal, window=window,
                      q_offset=q_offset, block_q=bq, block_kv=bkv)

    jout, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(cot))
    got = _port(case, q, k, v, cot)
    for g, w in zip(got, (jout, *jgrads)):
        _close(g, w, JAX_TOL)


def _plain64(q, k, v, causal, window, q_offset):
    """Softmax attention in float64 with the reference's masks."""
    B, Sq, H, Dh = q.shape
    KV = k.shape[2]
    rep = H // KV
    kk = k.repeat_interleave(rep, dim=2)          # head h reads h // rep
    vv = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) / np.sqrt(Dh)
    qp = q_offset + torch.arange(Sq)[:, None]
    kp = torch.arange(k.shape[1])[None, :]
    mask = torch.ones(Sq, k.shape[1], dtype=torch.bool)
    if causal:
        mask &= qp >= kp
    if window > 0:
        mask &= (qp - kp) < window
    s = s.masked_fill(~mask, -torch.inf)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vv)


@pytest.mark.parametrize("name", list(CASES))
def test_flash_train_matches_float64_autograd(name):
    case = CASES[name]
    causal, window, q_offset = case[7:10]
    q, k, v, cot = _inputs(case, seed=1)
    got = _port(case, q, k, v, cot)
    q64, k64, v64 = (torch.tensor(a, dtype=torch.float64, requires_grad=True)
                     for a in (q, k, v))
    out = _plain64(q64, k64, v64, causal, window, q_offset)
    (out * torch.tensor(cot, dtype=torch.float64)).sum().backward()
    for g, w in zip(got, (out.detach(), q64.grad, k64.grad, v64.grad)):
        _close(g, w.numpy(), F64_TOL)


def _graph(fn) -> set:
    """The names of the autograd nodes reachable from ``fn``."""
    seen, todo = set(), [fn]
    while todo:
        f = todo.pop()
        if f is None or f.name() in seen:
            continue
        seen.add(f.name())
        todo += [g for g, _ in f.next_functions]
    return seen


def test_differentiable_flash_attention_is_the_training_path():
    """``flash_attention(differentiable=True)`` runs FlashTrain: the
    inference loop's values, and gradients that reach q, k and v."""
    q, k, v, _ = _inputs(CASES["window"])
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    got = A.flash_attention(qt, kt, vt, window=10, block_q=8, block_kv=16,
                            differentiable=True)
    assert "FlashTrainBackward" in _graph(got.grad_fn)
    with torch.no_grad():
        want = A.flash_attention(qt, kt, vt, window=10, block_q=8,
                                 block_kv=16)
    torch.testing.assert_close(got.detach(), want, rtol=0, atol=0)
    got.sum().backward()
    assert all(t.grad is not None and bool(t.grad.abs().sum() > 0)
               for t in (qt, kt, vt))


def test_forward_saves_no_probability_block():
    """The autograd graph holds q, k, v, the f32 output and the row
    statistics only: no (bq, bkv) block of probabilities."""
    B, S, H, KV, Dh = 1, 64, 2, 1, 8
    q, k, v = (torch.randn(B, S, n, Dh, requires_grad=True)
               for n in (H, KV, KV))
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        flash_attention_trainable(q, k, v, block_q=16, block_kv=16)
    assert sorted(saved) == sorted([(B, S, H, Dh), (B, S, KV, Dh),
                                    (B, S, KV, Dh), (B, S, H, Dh),
                                    (S // 16, B, KV, H // KV, 16)]), saved
