"""The LM scaffold's building blocks in the port against the live JAX package:
``models/layers.py`` (norms, RoPE, MLPs, the tied unembedding) and
``models/attention.py`` (the blockwise flash attention's inference branch,
the decode attention, the GQA projections). Same numpy inputs, made from a
seed, through both packages on the CPU, in fp32.

Tolerance: rtol 1e-5 and atol 1e-5 on every value (fp32 on both sides, sums
and transcendentals in each library's own order), on values of order 1.

The attention cases reach the block loop's bounds: several query and KV
blocks (small ``block_q`` / ``block_kv``), Sq and Skv not block multiples,
``q_offset`` > 0, windows 0 and 8 (a window smaller than a block and across
blocks), and num_kv_heads 1 and 2 under 4 and 8 heads, so that query head h
must read KV head h // rep (a grouping by h % KV differs once KV > 1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro.models import layers as JL
from repro_torch.models import attention as A
from repro_torch.models import layers as L

pytestmark = pytest.mark.torch_port

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


@pytest.mark.parametrize("shape", ((3, 64), (2, 5, 48)))
def test_norms(shape):
    x = _np(1, *shape, scale=3.0)
    scale, bias = _np(2, shape[-1]), _np(3, shape[-1])
    _close(L.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x)),
           JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))
    p = {"scale": scale, "bias": bias}
    _close(L.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x)),
           JL.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x)))


def test_rmsnorm_keeps_bf16_and_computes_in_f32():
    x = _np(4, 4, 32, scale=5.0)
    got = L.rmsnorm({"scale": torch.ones(32)},
                    torch.from_numpy(x).bfloat16())
    want = JL.rmsnorm({"scale": jnp.ones(32)}, jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of the same f32 value on both sides
    _close(got, want.astype(jnp.float32), rtol=8e-3, atol=0)


@pytest.mark.parametrize("theta", (1e4, 1e6))
@pytest.mark.parametrize("hd", (16, 128))
def test_rope(theta, hd):
    x = _np(5, 2, 9, 3, hd)
    pos = np.array([np.arange(9), np.arange(100, 109)], dtype=np.int32)
    _close(L.rope_freqs(hd, theta), JL.rope_freqs(hd, theta), rtol=1e-6,
           atol=0)
    _close(L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


def test_rope_is_split_half():
    """Position 1 rotates the pair (x[i], x[i + hd/2]), not (x[2i],
    x[2i + 1])."""
    hd = 8
    x = torch.zeros(1, 1, 1, hd)
    x[..., 0] = 1.0
    out = L.apply_rope(x, torch.ones(1, 1, dtype=torch.int64), 1e4)
    assert torch.allclose(out[0, 0, 0, [0, hd // 2]],
                          torch.tensor([np.cos(1.0), np.sin(1.0)],
                                       dtype=torch.float32))
    assert float(out[0, 0, 0, 1].abs()) == 0.0


@pytest.mark.parametrize("act, gated", (("silu", True), ("gelu", False),
                                        ("gelu", True)))
def test_mlp(act, gated):
    d, f = 32, 80
    x = _np(6, 2, 7, d)
    p = {"w_up": _np(7, d, f, scale=d ** -0.5),
         "w_down": _np(8, f, d, scale=f ** -0.5)}
    if gated:
        p["w_gate"] = _np(9, d, f, scale=d ** -0.5)
    _close(L.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), act=act, gated=gated),
           JL.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), act=act, gated=gated))


def test_unembed_is_f32():
    e, x = _np(10, 50, 16, scale=0.02), _np(11, 3, 16)
    et, xt = torch.from_numpy(e).bfloat16(), torch.from_numpy(x).bfloat16()
    got = L.unembed(et, xt)
    want = JL.unembed(jnp.asarray(e, jnp.bfloat16),
                      jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want)


# (B, Sq, H, KV, Dh, block_q, block_kv, q_offset)
ATTN_CASES = (
    (2, 37, 4, 2, 16, 8, 16, 0),      # Sq, Skv not block multiples
    (1, 40, 8, 2, 8, 16, 8, 0),       # several blocks each way
    (2, 24, 4, 1, 16, 512, 1024, 0),  # the defaults: one block
    (1, 13, 8, 1, 8, 4, 8, 11),       # q_offset > 0 (keys 0..23)
    (2, 33, 4, 2, 16, 8, 8, 5),
)


@pytest.mark.parametrize("window", (0, 8))
@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention(case, window):
    B, Sq, H, KV, Dh, bq, bkv, off = case
    Skv = Sq + off
    q, k, v = (_np(12, B, Sq, H, Dh), _np(13, B, Skv, KV, Dh),
               _np(14, B, Skv, KV, Dh))
    kw = dict(causal=True, window=window, q_offset=off, block_q=bq,
              block_kv=bkv)
    got = A.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), **kw)
    want = JA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              **kw)
    _close(got, want)


def test_flash_attention_groups_heads_by_h_div_rep():
    """With KV = 2 and rep = 2, head 1 reads KV head 0: a KV head 1 that is
    all zeros in v leaves heads 0 and 1 untouched and zeroes heads 2, 3."""
    q, k = _np(15, 1, 6, 4, 8), _np(16, 1, 6, 2, 8)
    v = _np(17, 1, 6, 2, 8)
    v[:, :, 1] = 0.0
    out = A.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), block_q=4, block_kv=4)
    assert float(out[:, :, 2:].abs().max()) == 0.0
    assert float(out[:, :, :2].abs().min(dim=-1).values.min()) > 0.0


def test_flash_attention_non_causal_and_training_branch():
    q, k, v = _np(18, 1, 9, 4, 8), _np(19, 1, 11, 2, 8), _np(20, 1, 11, 2, 8)
    kw = dict(causal=False, block_q=4, block_kv=4)
    _close(A.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), **kw),
           JA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              **kw))
    # the training branch (FlashTrain) gives JAX's training branch's values
    _close(A.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), differentiable=True, **kw),
           JA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              differentiable=True, **kw))


@pytest.mark.parametrize("window", (0, 8))
@pytest.mark.parametrize("H, KV", ((4, 1), (4, 2), (8, 2)))
@pytest.mark.parametrize("per_batch", (False, True))
def test_decode_attention(H, KV, window, per_batch):
    B, Smax, Dh = 2, 24, 16
    q = _np(21, B, H, Dh)
    ck, cv = _np(22, B, Smax, KV, Dh), _np(23, B, Smax, KV, Dh)
    pos = np.array([13, 20], np.int32) if per_batch else 17
    got = A.decode_attention(torch.from_numpy(q), torch.from_numpy(ck),
                             torch.from_numpy(cv),
                             torch.from_numpy(pos) if per_batch else pos,
                             window=window)
    want = JA.decode_attention(jnp.asarray(q), jnp.asarray(ck),
                               jnp.asarray(cv), jnp.asarray(pos),
                               window=window)
    _close(got, want)


def _attn_params(seed, d, H, KV, Dh, bias):
    p = {"wq": _np(seed, d, H * Dh, scale=d ** -0.5),
         "wk": _np(seed + 1, d, KV * Dh, scale=d ** -0.5),
         "wv": _np(seed + 2, d, KV * Dh, scale=d ** -0.5),
         "wo": _np(seed + 3, H * Dh, d, scale=(H * Dh) ** -0.5)}
    if bias:
        p.update(bq=_np(seed + 4, H * Dh), bk=_np(seed + 5, KV * Dh),
                 bv=_np(seed + 6, KV * Dh))
    return ({k: torch.from_numpy(v) for k, v in p.items()},
            {k: jnp.asarray(v) for k, v in p.items()})


@pytest.mark.parametrize("bias", (False, True))
@pytest.mark.parametrize("window", (0, 8))
def test_self_attention_prefill_and_decode(bias, window):
    """self_attn_apply on S tokens (out and the (k, v) cache), then
    self_attn_decode of one more token into a cache padded to Smax (out and
    the cache written at pos)."""
    d, H, KV, Dh, S, Smax = 32, 4, 2, 8, 19, 24
    tp, jp = _attn_params(30, d, H, KV, Dh, bias)
    kw = dict(num_heads=H, num_kv_heads=KV, head_dim=Dh, theta=1e4,
              window=window)
    x = _np(40, 2, S, d)
    out, (k, v) = A.self_attn_apply(tp, torch.from_numpy(x), **kw)
    jout, (jk, jv) = JA.self_attn_apply(jp, jnp.asarray(x), **kw)
    for g, w in ((out, jout), (k, jk), (v, jv)):
        _close(g, w)
    pad = ((0, 0), (0, Smax - S), (0, 0), (0, 0))
    ck = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, Smax - S))
    cv = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, Smax - S))
    xt = _np(41, 2, 1, d)
    out, ck, cv = A.self_attn_decode(tp, torch.from_numpy(xt), ck, cv, S,
                                     **kw)
    jout, jck, jcv = JA.self_attn_decode(jp, jnp.asarray(xt),
                                         jnp.pad(jk, pad), jnp.pad(jv, pad),
                                         S, **kw)
    for g, w in ((out, jout), (ck, jck), (cv, jcv)):
        _close(g, w)


def test_attn_init_shapes_and_scale():
    g = torch.Generator().manual_seed(0)
    p = A.attn_init(g, 256, 8, 2, 32, torch.bfloat16, qkv_bias=True)
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "wq": (256, 256), "wk": (256, 64), "wv": (256, 64), "wo": (256, 256),
        "bq": (256,), "bk": (64,), "bv": (64,)}
    assert all(v.dtype == torch.bfloat16 for v in p.values())
    assert abs(float(p["wq"].float().std()) - 256 ** -0.5) < 0.003
    assert float(p["bq"].abs().max()) == 0.0
    e = L.embed_init(g, 4096, 64, torch.float32)
    assert abs(float(e.std()) - 0.02) < 0.0005
