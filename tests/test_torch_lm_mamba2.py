"""Mamba2 and the Zamba2 hybrid (zamba2-2.7b's smoke config: 2 groups of 3
Mamba2 blocks with one shared attention + MLP block, d 64, SSD state 16,
head_dim 16, chunk 16, conv window 4) in the port against the live JAX
package on the CPU.

``mamba2_apply`` alone, fp32, at S in {1, 2, 3, 4, 15, 16, 17, 33}
(around the conv window K - 1 = 3 and the chunk of 16: one chunk, whole
chunks, a ragged last chunk whose padded steps have dt = 0 exactly), its
output and final state (h, and the pre-conv tail zero-padded in front when
S < K - 1) within rtol = atol = 1e-5, then one ``mamba2_decode`` step from
that state. The whole model on JAX's weights converted bit for bit
(``_torch_lm.check_recurrent_against_jax``): the forward, the prefill and
11 decode steps at batch 1 and 3 against one JAX run at batch 3 (batch 1
reads its first row), logits and every state (the Mamba2 states, the
shared block's K/V) at every step, at ``_torch_lm.TOL``. In
bf16 JAX runs op by op (``jax.disable_jit()``): its compiled scans part
from its op-by-op values by more than the bound (1.12x at a decode step,
batch 3), the port from the op-by-op run by 0.33x of it. Then the port's
decode against its own forward across chunks, the per-group K/V writes,
the converter, ``Server.run`` and the CLI against JAX's, and
``embed_sequences``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as JM2
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import mamba2 as M2
from repro_torch.models.model import build_model

import _torch_lm as H

pytestmark = pytest.mark.torch_port

ARCH = "zamba2-2.7b"
STACKS = {"mamba": 2, "mln": 2}


@pytest.fixture(scope="module")
def weights():
    """{dtype: (JAX cfg, port cfg, JAX params, port model)}, built once."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        jcfg, cfg = H.pair(ARCH, dtype)
        params = H.jax_params(jcfg)
        out[dtype] = (jcfg, cfg, params, lm_params_from_jax(
            cfg, H.np_tree(params), device="cpu"))
    return out


@pytest.fixture(scope="module")
def jax_runs(weights):
    """JAX's run of the whole model in a dtype (in bf16 op by op), made
    once at ``_torch_lm.RECURRENT_BATCH`` rows: each batch size's case
    reads its first rows."""
    runs = {}

    def run(dtype):
        if dtype not in runs:
            jcfg, _, params, _ = weights[dtype]
            runs[dtype] = H.jax_recurrent_run(jcfg, params,
                                              dtype == "bfloat16")
        return runs[dtype]
    return run


# ------------------------------------------------------------------ block

@pytest.mark.parametrize("s", (1, 2, 3, 4, 15, 16, 17, 33))
def test_mamba2_apply_and_decode_match_jax(weights, s):
    """Group 1's block 2 on seeded inputs with its dt bias and decay moved
    off their zero init (so the padded steps' dt would not vanish by
    itself): the output and the final state, then one decode step."""
    jcfg, cfg, params, model = weights["float32"]
    jp = jax.tree.map(lambda a: a[1, 2], params["mamba"])
    rng = np.random.default_rng(s)
    heads = jp["A_log"].shape[0]
    jp["A_log"] = jnp.asarray(rng.standard_normal(heads), jnp.float32)
    jp["dt_bias"] = jnp.asarray(rng.standard_normal(heads), jnp.float32)
    tp = {k: v for k, v in model.mamba[1][2].named_parameters()}
    tp = {"norm": {"scale": tp.pop("norm.scale")}, **tp}
    tp["A_log"] = torch.tensor(np.asarray(jp["A_log"]))
    tp["dt_bias"] = torch.tensor(np.asarray(jp["dt_bias"]))
    x = rng.standard_normal((2, s + 1, cfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    want, jst = JM2.mamba2_apply(jp, jx[:, :s], jcfg.ssm, return_state=True)
    got, tst = M2.mamba2_apply(tp, tx[:, :s], cfg.ssm, return_state=True)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    for name, a, b in zip(M2.Mamba2State._fields, tst, jst):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **tol)
    K = cfg.ssm.d_conv
    if s < K - 1:
        assert float(tst.conv[:, :K - 1 - s].abs().max()) == 0.0
    want, jst = JM2.mamba2_decode(jp, jx[:, s:], jst, jcfg.ssm)
    got, tst = M2.mamba2_decode(tp, tx[:, s:], tst, cfg.ssm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    for name, a, b in zip(M2.Mamba2State._fields, tst, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **tol)


@pytest.mark.parametrize("s", (1, 2))
def test_pre_conv_tail_of_a_short_prompt(weights, s):
    """S < K - 1: the tail is the S pre-conv rows, re-projected from x."""
    jcfg, cfg, params, model = weights["bfloat16"]
    jp = jax.tree.map(lambda a: a[0, 1], params["mamba"])
    tp = model.mamba[0][1]
    x = np.random.default_rng(9).standard_normal((3, s, cfg.d_model))
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    d_inner, _, conv_dim = M2._dims(cfg.d_model, cfg.ssm)
    K, N = cfg.ssm.d_conv, cfg.ssm.d_state
    want = JM2._pre_conv_tail(jx, jp, d_inner, N, K, s)
    got = M2._pre_conv_tail(tx, tp, d_inner, N, K, s)
    assert got.shape == (3, s, conv_dim) == want.shape
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


# ------------------------------------------------------------ whole model

@pytest.mark.parametrize("batch", (1, 3))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_model_matches_jax(weights, jax_runs, dtype, batch):
    _, cfg, _, model = weights[dtype]
    H.check_recurrent_against_jax(cfg, model, jax_runs(dtype), batch)


def test_decode_matches_forward():
    """Prefill on 33 tokens (two whole chunks and a ragged one), then 3
    decode steps against the forward."""
    H.check_decode_matches_forward(ARCH, s=33, steps=3)


def test_decode_writes_each_groups_kv_in_place():
    """One decode step writes the new token's k / v into every group's
    slot of the cache tensors themselves, and updates the Mamba2 states."""
    cfg = H.pair(ARCH, "float32")[1]
    m = build_model(cfg)
    model = m.init(0, "cpu")
    toks = torch.arange(5)[None] % cfg.vocab_size
    _, cache = m.prefill(model, {"tokens": toks}, 8)
    ptrs = {k: cache[k].data_ptr() for k in ("k", "v")}
    h0 = cache["mamba"].h.clone()
    _, out = m.decode_step(model, torch.tensor([3]), cache, 5)
    assert out is cache
    assert {k: cache[k].data_ptr() for k in ("k", "v")} == ptrs
    for name in ("k", "v"):
        assert bool((cache[name][:, :, 5].abs().amax(dim=(1, 2, 3)) > 0)
                    .all()), name
        assert float(cache[name][:, :, 6:].abs().max()) == 0.0
    assert not torch.equal(cache["mamba"].h, h0)


def test_converter_keeps_bits_and_refuses_a_bad_tree():
    tree, cfg = H.check_converter_bits(ARCH, STACKS)

    def bad(edit):
        t = jax.tree.map(lambda a: a, tree)
        edit(t)
        with pytest.raises(ValueError, match="lm_params_from_jax"):
            lm_params_from_jax(cfg, t, device="cpu")

    bad(lambda t: t["shared_attn"]["mlp"].pop("w_gate"))         # missing
    bad(lambda t: t["mamba"].update(                             # dtype
        A_log=t["mamba"]["A_log"].astype(jnp.bfloat16)))
    bad(lambda t: t.update(mln=jax.tree.map(lambda a: a[:, :2],  # stacking
                                            t["mln"])))


def test_server_matches_jax():
    H.check_server(ARCH)


def test_cli_matches_jax(capsys):
    H.check_cli(ARCH, capsys)


def test_embed_sequences_matches_jax(weights):
    """fp32, 3 sequences of 7 tokens, within rtol = atol = 2e-3."""
    jex, tex = H.example("embedding_medoid"), H.example(
        "embedding_medoid_torch")
    jcfg, cfg, params, model = weights["float32"]
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (3, 7),
                                             dtype=np.int32)
    want = np.asarray(jex.embed_sequences(jcfg, params, jnp.asarray(toks)))
    got = tex.embed_sequences(cfg, model, torch.from_numpy(toks))
    assert got.shape == (3, cfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
