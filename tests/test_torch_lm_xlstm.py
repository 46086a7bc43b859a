"""xLSTM (xlstm-1.3b's smoke config: 2 groups of 3 mLSTM + 1 sLSTM, d 64,
4 heads) in the port against the live JAX package on the CPU.

The blocks alone, fp32, on seeded numpy inputs: ``_mlstm_parallel`` with
small blocks (37 steps in query blocks of 8 and KV blocks of 16, and the
other way round) against JAX's with the same blocks, within rtol = atol =
1e-5; ``_slstm_gates`` and ``_slstm_cell`` (the gate layout: the recurrent
term per head (B, H, 4, P) laid out gate-major before the flatten) within
1e-6. The whole model on JAX's weights converted bit for bit
(``_torch_lm.check_recurrent_against_jax``): the forward, the prefill and
11 decode steps at batch 1 and 3 against one JAX run at batch 3 (batch 1
reads its first row), logits and every state at every step, at
``_torch_lm.recurrent_tol`` (the module docstring of ``_torch_lm`` gives
the readings behind xLSTM's bounds). In bf16 JAX runs op by op
(``jax.disable_jit()``): its compiled scan parts from its own op-by-op
values by 27% of the largest logit over the 11 steps, the port from the
op-by-op run by 3.9%. Then the port's decode against its own forward
(also on a float64 copy, which computes every step in float64), the
converter, ``Server.run`` and the CLI against JAX's, and
``embed_sequences``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import xlstm as JX
import repro_torch.configs as tconfigs
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import recurrent as R
from repro_torch.models import xlstm as XL
from repro_torch.models.model import build_model, cache_leaves, weights_init

import _torch_lm as H

pytestmark = pytest.mark.torch_port

ARCH = "xlstm-1.3b"
STACKS = {"groups.mlstm": 2, "groups.mln": 2, "groups.slstm": 1,
          "groups.sln": 1}


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


# ------------------------------------------------------------------ blocks

@pytest.mark.parametrize("bq, bkv", ((8, 16), (16, 8)))
def test_mlstm_parallel_small_blocks(bq, bkv):
    """37 steps: several query and KV blocks, ragged last ones (padded
    keys at i = NEG_INF), fully masked KV blocks skipped by the port and
    scanned by JAX."""
    rng = np.random.default_rng(3)
    B, S, Hh, P = 2, 37, 3, 8
    q, k, v = (rng.standard_normal((B, S, Hh, P)).astype(np.float32)
               for _ in range(3))
    it = rng.standard_normal((B, S, Hh)).astype(np.float32)
    ft = (rng.standard_normal((B, S, Hh)) + 2.0).astype(np.float32)
    want = JX._mlstm_parallel(*map(jnp.asarray, (q, k, v, it, ft)),
                              block_q=bq, block_kv=bkv)
    got = XL._mlstm_parallel(*map(torch.from_numpy, (q, k, v, it, ft)),
                             block_q=bq, block_kv=bkv)
    assert got.dtype == torch.float32 and got.shape == (B, S, Hh, P)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    whole = XL._mlstm_parallel(*map(torch.from_numpy, (q, k, v, it, ft)))
    np.testing.assert_allclose(whole.numpy(), got.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_slstm_gates_and_cell():
    """Four heads of P = 5, batch 3; the state's stabiliser at NEG_INF in
    one row (a fresh state) and finite in the others."""
    rng = np.random.default_rng(4)
    B, Hh, P = 3, 4, 5
    d = Hh * P
    p = {"R": rng.standard_normal((Hh, P, 4 * P)).astype(np.float32),
         "b": rng.standard_normal(4 * d).astype(np.float32)}
    xt = rng.standard_normal((B, 4 * d)).astype(np.float32)
    st = [rng.standard_normal((B, d)).astype(np.float32) for _ in range(4)]
    st[1] = np.abs(st[1]) + 1.0                              # n >= 1
    st[3][0] = XL.NEG_INF
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    want = JX._slstm_gates(jp, jnp.asarray(xt), jnp.asarray(st[2]), Hh, d)
    got = XL._slstm_gates(tp, torch.from_numpy(xt), torch.from_numpy(st[2]),
                          Hh, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    jst = JX._slstm_cell(want, JX.SLSTMState(*map(jnp.asarray, st)), d)
    tst = XL._slstm_cell(got, XL.SLSTMState(*map(torch.from_numpy, st)), d)
    for name, a, b in zip(XL.SLSTMState._fields, tst, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    assert bool(torch.isfinite(torch.stack(list(tst))).all())


def _slstm_weights(rng, d, Hh):
    """{name: numpy array} of one sLSTM block, d_model ``d``, ``Hh``
    heads; the forget bias at the init's 3.0 and the rest seeded."""
    d_inner, P = XL.slstm_dims(d, Hh)
    f32 = np.float32
    b = rng.standard_normal(4 * d_inner).astype(f32)
    b[2 * d_inner:3 * d_inner] += 3.0
    return {"w_in": (rng.standard_normal((d, 4 * d_inner))
                     / np.sqrt(d)).astype(f32),
            "R": (rng.standard_normal((Hh, P, 4 * P))
                  / np.sqrt(P)).astype(f32),
            "b": b,
            "w_down": (rng.standard_normal((d_inner, d))
                       / np.sqrt(d_inner)).astype(f32),
            "norm": {"scale": (1.0 + 0.1 * rng.standard_normal(d_inner)
                               ).astype(f32)}}


def _torch_tree(p, dtype=torch.float32):
    return {k: _torch_tree(v, dtype) if isinstance(v, dict)
            else torch.from_numpy(v).to(dtype) for k, v in p.items()}


def test_slstm_apply_step_dispatches_at_most_20_ops():
    """aten ops dispatched by ``slstm_apply`` at S 24 less those at S 8,
    over the 16 steps between: the loop's ops a step (39 before the
    head-major layout, 18 with it)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    rng = np.random.default_rng(7)
    p = _torch_tree(_slstm_weights(rng, 64, 4))
    counts = {}
    for S in (8, 24):
        x = torch.from_numpy(rng.standard_normal((2, S, 64)).astype(
            np.float32))
        with torch.no_grad(), Count() as c:
            XL.slstm_apply(p, x, 4)
        counts[S] = c.n
    assert (counts[24] - counts[8]) / 16 <= 20, counts


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
def test_slstm_apply_and_state_match_jax_scan(dtype):
    """37 steps, batch 3, d 16 in 4 heads of P = 5: the output and the
    final c, n, h, m against JAX's ``slstm_apply`` and its scan of
    ``_slstm_gates`` / ``_slstm_cell`` on the same weights, within rtol =
    atol = 1e-5; the float64 copy (weights and input in float64, widened
    through ``layers.wide``) keeps every value in float64 and meets the
    same bound against JAX's fp32."""
    rng = np.random.default_rng(8)
    B, S, d, Hh = 3, 37, 16, 4
    d_inner, _ = XL.slstm_dims(d, Hh)
    p = _slstm_weights(rng, d, Hh)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    want = JX.slstm_apply(jp, jnp.asarray(x), Hh)
    xin = (jnp.asarray(x) @ jp["w_in"]).astype(jnp.float32)

    def step(st, xt):
        g = JX._slstm_gates(jp, xt, st.h, Hh, d_inner)
        st = JX._slstm_cell(g, st, d_inner)
        return st, None
    jst, _ = jax.lax.scan(step, JX.slstm_init_state(B, d, Hh),
                          xin.transpose(1, 0, 2))
    out, st = XL.slstm_apply(_torch_tree(p, dtype),
                             torch.from_numpy(x).to(dtype), Hh,
                             return_state=True)
    assert out.dtype == dtype and out.shape == (B, S, d)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for name, a, b in zip(XL.SLSTMState._fields, st, jst):
        assert a.dtype == dtype and a.shape == (B, d_inner), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_layout_and_init():
    """The pattern must be mLSTM runs then sLSTM; the weights keep the
    reference's dtypes (gates, R, b and the norms f32); the cache is the
    stacked zero state with the stabilisers at NEG_INF."""
    cfg = tconfigs.get_smoke_config(ARCH)
    assert R._xlstm_layout(cfg) == (2, 3)
    for bad in (("slstm", "mlstm"), ("mlstm", "slstm", "mlstm", "slstm")):
        with pytest.raises(ValueError, match="xlstm pattern"):
            R._xlstm_layout(cfg.scaled(block_pattern=bad))
    with pytest.raises(ValueError, match="tile"):
        R._xlstm_layout(cfg.scaled(num_layers=6))
    m = build_model(cfg)
    model = m.init(0, "cpu")
    pm, ps = model.groups.mlstm[1][2], model.groups.slstm[1]
    assert pm.w_q.dtype == torch.bfloat16
    assert {pm[n].dtype for n in ("w_i", "w_f", "b_i", "b_f")} == \
        {torch.float32}
    assert float(pm.b_f.min()) == 3.0
    d_inner, P = XL.slstm_dims(cfg.d_model, cfg.num_heads)
    assert ps.R.shape == (cfg.num_heads, P, 4 * P) and \
        ps.R.dtype == torch.float32
    assert XL.slstm_dims(2048, 4) == (2728, 682)        # xlstm-1.3b's
    cache = m.init_cache(3, 16, device="cpu")
    assert cache["mlstm"].C.shape == (2, 3, 3, cfg.num_heads, 32, 32)
    assert cache["slstm"].m.shape == (2, 3, d_inner)
    m0 = cache["mlstm"].m
    assert torch.equal(m0, torch.full_like(m0, XL.NEG_INF))
    assert not any(p.requires_grad for p in model.parameters())


# ------------------------------------------------------------ whole model

@pytest.mark.parametrize("batch", (1, 3))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_model_matches_jax(weights, jax_runs, dtype, batch):
    _, cfg, _, model = weights[dtype]
    H.check_recurrent_against_jax(cfg, model, jax_runs(dtype), batch)


def test_decode_matches_forward():
    """Prefill on 13 tokens, then 3 decode steps against the forward."""
    H.check_decode_matches_forward(ARCH, steps=3)


def test_float64_copy_computes_in_float64():
    """A float64 copy of the weights (as ``chip_smoke.py``'s full-depth
    check makes) keeps every step in float64: the logits and every state
    are float64, and decode agrees with the forward to within 1e-10 after
    a prefill of 37 tokens and 3 decode steps."""
    cfg = tconfigs.get_smoke_config(ARCH).scaled(dtype="float32")
    m = build_model(cfg)
    src = m.init(0, "cpu").state_dict()
    cfg64 = cfg.scaled(dtype="float64")
    model = weights_init(cfg64, None, "meta")
    model.load_state_dict({k: v.double() for k, v in src.items()},
                          assign=True)
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(2))
    full, _ = R.xlstm_forward(model, cfg64, toks)
    assert full.dtype == torch.float64
    lp, cache = m.prefill(model, {"tokens": toks[:, :37]}, 40)
    torch.testing.assert_close(lp, full[:, 36], rtol=1e-10, atol=1e-10)
    for pos in (37, 38, 39):
        ld, cache = m.decode_step(model, toks[:, pos], cache, pos)
        torch.testing.assert_close(ld, full[:, pos], rtol=1e-10, atol=1e-10)
    assert all(t.dtype == torch.float64 for _, t in cache_leaves(cache))


def test_converter_keeps_bits_and_refuses_a_bad_tree():
    tree, cfg = H.check_converter_bits(ARCH, STACKS)

    def bad(edit):
        t = jax.tree.map(lambda a: a, tree)
        edit(t)
        with pytest.raises(ValueError, match="lm_params_from_jax"):
            lm_params_from_jax(cfg, t, device="cpu")

    bad(lambda t: t["groups"]["slstm"].pop("R"))                 # missing
    bad(lambda t: t["groups"]["mlstm"].update(                   # dtype
        b_f=t["groups"]["mlstm"]["b_f"].astype(jnp.bfloat16)))
    bad(lambda t: t["groups"].update(                            # stacking
        sln=jax.tree.map(lambda a: a[:1], t["groups"]["sln"])))


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
