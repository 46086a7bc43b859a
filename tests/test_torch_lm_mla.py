"""Multi-head Latent Attention and the MLA + MoE decoder
(deepseek-v2-lite-16b's smoke config) of the port against the live JAX
package on the CPU.

``mla_prefill`` and ``mla_decode`` alone in fp32 on JAX's layer-0 weights:
outputs within rtol = atol = 1e-5, the compressed caches within 1e-4, the
decode's cache slot written in place and the rest untouched. The whole
model (``_torch_lm.check_against_jax``) in fp32 and bf16 at
``test_torch_lm_models.py``'s tolerances, the bf16 run against JAX op by
op (``eager_jax``: the compiled layer scan's roundings change a routing
choice and the capacity drops cascade, see ``_torch_lm``) on 6 tokens,
where capacity still drops choices; the port's
decode against its forward; the converter; the serve CLI and
``Server.run``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mla as JMLA
from repro.models.model import build_model as jbuild
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import mla as MLA

import _torch_lm as H

pytestmark = pytest.mark.torch_port

ARCH = "deepseek-v2-lite-16b"


def _layer0_attn(jcfg):
    attn = jbuild(jcfg).init(jax.random.key(0))["layers"]["attn"]
    jp = jax.tree.map(lambda a: a[0], attn)
    return jp, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)


def test_mla_prefill_and_decode_match_jax():
    jcfg, cfg = H.pair(ARCH, "float32")
    jp, tp = _layer0_attn(jcfg)
    B, S, Smax = 2, 11, 16
    kw = dict(num_heads=cfg.num_heads, theta=cfg.rope_theta)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jprefill = jax.jit(JMLA.mla_prefill, static_argnames=(
        "num_heads", "cfg", "theta", "q_offset"))
    for q_offset in (0, 3):
        want, (jckv, jkr) = jprefill(jp, jnp.asarray(x), cfg=jcfg.mla,
                                     q_offset=q_offset, **kw)
        got, (ckv, kr) = MLA.mla_prefill(tp, torch.from_numpy(x),
                                         cfg=cfg.mla, q_offset=q_offset, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(ckv.numpy(), np.asarray(jckv), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(kr.numpy(), np.asarray(jkr), rtol=1e-4,
                                   atol=1e-4)
    assert ckv.shape == (B, S, cfg.mla.kv_lora_rank)
    assert kr.shape == (B, S, cfg.mla.rope_head_dim)

    # decode at S on the prefill's cache padded to Smax
    jc = (jnp.pad(jckv, ((0, 0), (0, Smax - S), (0, 0))),
          jnp.pad(jkr, ((0, 0), (0, Smax - S), (0, 0))))
    tc = (torch.from_numpy(np.array(jc[0])), torch.from_numpy(np.array(jc[1])))
    before = [t.clone() for t in tc]
    xd = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    jdecode = jax.jit(JMLA.mla_decode,
                      static_argnames=("num_heads", "cfg", "theta"))
    want, jckv2, jkr2 = jdecode(jp, jnp.asarray(xd), *jc, S, cfg=jcfg.mla,
                                **kw)
    got, ckv2, kr2 = MLA.mla_decode(tp, torch.from_numpy(xd), *tc, S,
                                    cfg=cfg.mla, **kw)
    assert ckv2 is tc[0] and kr2 is tc[1]                  # in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for t, j, old in ((ckv2, jckv2, before[0]), (kr2, jkr2, before[1])):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-4)
        keep = torch.ones(Smax, dtype=torch.bool)
        keep[S] = False
        assert torch.equal(t[:, keep], old[:, keep])


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_model_matches_jax(dtype):
    if dtype == "float32":
        H.check_against_jax(ARCH, dtype)
    else:       # op-by-op JAX on a shorter sequence, still with drops
        assert H.check_against_jax(ARCH, dtype, eager_jax=True, s=5) > 0


def test_decode_matches_forward():
    model = H.check_decode_matches_forward(ARCH)
    assert "shared" in model.layers[0]["ffn"]
    assert model.layers[0]["ffn"]["router"].dtype == torch.float32


def test_converter_keeps_every_array_bit_for_bit():
    tree, cfg = H.check_converter_bits(ARCH, {"layers": 1})
    attn = tree["layers"]["attn"]
    assert set(attn) == {"wq", "w_dkv", "w_krope", "kv_norm", "w_uk", "w_uv",
                         "wo"}
    assert attn["kv_norm"]["scale"].dtype == np.float32
    assert set(tree["layers"]["ffn"]["shared"]) == {"w_gate", "w_up",
                                                    "w_down"}


def test_converter_refuses_a_bad_mla_tree():
    jcfg, cfg = H.pair(ARCH, "bfloat16")
    tree = H.np_tree(jbuild(jcfg).init(jax.random.key(0)))
    attn = tree["layers"]["attn"]
    for edit in (lambda a: a.pop("kv_norm"),
                 lambda a: a.update(w_uk=a["w_uv"][..., :-1]),
                 lambda a: a.update(wk=a["wq"])):
        bad = jax.tree.map(lambda a: a, tree)
        edit(bad["layers"]["attn"])
        with pytest.raises(ValueError, match="lm_params_from_jax"):
            lm_params_from_jax(cfg, bad, device="cpu")
    assert set(attn) == set(tree["layers"]["attn"])


def test_cli_matches_jax(capsys):
    H.check_cli(ARCH, capsys)


def test_server_run_matches_jax():
    H.check_server(ARCH)
