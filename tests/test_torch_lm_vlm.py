"""Cross attention and the VLM decoder (llama-3.2-vision-11b's smoke
config: 10 layers in 2 groups of 4 self layers and 1 cross layer) of the
port against the live JAX package on the CPU.

``cross_attn_apply`` / ``cross_kv`` alone in fp32 (with and without the
q/k/v biases, GQA): within rtol = atol = 1e-5. The whole model
(``_torch_lm.check_against_jax``) in fp32 and bf16 at
``test_torch_lm_models.py``'s tolerances, with the cross layers' gates set
to 0.5 in both trees (zero at init, which would leave the cross attention
out of every output; no JAX file changes); the port's decode against its
forward; the converter's doubly stacked ``groups.self``; the serve CLI and
``Server.run`` (zeroed image embeddings, ``Server._extra``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro.models.model import build_model as jbuild
import repro_torch.configs as tconfigs
import repro_torch.launch.serve as tserve
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import attention as A
from repro_torch.models import transformer as T

import _torch_lm as H

pytestmark = pytest.mark.torch_port

ARCH = "llama-3.2-vision-11b"


@pytest.mark.parametrize("bias", (False, True))
def test_cross_attention_matches_jax(bias):
    d, H_, KV, Dh, Skv = 32, 4, 2, 8, 20
    rng = np.random.default_rng(5)
    p = {name: rng.standard_normal(shape).astype(np.float32) * 0.3
         for name, shape in (("wq", (d, H_ * Dh)), ("wk", (d, KV * Dh)),
                             ("wv", (d, KV * Dh)), ("wo", (H_ * Dh, d)))}
    if bias:
        p.update(bq=rng.standard_normal(H_ * Dh).astype(np.float32),
                 bk=rng.standard_normal(KV * Dh).astype(np.float32),
                 bv=rng.standard_normal(KV * Dh).astype(np.float32))
    x = rng.standard_normal((2, 7, d)).astype(np.float32)
    src = rng.standard_normal((2, Skv, d)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    kw = dict(num_kv_heads=KV, head_dim=Dh)
    jk, jv = JA.cross_kv(jp, jnp.asarray(src), **kw)
    tk, tv = A.cross_kv(tp, torch.from_numpy(src), **kw)
    assert tk.shape == (2, Skv, KV, Dh)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    want = JA.cross_attn_apply(jp, jnp.asarray(x), jk, jv, num_heads=H_,
                               **kw)
    got = A.cross_attn_apply(tp, torch.from_numpy(x), tk, tv, num_heads=H_,
                             **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_model_matches_jax(dtype):
    H.check_against_jax(ARCH, dtype)


def test_decode_matches_forward():
    H.check_decode_matches_forward(ARCH)


def test_forward_needs_image_embed_and_gate_zero_drops_cross():
    cfg = tconfigs.get_smoke_config(ARCH).scaled(dtype="float32")
    model = T.transformer_init(torch.Generator().manual_seed(0), cfg)
    toks = torch.zeros(1, 5, dtype=torch.int64)
    with pytest.raises(ValueError, match="image_embed"):
        T.transformer_forward(model, cfg, toks)
    img = torch.randn(1, cfg.num_image_tokens, cfg.d_model,
                      generator=torch.Generator().manual_seed(1))
    # zero-initialised gates: the image does not reach the logits
    a = model(toks, image_embed=img)
    b = model(toks, image_embed=torch.zeros_like(img))
    assert torch.equal(a, b)
    for p in model.groups.cross:
        p.gate.fill_(H.VLM_GATE)
    assert not torch.equal(model(toks, image_embed=img), a)


def test_converter_keeps_every_array_bit_for_bit():
    tree, cfg = H.check_converter_bits(ARCH, {"groups.self": 2,
                                              "groups.cross": 1})
    per = cfg.cross_attn_every
    groups = cfg.num_layers // per
    assert tree["groups"]["self"]["attn"]["wq"].shape[:2] == (groups,
                                                             per - 1)
    assert tree["groups"]["cross"]["gate"].shape == (groups,)
    assert "img_proj" in tree


def test_converter_refuses_a_bad_vlm_tree():
    jcfg, cfg = H.pair(ARCH, "bfloat16")
    tree = H.np_tree(jbuild(jcfg).init(jax.random.key(0)))
    for edit in (lambda t: t.pop("img_proj"),
                 lambda t: t["groups"]["self"]["attn"].update(
                     wq=t["groups"]["self"]["attn"]["wq"][:, 0]),
                 lambda t: t["groups"]["cross"].update(
                     gate=t["groups"]["cross"]["gate"].astype(jnp.bfloat16)),
                 lambda t: t.update(layers=t.pop("groups"))):
        bad = jax.tree.map(lambda a: a, tree)
        edit(bad)
        with pytest.raises(ValueError, match="lm_params_from_jax"):
            lm_params_from_jax(cfg, bad, device="cpu")


def test_cli_matches_jax(capsys):
    H.check_cli(ARCH, capsys)


def test_server_run_matches_jax():
    H.check_server(ARCH)


def test_server_feeds_zeroed_images():
    srv = tserve.Server(ARCH, device="cpu", batch_slots=1, max_len=16)
    extra = srv._extra(2)
    img = extra["image_embed"]
    assert set(extra) == {"image_embed"}
    assert img.shape == (2, srv.cfg.num_image_tokens, srv.cfg.d_model)
    assert img.dtype == torch.bfloat16 and not bool(img.any())
