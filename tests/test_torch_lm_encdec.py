"""The Whisper-style encoder-decoder (whisper-small's smoke config) of the
port against the live JAX package on the CPU.

``encode`` and ``decode_train`` alone in fp32 on seeded frames: within
rtol = atol = 1e-5 (the encoder output) and 2e-3 (the logits, the bound of
``tests/test_decode_consistency.py``), the collected caches within 1e-4;
the sinusoid table within 1e-4. The whole model
(``_torch_lm.check_against_jax``) in fp32 and bf16 at
``test_torch_lm_models.py``'s tolerances; the port's
decode against its forward; the converter (``enc`` / ``dec`` stacks,
``pos_dec``'s 8192 rows); the serve CLI and ``Server.run`` (zeroed frames,
``Server._extra``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as JED
from repro.models.model import build_model as jbuild
import repro_torch.launch.serve as tserve
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import encdec as ED

import _torch_lm as H

pytestmark = pytest.mark.torch_port

ARCH = "whisper-small"


def test_sinusoid_matches_jax():
    """whisper-small's (1500, 768) table within atol 1e-4: the two
    libraries' f32 ``pow(10000, 2i / d)`` part by an ulp at 4 of 384
    frequencies, which at position 1499 moves the angle by ~1e-4 rad
    (measured: 3.1e-5); ``sin`` itself agrees within 6e-8."""
    np.testing.assert_allclose(ED._sinusoid(1500, 768).numpy(),
                               np.asarray(JED._sinusoid(1500, 768)),
                               rtol=0, atol=1e-4)


def test_encode_and_decode_train_match_jax():
    jcfg, cfg = H.pair(ARCH, "float32")
    params = jbuild(jcfg).init(jax.random.key(0))
    model = lm_params_from_jax(cfg, H.np_tree(params), device="cpu")
    toks, frames = H.inputs(cfg, H.S)
    want = jax.jit(JED.encode, static_argnums=1)(params, jcfg,
                                                 jnp.asarray(frames))
    got = ED.encode(model, cfg, torch.from_numpy(frames))
    assert got.shape == (H.B, cfg.num_audio_frames, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    jdec = jax.jit(JED.decode_train, static_argnums=1,
                   static_argnames="collect_cache")
    jl, ((jk, jv), (jxk, jxv)) = jdec(params, jcfg, jnp.asarray(toks), want,
                                      collect_cache=True)
    tl, ((k, v), (xk, xv)) = ED.decode_train(model, cfg,
                                             torch.from_numpy(toks), got,
                                             collect_cache=True)
    H.close(tl, jl, (2e-3, 2e-3))
    for t, j in ((k, jk), (v, jv), (xk, jxk), (xv, jxv)):
        assert t.shape == j.shape
        H.close(t, j, (1e-4, 1e-4))
    hidden, caches = ED.decode_train(model, cfg, torch.from_numpy(toks), got,
                                     return_hidden=True)
    assert caches is None and hidden.shape == (H.B, H.S, cfg.d_model)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_model_matches_jax(dtype):
    H.check_against_jax(ARCH, dtype)


def test_decode_matches_forward():
    model = H.check_decode_matches_forward(ARCH)
    assert model.pos_dec.shape[0] == ED.POS_DEC_ROWS == 8192


def test_converter_keeps_every_array_bit_for_bit():
    tree, cfg = H.check_converter_bits(ARCH, {"enc": 1, "dec": 1})
    assert tree["pos_dec"].shape == (8192, cfg.d_model)
    assert set(tree["dec"]) == {"ln1", "self", "ln_x", "cross", "ln2", "mlp"}


def test_converter_refuses_a_bad_encdec_tree():
    jcfg, cfg = H.pair(ARCH, "bfloat16")
    tree = H.np_tree(jbuild(jcfg).init(jax.random.key(0)))
    for edit in (lambda t: t.update(pos_dec=t["pos_dec"][:4096]),
                 lambda t: t["dec"].pop("ln_x"),
                 lambda t: t["enc"]["attn"].pop("bq"),
                 lambda t: t["dec"]["mlp"].update(
                     w_gate=t["dec"]["mlp"]["w_up"])):
        bad = jax.tree.map(lambda a: a, tree)
        edit(bad)
        with pytest.raises(ValueError, match="lm_params_from_jax"):
            lm_params_from_jax(cfg, bad, device="cpu")


def test_cli_matches_jax(capsys):
    H.check_cli(ARCH, capsys)


def test_server_run_matches_jax():
    H.check_server(ARCH)


def test_server_feeds_zeroed_frames():
    srv = tserve.Server(ARCH, device="cpu", batch_slots=1, max_len=16)
    extra = srv._extra(1)
    assert set(extra) == {"frames"}
    assert extra["frames"].shape == (1, srv.cfg.num_audio_frames,
                                     srv.cfg.d_model)
    assert extra["frames"].dtype == torch.bfloat16
    assert not bool(extra["frames"].any())
