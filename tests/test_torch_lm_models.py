"""The LM scaffold's dense decoders in the port against the live JAX package:
the configs and registry, the converter of the JAX params pytree, and the
whole model (``transformer_forward``, ``prefill`` with its cache,
``decode_step`` with its cache) for each of the four dense smoke configs
(internlm2-1.8b, qwen2.5-14b, command-r-35b, gemma3-27b) in fp32 and bf16,
on JAX's weights converted bit for bit. The other families' parity is in
``tests/test_torch_lm_{moe,mla,vlm,encdec,xlstm,mamba2}.py``; here they
build and run.

Tolerances (stated per dtype; JAX's forward runs its training attention,
``repro.models.flash``, the same blockwise softmax):

* fp32: logits rtol = atol = 2e-3 (the bound of JAX's own
  ``tests/test_decode_consistency.py``), caches 1e-4;
* bf16: logits rtol 3e-2 and atol 3e-2 of the largest |logit|, caches
  rtol 3e-2 and atol 0.1. Layer 0's k/v are bit-equal (the MLP's silu
  too: ``layers._silu`` rounds each step as XLA's compiled silu does);
  after it the two libraries' bf16 roundings part in places (XLA's fusions
  of the layer scan), one bf16 ulp is 2^-8 relative, and the differences
  grow by about one ulp of the largest values (~4) per layer: 0.03 after
  two layers, 0.07 after gemma3's eight. The untied head rounds its logits
  to bf16 before the f32 cast, so a logit near 0 carries the error of the
  largest ones (0.04 of logits up to 4.2 for internlm2's smoke config).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import transformer as JT
from repro.models.model import build_model as jbuild
import repro_torch.configs as tconfigs
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.model import build_model

from _torch_lm import OF_MAX, TOL

pytestmark = pytest.mark.torch_port

DENSE = ("internlm2-1.8b", "qwen2.5-14b", "command-r-35b", "gemma3-27b")
FAMILIES = ("granite-moe-3b-a800m", "deepseek-v2-lite-16b",
            "llama-3.2-vision-11b", "whisper-small", "xlstm-1.3b",
            "zamba2-2.7b")
B, S = 2, 24


def _pair(arch, dtype):
    """(JAX cfg, port cfg) of the smoke config in ``dtype``."""
    return (jconfigs.get_smoke_config(arch).scaled(dtype=dtype),
            tconfigs.get_smoke_config(arch).scaled(dtype=dtype))


def _tree(jcfg, seed=0):
    params = jbuild(jcfg).init(jax.random.key(seed))
    return params, jax.tree.map(np.asarray, params)


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.float().numpy()


def _close(got, want, tol, of_max=False):
    """``tol`` = (rtol, atol); ``of_max``: atol is a fraction of the
    largest |want|."""
    rtol, atol = tol
    want = _f32(want)
    if of_max:
        atol *= float(np.abs(want).max())
    np.testing.assert_allclose(_f32(got), want, rtol=rtol, atol=atol)


# ----------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_configs_equal_jax(arch):
    assert tconfigs.ARCH_NAMES == jconfigs.ARCH_NAMES
    for get in ("get_config", "get_smoke_config"):
        got = getattr(tconfigs, get)(arch)
        want = getattr(jconfigs, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.layer_windows(), got.layer_thetas(),
                got.resolved_head_dim) == (want.layer_windows(),
                                           want.layer_thetas(),
                                           want.resolved_head_dim)


def test_shapes_and_cells_equal_jax():
    from repro.configs import base as jbase
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    assert tconfigs.LONG_CONTEXT_OK == jbase.LONG_CONTEXT_OK
    got = [(a, s.name, ok, r) for a, s, ok, r in tconfigs.all_cells()]
    want = [(a, s.name, ok, r) for a, s, ok, r in jconfigs.all_cells()]
    assert got == want and len(got) == 40
    assert set(tconfigs.list_configs()) == set(jconfigs.ARCH_NAMES)
    with pytest.raises(KeyError):
        tconfigs.get_config("gpt-2")


# --------------------------------------------------------------- converter

@pytest.mark.parametrize("arch", DENSE)
def test_converter_keeps_every_array_bit_for_bit(arch):
    jcfg, cfg = _pair(arch, "bfloat16")
    _, tree = _tree(jcfg)
    model = lm_params_from_jax(cfg, tree, device="cpu")
    sd = model.state_dict()
    layers = tree["layers"]
    for i in range(cfg.num_layers):
        for grp, leaves in layers.items():
            for name, arr in leaves.items():
                t = sd[f"layers.{i}.{grp}.{name}"]
                assert str(t.dtype).endswith(arr.dtype.name)
                bits = np.int16 if arr.dtype.name == "bfloat16" else np.int32
                np.testing.assert_array_equal(
                    t.view(torch.int16 if bits is np.int16 else torch.int32)
                    .numpy(), arr[i].view(bits))
    np.testing.assert_array_equal(model.embed.view(torch.int16).numpy(),
                                  tree["embed"].view(np.int16))
    assert ("lm_head" in sd) == (not cfg.tie_embeddings)
    assert not any(p.requires_grad for p in model.parameters())


def test_converter_refuses_a_bad_tree():
    jcfg, cfg = _pair("qwen2.5-14b", "float32")
    _, tree = _tree(jcfg)
    lm_params_from_jax(cfg, tree, device="cpu")  # the good tree passes

    def bad(edit):
        t = jax.tree.map(lambda a: a, tree)
        edit(t)
        with pytest.raises(ValueError, match="lm_params_from_jax"):
            lm_params_from_jax(cfg, t, device="cpu")

    bad(lambda t: t.pop("lm_head"))                                  # missing
    bad(lambda t: t["layers"]["attn"].pop("bq"))
    bad(lambda t: t.update(extra=np.zeros(3, np.float32)))           # extra
    bad(lambda t: t["layers"]["ffn"].update(w_x=t["layers"]["ffn"]["w_up"]))
    bad(lambda t: t.update(embed=t["embed"][:, :-1]))                # shape
    bad(lambda t: t["layers"]["attn"].update(
        wq=t["layers"]["attn"]["wq"][:1]))                           # layers
    bad(lambda t: t.update(embed=t["embed"].astype(np.float16)))     # dtype


# ------------------------------------------------------------ the slice

@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("arch", DENSE)
def test_forward_prefill_decode_match_jax(arch, dtype):
    """On JAX's weights: the teacher-forced logits on S + 1 tokens, the
    prefill's last-position logits and its cache padded to max_len, and one
    decode step's logits and cache."""
    jcfg, cfg = _pair(arch, dtype)
    params, tree = _tree(jcfg)
    model = lm_params_from_jax(cfg, tree, device="cpu")
    tol = TOL[dtype]
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S + 1),
                                             dtype=np.int32)
    tt = torch.from_numpy(toks)

    want, _, _ = JT.transformer_forward(params, jcfg, jnp.asarray(toks))
    got, _, _ = T.transformer_forward(model, cfg, tt)
    assert got.dtype == torch.float32 and got.shape == (B, S + 1,
                                                        cfg.vocab_size)
    _close(got, want, tol["logits"], OF_MAX[dtype])

    jm, tm = jbuild(jcfg), build_model(cfg)
    max_len = S + 4
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :S])},
                        max_len)
    tl, tc = tm.prefill(model, {"tokens": tt[:, :S]}, max_len)
    _close(tl, jl, tol["logits"], OF_MAX[dtype])
    for name in ("k", "v"):
        assert tc[name].shape == jc[name].shape
        assert str(tc[name].dtype).endswith(jc[name].dtype.name)
        _close(tc[name], jc[name], tol["cache"])
        assert float(tc[name][:, :, S:].abs().max()) == 0.0

    jl, jc = jm.decode_step(params, jnp.asarray(toks[:, S]), jc, S)
    tl, tc = tm.decode_step(model, tt[:, S], tc, S)
    _close(tl, jl, tol["logits"], OF_MAX[dtype])
    for name in ("k", "v"):
        _close(tc[name], jc[name], tol["cache"])


def test_head_matrix_and_init():
    for arch in DENSE:
        cfg = tconfigs.get_smoke_config(arch)
        m = build_model(cfg).init(0, "cpu")
        h = T.head_matrix(m, cfg)
        assert h.shape == (cfg.vocab_size, cfg.d_model)
        assert (h.data_ptr() == m.embed.data_ptr()) == cfg.tie_embeddings
        again = build_model(cfg).init(torch.Generator().manual_seed(0))
        assert all(torch.equal(a, b) for a, b in
                   zip(m.state_dict().values(), again.state_dict().values()))
        assert m.embed.dtype == torch.bfloat16
        assert m.layers[0]["ln1"]["scale"].dtype == torch.float32
        cache = build_model(cfg).init_cache(3, 16, device="cpu")
        assert cache["k"].shape == (cfg.num_layers, 3, 16, cfg.num_kv_heads,
                                    cfg.resolved_head_dim)


def test_init_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get_smoke_config("internlm2-1.8b")
    for fn in (lambda: build_model(cfg).init(0),
               lambda: build_model(cfg).init_cache(3, 16),
               lambda: T.init_kv_cache(cfg, 3, 16),
               lambda: T.transformer_init(None, cfg),
               lambda: L.rmsnorm_init(8)):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()
    # a generator on the CPU (or an explicit device) asks for the CPU
    m = T.transformer_init(torch.Generator().manual_seed(0), cfg)
    assert {p.device.type for p in m.parameters()} == {"cpu"}
    assert not any(p.requires_grad for p in m.parameters())


# ------------------------------------------------------- other families

def test_unknown_family_raises():
    cfg = tconfigs.get_smoke_config("internlm2-1.8b").scaled(family="rnn")
    with pytest.raises(ValueError, match="unknown family"):
        build_model(cfg)


@pytest.mark.parametrize("arch", FAMILIES)
def test_other_families_build_and_run_on_cpu(arch):
    """MoE, MLA, VLM, enc-dec, xLSTM and the hybrid: ``build_model``
    builds them, and on the CPU when asked they prefill and decode (weights
    from seed 0; the family's stub input zeroed, as the server feeds it),
    the prefill's cache in ``init_cache``'s shapes and dtypes."""
    cfg = tconfigs.get_smoke_config(arch)
    m = build_model(cfg)
    params = m.init(0, "cpu")
    assert {p.device.type for p in params.parameters()} == {"cpu"}
    assert not any(p.requires_grad for p in params.parameters())
    batch = {"tokens": torch.arange(6)[None] % cfg.vocab_size}
    if cfg.family == "vlm":
        batch["image_embed"] = torch.zeros(
            1, cfg.num_image_tokens, cfg.d_model, dtype=torch.bfloat16)
    if cfg.family == "audio":
        batch["frames"] = torch.zeros(1, cfg.num_audio_frames, cfg.d_model,
                                      dtype=torch.bfloat16)
    logits, cache = m.prefill(params, batch, 10)
    empty = m.init_cache(1, 10, device="cpu")
    got, want = jax.tree.leaves(cache), jax.tree.leaves(empty)
    assert jax.tree.structure(cache) == jax.tree.structure(empty)
    assert all(a.shape == b.shape and a.dtype == b.dtype
               for a, b in zip(got, want))
    for pos in (6, 7):
        logits, cache = m.decode_step(params, torch.argmax(logits, -1),
                                      cache, pos, batch=batch)
        assert logits.shape == (1, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all())
