"""The LM serving path of the port against the live JAX package on the CPU:
``launch/serve.py`` (``Server.run`` and the CLI), ``examples/serve_lm_torch.py``
(the medoid sidecar) and ``examples/embedding_medoid_torch.py``
(``embed_sequences`` and the medoid of the embeddings; its MoE, VLM and
audio branches on the same inputs as JAX's).

``Server.run`` runs the four dense smoke configs in fp32 on JAX's weights
converted bit for bit, with the same prompts (the port's ``rng.randint`` is
bit-equal to ``jax.random.randint``): every request's greedy tokens, the
decode steps and the token count must be equal. Greedy tokens are compared
in fp32 only. ``embed_sequences``: fp32 within rtol = atol = 2e-3 (the
model-logit bound of ``tests/test_torch_lm_models.py``), bf16 within rtol
3e-2 and atol 3e-2 of the largest value; the medoid of the fp32 embeddings
must be JAX's.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.launch.serve as jserve
from repro.api import find_medoid as jfind_medoid
from repro.models.model import build_model as jbuild
import repro_torch.configs as tconfigs
import repro_torch.launch.serve as tserve
from repro_torch.api import find_medoid
from repro_torch.convert import lm_params_from_jax
from repro_torch.models.model import build_model
from repro_torch.engine import rng

from _torch_compare import torch_key
from _torch_lm import example as _example

pytestmark = pytest.mark.torch_port

DENSE = ("internlm2-1.8b", "qwen2.5-14b", "command-r-35b", "gemma3-27b")


def _weights(arch, dtype):
    jcfg = jconfigs.get_smoke_config(arch).scaled(dtype=dtype)
    cfg = tconfigs.get_smoke_config(arch).scaled(dtype=dtype)
    params = jbuild(jcfg).init(jax.random.key(0))
    return jcfg, cfg, params, lm_params_from_jax(
        cfg, jax.tree.map(np.asarray, params), device="cpu")


@pytest.mark.parametrize("arch", DENSE)
def test_server_run_matches_jax(arch):
    """5 requests through 2 slots (slots are reused), prompts of 9 tokens,
    up to 6 new tokens, max_len 14 (so some requests stop at the cache's
    end): the same tokens for every request, decode steps and tokens."""
    jcfg, cfg, params, model = _weights(arch, "float32")
    kw = dict(smoke=True, batch_slots=2, max_len=14)
    jsrv = jserve.Server(arch, **kw)
    jsrv.cfg, jsrv.model, jsrv.params = jcfg, jbuild(jcfg), params
    tsrv = tserve.Server(arch, device="cpu", **kw)
    tsrv.cfg, tsrv.model, tsrv.params = cfg, build_model(cfg), model

    key = jax.random.key(7)
    jprompts = [jax.random.randint(jax.random.fold_in(key, i), (9,), 0,
                                   cfg.vocab_size) for i in range(5)]
    tprompts = tserve.prompts(5, 9, cfg.vocab_size, "cpu")
    for jp, tp in zip(jprompts, tprompts):
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    jreqs = [jserve.Request(rid=i, prompt=p, max_new=6 if i != 3 else 3)
             for i, p in enumerate(jprompts)]
    treqs = [tserve.Request(rid=i, prompt=p, max_new=6 if i != 3 else 3)
             for i, p in enumerate(tprompts)]
    want, got = jsrv.run(jreqs), tsrv.run(treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert all(r.done for r in treqs)
    for k in ("requests", "decode_steps", "tokens"):
        assert got[k] == want[k], k
    assert set(got) == set(want)


def test_cli_matches_jax(capsys):
    flags = ["--arch", "internlm2-1.8b", "--smoke", "--requests", "3",
             "--max-new", "4"]
    tserve.main(["--device", "cpu"] + flags)
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jserve.main(flags)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want) == {"requests", "decode_steps", "wall_s",
                                     "tokens"}
    for k in ("requests", "decode_steps", "tokens"):
        assert got[k] == want[k], k


def test_cli_without_a_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--arch", "internlm2-1.8b", "--smoke"])


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_embed_sequences_matches_jax(dtype):
    """The mean of the f32 logits over positions, on 64 sequences of 12
    tokens (the example's draws); in fp32 the medoid of the embeddings (key
    2, 20 pulls per arm, l2) is JAX's."""
    jex, tex = _example("embedding_medoid"), _example("embedding_medoid_torch")
    jcfg, cfg, params, model = _weights("internlm2-1.8b", dtype)
    key = jax.random.key(1)
    want = jnp.concatenate([
        jex.embed_sequences(jcfg, params, jax.random.randint(
            jax.random.fold_in(key, i), (32, 12), 0, cfg.vocab_size))
        for i in range(2)])
    got = tex.embed_corpus(cfg, model, 64, 12, "cpu")
    assert got.dtype == torch.float32 and got.shape == (64, cfg.vocab_size)
    want = np.asarray(want)
    tol = (2e-3, 2e-3) if dtype == "float32" else \
        (3e-2, 3e-2 * float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=tol[0], atol=tol[1])
    if dtype == "float32":
        jres = jfind_medoid(want, jax.random.key(2), metric="l2",
                            budget_per_arm=20)
        tres = tex.representative(got)
        assert (tres.medoid, tres.pulls) == (int(jres.medoid), jres.pulls)
        assert find_medoid(got, torch_key(jax.random.key(2)), metric="l2",
                           budget_per_arm=20).medoid == tres.medoid


@pytest.mark.parametrize("arch", ("granite-moe-3b-a800m",
                                  "llama-3.2-vision-11b", "whisper-small"))
def test_embed_sequences_of_other_families_match_jax(arch):
    """The MoE, VLM and audio branches, fp32, on the same tokens and stub
    inputs (image embeddings, frames) within rtol = atol = 2e-3; the
    example's stub draws are JAX's up to erfinv's last bits."""
    jex, tex = _example("embedding_medoid"), _example("embedding_medoid_torch")
    jcfg, cfg, params, model = _weights(arch, "float32")
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (3, 7),
                                             dtype=np.int32)
    jkw = {}
    key = jax.random.fold_in(jax.random.key(1), 1000)
    if cfg.family == "audio":
        jkw["frames"] = jax.random.normal(
            key, (3, cfg.num_audio_frames, cfg.d_model))
    if cfg.family == "vlm":
        jkw["image_embed"] = jax.random.normal(
            key, (3, cfg.num_image_tokens, cfg.d_model))
    tkw = tex.stub_inputs(cfg, 0, 3, "cpu")
    assert set(tkw) == set(jkw)
    for name in tkw:
        np.testing.assert_allclose(tkw[name].numpy(), np.asarray(jkw[name]),
                                   rtol=1e-5, atol=1e-6)
    want = np.asarray(jex.embed_sequences(jcfg, params, jnp.asarray(toks),
                                          **jkw))
    got = tex.embed_sequences(cfg, model, torch.from_numpy(toks), **tkw)
    assert got.shape == (3, cfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)


def test_embedding_example_cluster_and_shards_on_cpu(capsys):
    """The example's main on the CPU with --cluster and --queries: every
    shard's representative is its exact medoid."""
    _example("embedding_medoid_torch").main(
        ["--cpu", "--num-seqs", "96", "--seq-len", "8", "--cluster", "3",
         "--queries", "4"])
    out = capsys.readouterr().out
    assert "3-medoid clustering" in out and "match: True" in out
    assert out.count("exact match: True") == 4


@pytest.mark.parametrize("backend", ("reference", "pallas_fused"))
def test_sidecar_matches_jax(backend):
    """``serve_medoid_queries``: B cosine queries in one dispatch, the same
    medoids as the JAX example's (its sets are ``normal`` draws, equal to
    JAX's up to erfinv's last bits)."""
    jex, tex = _example("serve_lm"), _example("serve_lm_torch")
    kw = dict(n=96, d=12, budget_per_arm=24, seed=3)
    want = jex.serve_medoid_queries(3, backend, **kw)
    got = tex.serve_medoid_queries(3, backend, device="cpu", **kw)
    assert got["medoids"] == want["medoids"]
    assert {k: got[k] for k in ("queries", "n", "d", "backend")} == \
        {k: want[k] for k in ("queries", "n", "d", "backend")}
    sets = rng.normal(rng.fold_in(rng.key(3), 1), (3, 96, 12))
    jsets = jax.random.normal(jax.random.fold_in(jax.random.key(3), 1),
                              (3, 96, 12))
    # erfinv's last bits: 5e-6 relative in the tails
    np.testing.assert_allclose(sets.numpy(), np.asarray(jsets), rtol=1e-5,
                               atol=1e-6)
