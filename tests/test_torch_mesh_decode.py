"""The port's decode step on meshes that cut heads, whisper's positions past
its table, and the microbatch split on data shards, against the JAX
package's one-device results.

* (a) whisper's smoke config on one device, in float32: the decoder's
  position table has ``POS_DEC_ROWS`` (8192) rows, and JAX's gather clamps
  an index past its end to the last row. The port's ``decode_step`` at
  positions 8191, 8192 and 9000 on a cache of ``max_len`` 9001 equals
  JAX's ``encdec_decode_step`` on the weights ``convert.lm_params_from_jax``
  carries across, within ``TOL``'s float32 logits bound (rtol = atol =
  2e-3), and the rows its prefill reads for an 8200-token prompt are
  JAX's, bit for bit.
* (b) On 4 gloo ranks, a (2, 2) ("data", "model") mesh under the
  decode_32k rules (``partition.param_specs``, ``cache_specs_tree``: the
  batch over the data axis, the cache's sequence over the model axis), two
  decode steps after a prefill of smoke gemma3 (2 KV heads divide the model
  axis, rep 2, as gemma3-27b's 16 do on 16 ranks), zamba2 (4 KV heads, rep
  1, as its 32; one group of 3 layers) and xLSTM scaled to 1 head (cut in
  two by the model axis, as xlstm-1.3b's 4 heads are cut on 16 ranks; one
  group of 4 layers, mLSTM and sLSTM). Their logits equal the
  port's unsharded steps' and JAX's one-device ``decode_step``'s (float32;
  ``TOL``, xLSTM's ``recurrent_tol``).
* (c) One sharded train step of the float32 smoke internlm2 with 2
  microbatches on a (4, 1) mesh, whose 4 data shards of the batch of 8 the
  2 microbatches of 4 rows cut; one of smoke xLSTM scaled to 2 heads and
  one group of 4 layers on a (1, 4) mesh (each head cut in two); and one
  of smoke internlm2 with 2 microbatches on a (2, 2) mesh laid out as the
  dry run lays out a (2, 16, 16) train cell (``pure_fsdp_specs``, no
  tensor parallelism, the sequence over the model axis: each rank's
  products and queries on its own rows). The loss and grad norm equal JAX's jitted one-device step at
  the same microbatch count within ``LOSS_RTOL`` (1e-5), every updated
  weight is within 2 x the step's learning rate of JAX's
  (``test_torch_mesh_train.py``'s bound; after one AdamW step from zero
  moments any two updates are that close), and every leaf's first moment,
  (1 - b1) x its clipped gradient, equals JAX's within ``GRAD_TOL`` (rtol
  2e-3, atol 2e-4 of the largest), which a flipped, zeroed or misplaced
  gradient fails.

The ranks run ``_torch_mesh_decode_worker.py``, one OpenMP thread each, in
processes of their own, started first; each case starts there as soon as
this process has written its inputs, and this process computes JAX's steps
and the unsharded ones meanwhile."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import TOL, close, jax_params, np_tree, pair, recurrent_tol
from _torch_train import GRAD_TOL, LOSS_RTOL
from repro.configs.base import InputShape as JShape
from repro.data.pipeline import batch_at as jbatch_at
from repro.models import encdec as JED
from repro.models.model import build_model as jbuild
from repro.train import train_step as jts
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import encdec as ED
from repro_torch.models.model import build_model
from repro_torch.optim import schedule

pytestmark = pytest.mark.torch_port

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(TESTS), "src")
TIMEOUT_S = 150
F32 = "float32"
FP32_LOGITS = TOL[F32]["logits"]

# (a)
WHISPER_POS = (8191, 8192, 9000)
WHISPER_MAX_LEN = 9001
LONG_PROMPT = 8200

# (b): arch -> .scaled() overrides (one group of the recurrent families'
# layers); B rows, a prompt of S0, two steps
DECODE = {"gemma3-27b": {},
          "zamba2-2.7b": dict(num_layers=3),
          "xlstm-1.3b": dict(num_heads=1, num_kv_heads=1, num_layers=4)}
DB, S0, STEPS, MAX_LEN = 4, 13, 2, 16

# (c): case -> (arch, mesh, .scaled() overrides, microbatches, layout)
TRAIN = {"internlm2-1.8b": ("internlm2-1.8b", (4, 1), {}, 2, "tp"),
         "xlstm-1.3b": ("xlstm-1.3b", (1, 4),
                        dict(num_heads=2, num_kv_heads=2, num_layers=4), 1,
                        "tp"),
         "internlm2-1.8b-fsdp-seq": ("internlm2-1.8b", (2, 2), {}, 2,
                                     "fsdp_seq")}
TB, TS = 8, 32
TCFG = dict(peak_lr=1e-3, warmup_steps=2, total_steps=6, remat=True)


def _tokens(vocab, b, s, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


def _weights(model):
    return {k: p.detach().clone() for k, p in model.named_parameters()}


def _save(case, work, name):
    """WORK/NAME.pt, which appears whole (the ranks wait for it)."""
    part = os.path.join(work, name + ".part")
    torch.save(case, part)
    os.replace(part, os.path.join(work, name + ".pt"))


def _decode_case(arch, kw, work):
    """Writes the worker's case; returns a call that gives (JAX's logits,
    the port's unsharded logits) of the two steps."""
    jcfg, cfg = pair(arch, F32, **kw)
    params = jax_params(jcfg)
    model = lm_params_from_jax(cfg, np_tree(params), device="cpu")
    toks = _tokens(cfg.vocab_size, DB, S0 + STEPS, seed=3)
    tm = build_model(cfg)
    _, cache = tm.prefill(model, {"tokens": torch.from_numpy(toks[:, :S0])},
                          MAX_LEN)
    _save({"arch": arch, "kw": dict(kw, dtype=F32), "mesh": (2, 2),
           "weights": _weights(model), "cache": cache,
           "tokens": torch.from_numpy(toks), "prompt": S0, "steps": STEPS,
           "max_len": MAX_LEN}, work, f"decode_{arch}")

    def run():
        nonlocal cache
        jm = jbuild(jcfg)
        _, jc = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :S0])},
                           MAX_LEN)
        jl, tl = [], []
        for i in range(STEPS):
            out, jc = jm.decode_step(params, jnp.asarray(toks[:, S0 + i]),
                                     jc, S0 + i)
            jl.append(np.asarray(out))
            out, cache = tm.decode_step(
                model, torch.from_numpy(toks[:, S0 + i]), cache, S0 + i)
            tl.append(out.numpy())
        return np.stack(jl), np.stack(tl)
    return run


def _train_case(name, arch, mesh, kw, mb, layout, work):
    """Writes the worker's case; returns a call that gives JAX's (loss,
    grad norm, updated weights and first moments named as the port names
    them) of one jitted step."""
    jcfg, cfg = pair(arch, F32, **kw)
    jtcfg = jts.TrainCfg(num_microbatches=mb, **TCFG)
    jm = jbuild(jcfg)
    state = jts.init_train_state(jm, jax.random.key(42), jtcfg)
    batch = jbatch_at(jcfg, JShape("c", TS, TB, "train"), 0)
    model = lm_params_from_jax(cfg, np_tree(state.params), device="cpu")
    _save({"arch": arch, "kw": dict(kw, dtype=F32), "mesh": mesh,
           "weights": _weights(model),
           "batch": {k: torch.from_numpy(np.array(v))
                     for k, v in batch.items()},
           "tcfg": dict(TCFG, num_microbatches=mb), "layout": layout},
          work, f"train_{name}")

    def run():
        new, m = jax.jit(jts.make_train_step(jm, jtcfg))(state, batch)
        weights, mu = (_weights(lm_params_from_jax(cfg, np_tree(t),
                                                   device="cpu"))
                       for t in (new.params, new.opt.mu))
        return float(m["loss"]), float(m["grad_norm"]), weights, mu
    return run


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("mesh_decode"))
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    names = [f"decode_{a}" for a in DECODE] + [f"train_{a}" for a in TRAIN]
    ranks = [subprocess.Popen(
        [sys.executable, os.path.join(TESTS, "_torch_mesh_decode_worker.py"),
         str(r), work, *names], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(4)]
    try:
        decode = {arch: _decode_case(arch, kw, work)
                  for arch, kw in DECODE.items()}
        train = {name: _train_case(name, *case, work)
                 for name, case in TRAIN.items()}
        once = {}     # JAX's step once for cases of one (arch, mb, kw)
        for name, (arch, _, kw, mb, _) in TRAIN.items():
            key = (arch, mb, tuple(sorted(kw.items())))
            if key not in once:
                once[key] = train[name]()
            train[name] = once[key]
        decode = {arch: run() for arch, run in decode.items()}
        errs = [p.communicate(timeout=TIMEOUT_S)[1] for p in ranks]
        for p, err in zip(ranks, errs):
            assert p.returncode == 0, err[-3000:]
        got = torch.load(os.path.join(work, "out.pt"), weights_only=False)
    finally:
        for p in ranks:
            p.kill()
    return decode, train, got


# ------------------------------------------------------------------ (a) --

@pytest.fixture(scope="module")
def whisper():
    jcfg, cfg = pair("whisper-small", F32)
    params = jax_params(jcfg)
    model = lm_params_from_jax(cfg, np_tree(params), device="cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 6), dtype=np.int32)
    frames = rng.standard_normal((2, cfg.num_audio_frames, cfg.d_model)
                                 ).astype(np.float32)
    # a 5-token prompt's cache at max_len 9001, for the decode steps
    _, jc = JED.encdec_prefill(params, jcfg, jnp.asarray(toks[:, :5]),
                               jnp.asarray(frames), WHISPER_MAX_LEN)
    return jcfg, cfg, params, model, toks, frames, jc


@pytest.mark.parametrize("pos", WHISPER_POS)
def test_whisper_decode_step_past_the_position_table(whisper, pos):
    jcfg, cfg, params, model, toks, _, jc = whisper
    assert pos >= ED.POS_DEC_ROWS - 1
    cache = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    token = toks[:, 5]
    want, _ = JED.encdec_decode_step(params, jcfg, jnp.asarray(token), jc,
                                     pos)
    got, _ = ED.encdec_decode_step(model, cfg, torch.from_numpy(token),
                                   cache, pos)
    close(got, want, FP32_LOGITS)


def test_whisper_prefill_position_rows_past_the_table(whisper):
    """The rows the prefill adds at positions 0 .. 8199 (``decode_train``'s
    lookup; the whole prefill at this length costs a minute in JAX here)."""
    _, _, params, model, _, _, _ = whisper
    want = params["pos_dec"][jnp.arange(LONG_PROMPT)]
    got = model["pos_dec"][ED._pos_rows(torch.arange(LONG_PROMPT))]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[ED.POS_DEC_ROWS:] == model["pos_dec"][-1]).all()


# ------------------------------------------------------------------ (b) --

@pytest.mark.parametrize("arch", DECODE)
def test_sharded_decode_matches_unsharded_and_jax(runs, arch):
    decode, _, got = runs
    want_jax, want_port = decode[arch]
    sharded = got[f"decode_{arch}"]["logits"].numpy()
    assert sharded.shape == want_port.shape == (STEPS, DB,
                                                want_port.shape[-1])
    cfg = pair(arch, F32, **DECODE[arch])[1]
    (tol, of_max), _ = recurrent_tol(cfg)
    close(sharded, want_port, tol, of_max)
    close(sharded, want_jax, tol, of_max)


# ------------------------------------------------------------------ (c) --

@pytest.mark.parametrize("arch", TRAIN)
def test_sharded_train_step_matches_jax(runs, arch):
    _, train, got = runs
    loss, gnorm, weights, mu = train[arch]
    g = got[f"train_{arch}"]
    np.testing.assert_allclose(g["loss"], loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(g["grad_norm"], gnorm, rtol=LOSS_RTOL)
    bound = 2 * float(schedule.cosine_with_warmup(
        1, peak_lr=TCFG["peak_lr"], warmup_steps=TCFG["warmup_steps"],
        total_steps=TCFG["total_steps"]))
    # the first moments, (1 - b1) x each clipped gradient: a leaf whose
    # gradient is flipped, zeroed or misplaced moves them by its own size
    rtol, atol = GRAD_TOL
    assert set(g["mu"]) == set(mu)
    top = max(float(m.abs().max()) for m in mu.values())
    for k, m in mu.items():
        np.testing.assert_allclose(g["mu"][k].numpy(), m.numpy(), rtol=rtol,
                                   atol=atol * top, err_msg=k)
    assert set(g["weights"]) == set(weights)
    worst = max(float((g["weights"][k] - w).abs().max())
                for k, w in weights.items())
    assert worst <= bound, (worst, bound)
