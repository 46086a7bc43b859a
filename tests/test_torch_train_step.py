"""The port's train step and trainer against the JAX package's.

* Three ``make_train_step`` steps from the same state (JAX's, carried over
  with ``convert.train_state_from_jax``) on the same batches, at
  ``tests/test_train_integration.py``'s ``ti`` config, for 1 and 4
  microbatches and with gradient compression: the loss, the learning rate
  and the grad norm of every step, then the params.
* A checkpoint that JAX's train step and checkpoint manager wrote after two
  steps of the smoke internlm2 (``repro.launch.train``'s own loop: the
  driver itself raises ``ShardingTypeError`` in its mesh gather on jax
  0.9, one of the suite's known failures) continued by the port's
  ``launch.train``: its step-3 loss is JAX's.
* The port's resume and its restart after a crash against an uninterrupted
  run, bit for bit; the CLI; the example. (The sharded trainer's tests
  are ``test_torch_mesh_train.py``.)

Tolerances. fp32: a step's loss within rtol 1e-4, the learning rate
rtol 1e-6, the grad norm rtol 2e-3 (read: 1.1e-5, 8e-8, 3e-4 with
compression 1e-3). The params after three steps: every element within
2 sum(lr) of JAX's (AdamW's first steps move an element by about lr in the
sign of its gradient, and a gradient that is rounding noise in both
packages can take either sign), and the difference's norm within 2% of the
norm of JAX's whole update (read: 0.8-0.9%). The bf16 ``ti`` config:
loss rtol 2e-3, grad norm rtol 5e-3 (read: 5.1e-4, 1.9e-3), the params'
difference within 10% of the update's norm (read: 5.5%; in bf16 the
gradients' rounding turns more of those signs). The resumed smoke
internlm2 (bf16): its step-3 loss within rtol 2e-3 of JAX's (read 2.2e-4).
"""
import json
import os

import jax
import numpy as np
import pytest

from _torch_lm import example
from repro.checkpoint import manager as jckpt
from repro.configs import get_smoke_config as jsmoke
from repro.configs.base import InputShape as JShape
from repro.configs.base import ModelCfg as JModelCfg
from repro.data.pipeline import batch_at as jbatch_at
from repro.models.model import build_model as jbuild
from repro.train import train_step as jts
from repro_torch.configs.base import InputShape, ModelCfg
from repro_torch.convert import _unstack, train_state_from_jax
from repro_torch.data.pipeline import batch_at
from repro_torch.launch import train as tlaunch
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import named
from repro_torch.train.train_step import TrainCfg, make_train_step

pytestmark = pytest.mark.torch_port

TI = dict(name="ti", family="dense", num_layers=2, d_model=64, num_heads=4,
          num_kv_heads=2, d_ff=128, vocab_size=128)
SHAPE = (64, 8)           # seq_len, global batch
STEPS = 3
TOL = {"float32": dict(loss=1e-4, grad_norm=2e-3, update=2e-2),
       "bfloat16": dict(loss=2e-3, grad_norm=5e-3, update=0.1)}


@pytest.mark.parametrize("dtype,opts", [
    ("float32", dict(num_microbatches=1)),
    ("float32", dict(num_microbatches=4)),
    ("float32", dict(grad_compression=True)),
    ("bfloat16", dict(num_microbatches=1))])
def test_three_steps_match_jax(dtype, opts):
    jcfg, tcfg = JModelCfg(**TI, dtype=dtype), ModelCfg(**TI, dtype=dtype)
    jt = jts.TrainCfg(peak_lr=3e-3, warmup_steps=2, total_steps=10,
                      remat=True, **opts)
    jmodel = jbuild(jcfg)
    js = jts.init_train_state(jmodel, jax.random.key(1), jt)
    p0 = {k: np.asarray(v, np.float64) for k, v in _unstack(
        tcfg, jax.tree.map(np.asarray, js.params)).items()}
    ts = train_state_from_jax(tcfg, jax.tree.map(np.asarray, js),
                              device="cpu")
    assert (ts.ef is None) == (not jt.grad_compression)
    jstep = jax.jit(jts.make_train_step(jmodel, jt))
    tstep = make_train_step(build_model(tcfg), TrainCfg(**vars(jt)))
    tol = TOL[dtype]
    lr_sum = 0.0
    for t in range(STEPS):
        js, jm = jstep(js, jbatch_at(jcfg, JShape("t", *SHAPE, "train"), t))
        ts, tm = tstep(ts, batch_at(tcfg, InputShape("t", *SHAPE, "train"),
                                    t, device="cpu"))
        assert set(tm) == set(jm)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=tol["loss"])
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]),
                                   rtol=tol["grad_norm"])
        lr_sum += float(jm["lr"])
    assert int(ts.step) == int(js.step) == int(ts.opt.step) == STEPS
    want = _unstack(tcfg, jax.tree.map(np.asarray, js.params))
    diff2 = upd2 = 0.0
    for k, p in named(ts.params).items():
        assert str(p.dtype).endswith(np.asarray(want[k]).dtype.name), k
        w = np.asarray(want[k], np.float64)
        d = p.detach().double().numpy() - w
        assert np.abs(d).max() <= 2 * lr_sum, k
        diff2 += float((d ** 2).sum())
        upd2 += float(((w - p0[k]) ** 2).sum())
    assert np.sqrt(diff2 / upd2) <= tol["update"], np.sqrt(diff2 / upd2)


def _jax_two_steps_then_third(ckpt_dir):
    """``repro.launch.train``'s loop on the smoke internlm2 (batch 4 x 32,
    3 steps, seed 42): the checkpoint of step 2, and the three losses."""
    cfg = jsmoke("internlm2-1.8b")
    tcfg = jts.TrainCfg(peak_lr=1e-3, warmup_steps=2, total_steps=3,
                        remat=True)
    model = jbuild(cfg)
    state = jts.init_train_state(model, jax.random.key(42), tcfg)
    step = jax.jit(jts.make_train_step(model, tcfg))
    losses = []
    for t in range(3):
        if t == 2:
            jckpt.save(ckpt_dir, 2, state)
        state, m = step(state, jbatch_at(cfg, JShape("custom", 32, 4,
                                                     "train"), t))
        losses.append(float(m["loss"]))
    return losses


def test_jax_checkpoint_continues_in_the_port(tmp_path):
    d = str(tmp_path)
    want = _jax_two_steps_then_third(d)
    out = tlaunch.train("internlm2-1.8b", smoke=True, steps=3, batch_size=4,
                        seq_len=32, ckpt_dir=d, ckpt_every=5, device="cpu")
    assert out["start_step"] == 2 and len(out["losses"]) == 1
    np.testing.assert_allclose(out["losses"][0], want[2], rtol=2e-3)
    # the port's step-3 checkpoint has JAX's keys and restores in JAX
    cfg = jsmoke("internlm2-1.8b")
    target = jax.eval_shape(lambda: jts.init_train_state(
        jbuild(cfg), jax.random.key(0), jts.TrainCfg()))
    got, meta = jckpt.restore(d, target)
    assert meta["step"] == 3 and int(got.step) == 3 and int(got.opt.step) == 3


def _run(tmp_path, name, steps, **kw):
    return tlaunch.train("internlm2-1.8b", smoke=True, steps=steps,
                         batch_size=4, seq_len=32,
                         ckpt_dir=str(tmp_path / name), ckpt_every=2,
                         device="cpu", log_every=100, **kw)


def test_resume_equals_an_uninterrupted_run(tmp_path):
    full = _run(tmp_path, "full", 4)
    first = _run(tmp_path, "cut", 2)
    second = _run(tmp_path, "cut", 4)
    assert second["start_step"] == 2
    assert first["losses"] + second["losses"] == full["losses"]
    assert full["final_loss"] < full["first_loss"]


def test_restart_after_a_crash_resumes_from_the_checkpoint(tmp_path,
                                                           monkeypatch):
    full = _run(tmp_path, "full", 4)
    make = tlaunch.make_train_step
    crashed = []

    def flaky(model, tcfg):
        step = make(model, tcfg)

        def once(state, batch):
            if int(state.step) == 3 and not crashed:
                crashed.append(True)
                raise RuntimeError("node died")
            return step(state, batch)
        return once

    monkeypatch.setattr(tlaunch, "make_train_step", flaky)
    got = _run(tmp_path, "crash", 4)
    assert crashed
    # steps 0-2, then step 2 again from the step-2 checkpoint, then step 3
    assert got["losses"][:3] == full["losses"][:3]
    assert got["losses"][3:] == full["losses"][2:]


def test_cli_prints_the_reference_summary(tmp_path, capsys):
    tlaunch.main(["--arch", "whisper-small", "--smoke", "--device", "cpu",
                  "--steps", "2", "--batch", "2", "--seq-len", "16",
                  "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"final_loss", "first_loss", "stragglers", "steps"}
    assert out["steps"] == 2 and np.isfinite(out["final_loss"])
    assert sorted(os.listdir(tmp_path)) == ["step_00000001",
                                            "step_00000002"]


def test_example_trains(tmp_path):
    out = example("train_lm_torch").main(
        ["--cpu", "--steps", "12", "--ckpt-dir", str(tmp_path)])
    assert out["final_loss"] < out["first_loss"]
