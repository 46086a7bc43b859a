"""The port's sharded trainer on gloo ranks against its one-device trainer
and the JAX package's one-device train step.

JAX's own multi-device driver cannot be the yardstick: ``repro.launch.train``
raises ``ShardingTypeError`` on jax 0.9 (its mesh gather of the embedding;
``test_train_driver_multidevice_and_elastic_resume`` is one of the suite's
known failures). So the float32 smoke internlm2 starts from JAX's
``init_train_state`` written as a step-0 checkpoint by JAX's checkpoint
manager, and:

* 4 gloo ranks train it to step 6 on ``elastic_remesh``'s (1, 4) mesh (the
  KV projection's 2 heads x 16 split over 4 ranks cuts a head in half),
  checkpointing every 3 steps, then take one step on a (2, 2) mesh, whose
  data axis shards the batch; ranks 0 and 1 then leave for a world of two
  and resume to step 9 on a (1, 2) mesh.
* The port's one-device ``train`` runs the same calls in this process,
  with no process group. Every loss and grad norm agrees with it to
  ``LOSS_RTOL`` (1e-5; read: 8.3e-8, 2.2e-7), and the step-9 weights
  within the per-element bound of ``test_torch_train_step.py`` (2 x the
  learning rates' sum, 7.5e-3; read: 5.6e-6).
* The first two losses agree with JAX's jitted one-device steps on the same
  batches to ``LOSS_RTOL`` (read: 6.6e-7); the (2, 2) step's loss and grad
  norm with the one-device first step's.
* The 4-rank step-6 checkpoint restores through JAX's
  ``checkpoint.manager.restore`` bit for bit as the port reads it, its
  weights the one-device run's step 6 within the same bound.

Float32, because a bf16 row-parallel product is summed across ranks from
bf16 partials: the smoke config in bf16 parts from one device by ~6e-5 in
its first loss, a rounding no 1e-5 bound holds. Each rank runs with one
OpenMP thread, in its own process, so no process group opens in the
pytest worker; this process computes JAX's steps and the one-device run
meanwhile."""
import json
import os
import shutil
import subprocess
import sys
from unittest import mock

import jax
import numpy as np
import pytest

from _torch_train import LOSS_RTOL
from repro.checkpoint import manager as jckpt
from repro.configs import get_smoke_config as jsmoke
from repro.configs.base import InputShape as JShape
from repro.data.pipeline import batch_at as jbatch_at
from repro.models.model import build_model as jbuild
from repro.train import train_step as jts
from repro_torch.checkpoint import manager as ckpt
from repro_torch.launch import train as tl
from repro_torch.optim import schedule

pytestmark = pytest.mark.torch_port

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(TESTS), "src")
TIMEOUT_S = 150
RUN = dict(smoke=True, batch_size=8, seq_len=32, ckpt_every=3,
           device="cpu", log_every=100)


def _jax_state():
    cfg = jsmoke("internlm2-1.8b").scaled(dtype="float32")
    tcfg = jts.TrainCfg(peak_lr=1e-3, warmup_steps=2, total_steps=6,
                        remat=True)
    model = jbuild(cfg)
    return cfg, tcfg, model, jts.init_train_state(model, jax.random.key(42),
                                                  tcfg)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_train")
    dirs = {k: str(tmp / k) for k in ("sharded", "dp", "one")}
    # the ranks import now and start when JAX's step 0 is written
    ready, out = str(tmp / "ready"), tmp / "out.json"
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               WAIT_FOR=ready)
    ranks = [subprocess.Popen(
        [sys.executable, os.path.join(TESTS, "_torch_mesh_worker.py"),
         str(r), str(tmp), str(out), dirs["sharded"], dirs["dp"]],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    try:
        jcfg, jtcfg, jmodel, state = _jax_state()
        for d in dirs.values():
            jckpt.save(d, 0, state)
        open(ready, "w").close()
        step = jax.jit(jts.make_train_step(jmodel, jtcfg))
        jlosses = []
        for t in range(2):
            state, m = step(state, jbatch_at(jcfg, JShape("c", 32, 8, "train"),
                                             t))
            jlosses.append(float(m["loss"]))
        smoke32 = tl.get_smoke_config("internlm2-1.8b").scaled(
            dtype="float32")
        with mock.patch.object(tl, "get_smoke_config", lambda a: smoke32):
            one = [tl.train("internlm2-1.8b", steps=s, ckpt_dir=dirs["one"],
                            **RUN) for s in (6, 9)]
        target = jax.eval_shape(lambda: jts.init_train_state(
            jmodel, jax.random.key(0), jtcfg))
        errs = [p.communicate(timeout=TIMEOUT_S)[1] for p in ranks]
        for p, err in zip(ranks, errs):
            assert p.returncode == 0, err[-3000:]
        got = json.loads(out.read_text())
        jrest, meta = jckpt.restore(dirs["sharded"], target, step=6)
        jone, _ = jckpt.restore(dirs["one"], target, step=6)
    finally:
        for p in ranks:
            p.kill()
    shutil.rmtree(dirs["dp"], ignore_errors=True)
    return dict(jax=jlosses, one=one, four=got["four"], dp=got["dp"],
                two=got["two"], restored=(jrest, jone, meta), dirs=dirs,
                target=target)


def test_four_then_two_ranks_match_one_device(runs):
    four, two = runs["four"], runs["two"]
    assert four["mesh"] == [1, 4] and two["mesh"] == [1, 2]
    assert four["start_step"] == 0 and two["start_step"] == 6
    one = runs["one"]
    assert [r["start_step"] for r in one] == [0, 6]
    want = one[0]["losses"] + one[1]["losses"]
    got = four["losses"] + two["losses"]
    assert len(got) == len(want) == 9
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(four["grad_norms"] + two["grad_norms"],
                               one[0]["grad_norms"] + one[1]["grad_norms"],
                               rtol=LOSS_RTOL)


def test_first_losses_match_jax_one_device_step(runs):
    np.testing.assert_allclose(runs["four"]["losses"][:2],
                               runs["jax"], rtol=LOSS_RTOL)


def test_data_sharded_mesh_step(runs):
    dp = runs["dp"]
    assert dp["mesh"] == [2, 2] and dp["start_step"] == 0
    first = runs["one"][0]
    np.testing.assert_allclose(dp["losses"], first["losses"][:1],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(dp["grad_norms"], first["grad_norms"][:1],
                               rtol=LOSS_RTOL)


def _lr_sum():
    total = 0.0
    for steps, ts in ((6, range(1, 7)), (9, range(7, 10))):
        total += sum(float(schedule.cosine_with_warmup(
            t, peak_lr=1e-3, warmup_steps=2, total_steps=steps)) for t in ts)
    return total


def test_final_weights_within_update_bound(runs):
    zeros = {"params": jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                    runs["target"].params)}

    def params(d):
        tree, meta = ckpt.restore(d, zeros)
        assert meta["step"] == 9
        return jax.tree_util.tree_leaves_with_path(tree)

    bound = 2 * _lr_sum()
    got, want = params(runs["dirs"]["sharded"]), params(runs["dirs"]["one"])
    assert [p for p, _ in got] == [p for p, _ in want]
    worst = max(float(np.abs(a - b).max()) for (_, a), (_, b) in
                zip(got, want))
    assert worst <= bound, (worst, bound)


def test_sharded_checkpoint_restores_in_jax(runs):
    """JAX reads the 4-rank checkpoint bit for bit as the port does; its
    weights are the one-device run's within the update bound."""
    jrest, jone, meta = runs["restored"]
    assert meta["step"] == 6 and int(jrest.step) == 6
    mine, _ = ckpt.restore(runs["dirs"]["sharded"], jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), runs["target"]), step=6)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(jrest),
                                 jax.tree_util.tree_leaves_with_path(mine)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))
    bound = 2 * sum(float(schedule.cosine_with_warmup(
        t, peak_lr=1e-3, warmup_steps=2, total_steps=6)) for t in range(1, 7))
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(jrest.params),
            jax.tree_util.tree_leaves_with_path(jone.params)):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() <= bound, path
