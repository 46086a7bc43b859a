"""``fused_xent``'s chunked branch with its logits cut by vocab columns
across two gloo ranks, against JAX's ``fused_xent`` on one device.

B 2, S 40 (39 targets in chunks of 16: 16, 16 and 7 padded by 9), d 16,
V 63 cut into columns 0-31 and 32-62 (DTensor's uneven split), the
targets in both halves. Each rank reduces its own columns and all-reduces
the (B, c) max, sum of exponentials and target logit
(``models.model._VocabParallelXent``); the loss and the gradients of x and
head equal JAX's within ``TOL`` (rtol 1e-5, atol 1e-5 of the largest
gradient), and the ranks issue no all-gather (the chunk's vocab columns
are never gathered). The ranks run ``_torch_vocab_xent_worker.py``, each
a process of its own."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models.model import fused_xent as jfused_xent

pytestmark = pytest.mark.torch_port

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(TESTS), "src")
TIMEOUT_S = 60
B, S, D, V, CHUNK = 2, 40, 16, 63, 16
TOL = 1e-5


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("vocab_xent")
    rs = np.random.RandomState(1)
    tokens = rs.randint(0, V, (B, S)).astype(np.int64)
    tokens[0, 1:3] = (V // 2, V // 2 + 1)         # either side of the cut
    data = {"x": rs.randn(B, S, D).astype(np.float32),
            "head": rs.randn(V, D).astype(np.float32),
            "tokens": tokens, "chunk": np.asarray(CHUNK)}
    np.savez(tmp / "in.npz", **data)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    worker = os.path.join(TESTS, "_torch_vocab_xent_worker.py")
    ranks = [subprocess.Popen(
        [sys.executable, worker, str(r), str(tmp / "store"),
         str(tmp / "in.npz"), str(tmp / "out.json")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        f = jax.jit(jax.value_and_grad(
            lambda x, h: jfused_xent(x, jnp.asarray(tokens, jnp.int32), h,
                                     chunk=CHUNK), argnums=(0, 1)))
        v, (gx, gh) = f(data["x"], data["head"])
        want = (float(v), np.asarray(gx), np.asarray(gh))
        errs = [p.communicate(timeout=TIMEOUT_S)[1] for p in ranks]
    finally:
        for p in ranks:
            p.kill()
    for p, err in zip(ranks, errs):
        assert p.returncode == 0, err[-3000:]
    return data, want, json.loads((tmp / "out.json").read_text())


def test_targets_fall_in_both_shards(run):
    data, _, _ = run
    t = data["tokens"][:, 1:]
    assert (t < 32).any() and (t >= 32).any()


def test_loss_matches_jax(run):
    _, (wl, _, _), got = run
    np.testing.assert_allclose(got["loss"], wl, rtol=TOL)


@pytest.mark.parametrize("name", ("dx", "dhead"))
def test_gradient_matches_jax(run, name):
    _, (_, wx, wh), got = run
    want = {"dx": wx, "dhead": wh}[name]
    top = max(np.abs(wx).max(), np.abs(wh).max())
    np.testing.assert_allclose(np.asarray(got[name]), want, rtol=TOL,
                               atol=TOL * top)


def test_no_all_gather_of_logits(run):
    """Three all-reduces of a (B, c) row a chunk in the forward, again in
    the remat's recompute, one more for the x gradient's pending sum; no
    all-gather."""
    _, _, got = run
    c = got["collectives"]
    assert c["all-gather"] == 0, c
    assert c["all-reduce"] == 3 * 3 * 2 + 1, c
