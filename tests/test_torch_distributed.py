"""The port's distributed engines (v1, v2) over gloo against the JAX
package's shard_map engines, on the CPU.

One JAX subprocess with eight XLA host devices computes every reference
answer (``_torch_dist_jax.py``); one gloo spawn per world size (8 ranks: the
(8,) and (4, 2) meshes; 4 ranks: the (4,) mesh) computes the port's
(``_torch_dist_worker.py``). All three run at once; the cases are in
``_torch_dist_cases.py``. Every case must give JAX's medoid, pulls and
round plan, on every rank."""
import json
import os
import subprocess
import sys

import pytest

from _torch_dist_cases import CASES

pytestmark = pytest.mark.torch_port

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(TESTS), "src")
TIMEOUT_S = 150


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1", **extra)
    return env


@pytest.fixture(scope="module")
def answers(tmp_path_factory):
    """(JAX's answers, the port's results by world size)."""
    tmp = tmp_path_factory.mktemp("dist")
    jenv = _env(XLA_FLAGS="--xla_force_host_platform_device_count=8")
    jenv.pop("JAX_PLATFORMS", None)
    jax_proc = subprocess.Popen(
        [sys.executable, os.path.join(TESTS, "_torch_dist_jax.py")],
        env=jenv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ranks = []
    for world in (8, 4):
        for rank in range(world):
            ranks.append((world, subprocess.Popen(
                [sys.executable, os.path.join(TESTS, "_torch_dist_worker.py"),
                 str(rank), str(world), str(tmp / f"store{world}"),
                 str(tmp / f"port{world}.json")],
                env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
    try:
        jout, jerr = jax_proc.communicate(timeout=TIMEOUT_S)
        errs = [(w, p.communicate(timeout=TIMEOUT_S)[1]) for w, p in ranks]
    finally:
        for p in [jax_proc] + [p for _, p in ranks]:
            p.kill()
    assert jax_proc.returncode == 0, jerr[-3000:]
    for (world, p), (_, err) in zip(ranks, errs):
        assert p.returncode == 0, f"world {world}: {err[-3000:]}"
    port = {w: json.loads((tmp / f"port{w}.json").read_text())
            for w in (8, 4)}
    return json.loads(jout.strip().splitlines()[-1]), port


@pytest.mark.parametrize("case", CASES, ids=[c["id"] for c in CASES])
def test_distributed_matches_jax(answers, case):
    want, port = answers
    world = 1
    for s in case["mesh"]:
        world *= s
    got = port[world]["cases"][case["id"]]
    medoid, pulls, algo, rounds = want[case["id"]]
    assert got == [medoid, pulls, algo, rounds]
    assert algo == f"corr_sh_distributed_{case['impl']}"
    assert pulls == sum(s * t for s, t in rounds)


def test_tied_estimates_keep_exactly_keep_arms(answers):
    """The tied one-hot data: both engines find the exact medoid (the first
    zero row, 128) and match JAX, as
    ``test_distributed_v2_tied_estimates_regression`` requires of JAX."""
    want, port = answers
    tied = [c["id"] for c in CASES if c["data"] == "ties"]
    assert len(tied) == 4
    for cid in tied:
        assert port[8]["cases"][cid][0] == want[cid][0] == 128


def test_mesh_layout_is_row_major_on_4x2(answers):
    _, port = answers
    layout = port[8]["layout_4x2"]
    assert [row[1] for row in layout] == [[i, j] for i in range(4)
                                          for j in range(2)]
    assert [row[2] for row in layout] == [2 * i + j for i, j in
                                          (row[1] for row in layout)]
    assert all(row[3] for row in layout)
    assert all(port[8]["dtensor_rows_match"])


@pytest.mark.parametrize("kind,match", [
    ("algo", "mesh= requires algo='corr_sh'"),
    ("impl", "distributed_impl must be one of"),
    ("divisible", "must be divisible by device count 8"),
    ("telemetry", "without mesh="),
    ("precision", "without mesh="),
    ("placement", "row-sharded over every dimension"),
])
def test_facade_error_cases(answers, kind, match):
    _, port = answers
    err = port[8]["errors"][kind]
    assert err is not None and err.startswith("ValueError") and match in err


def test_cli_distributed_on_gloo(answers):
    _, port = answers
    line = port[4]["cli"]
    assert line["mode"] == "distributed-v2 x4 (pallas_fused)"
    assert line["correct"] is True and line["medoid"] == line["exact"] == 0
    assert line["pulls_scheduled"] == sum(s * t for s, t in line["rounds"])
