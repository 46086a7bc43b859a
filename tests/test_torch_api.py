"""The port's facade and CLI against ``repro.api``, its device rule, and the
guard that keeps it free of JAX."""
import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from _torch_compare import RTOL, case, torch_key
from repro.core import correlated_sequential_halving as jcorr_sh
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.launch import medoid as tcli

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]
BACKENDS = ("reference", "pallas_fused", "pallas_fused_topk")
METRICS = ("l1", "l2", "sql2", "cosine")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("metric", METRICS)
def test_find_medoid_matches_jax(backend, metric):
    n = 1024 if backend == "reference" else 257   # Pallas interprets on CPU
    d = 300 if metric in ("sql2", "cosine") else 8
    x = case(n, d, seed=7 * n + d, positive=metric == "cosine")
    jk = jax.random.key(2000 + n)
    want = japi.find_medoid(x, jk, backend=backend, metric=metric,
                            budget_per_arm=16)
    got = tapi.find_medoid(x, torch_key(jk), backend=backend, metric=metric,
                           budget_per_arm=16, device="cpu")
    assert (got.pulls, got.rounds, got.n, got.algo, got.metric,
            got.backend, got.precision) == \
        (want.pulls, want.rounds, want.n, want.algo, want.metric,
         want.backend, want.precision)
    if got.medoid != want.medoid:
        # allowed only where JAX's own output-round top-two gap is inside
        # the estimate tolerance (the winner is then a near-tie)
        theta = np.sort(np.asarray(jcorr_sh(jnp.asarray(x), 16 * n, jk,
                                            metric=metric,
                                            backend=backend).theta_hat))
        assert theta[1] - theta[0] <= 2 * RTOL * abs(theta[0]), \
            (got.medoid, want.medoid)


@pytest.mark.parametrize("metric", METRICS)
def test_exact_algo_matches_jax(metric):
    x = case(200, 8, seed=9, positive=metric == "cosine")
    want = japi.find_medoid(x, algo="exact", metric=metric)
    got = tapi.find_medoid(x, algo="exact", metric=metric, device="cpu")
    assert (got.medoid, got.pulls, got.algo) == \
        (want.medoid, want.pulls, want.algo)


def test_small_n_and_config():
    one = tapi.find_medoid(np.zeros((1, 3), np.float32), device="cpu")
    assert (one.medoid, one.pulls, one.rounds) == (0, 0, ())
    x = case(2, 3)
    want = japi.find_medoid(x, jax.random.key(0))
    got = tapi.find_medoid(x, device="cpu")          # key(config.seed = 0)
    assert (got.medoid, got.pulls, got.rounds) == \
        (want.medoid, want.pulls, want.rounds)
    cfg = tapi.MedoidConfig(metric="l1", budget_per_arm=8)
    assert tapi.find_medoid(case(50, 4), config=cfg, device="cpu").metric \
        == "l1"
    assert [f.name for f in tapi.dataclasses.fields(tapi.MedoidConfig)] == \
        [f.name for f in tapi.dataclasses.fields(japi.MedoidConfig)]
    assert [f.name for f in tapi.dataclasses.fields(tapi.MedoidResult)] == \
        [f.name for f in tapi.dataclasses.fields(japi.MedoidResult)]
    with pytest.raises(ValueError):
        tapi.find_medoid(np.zeros(5, np.float32), device="cpu")
    with pytest.raises(TypeError):
        tapi.find_medoid(x, config=object(), device="cpu")


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = case(16, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.find_medoid(x)
    with pytest.raises(RuntimeError):
        convert.data_from_numpy(x)
    with pytest.raises(RuntimeError):
        convert.key_from_jax_data(np.zeros(2, np.uint32))
    with pytest.raises(RuntimeError):
        tcli.run(16, 4, "", 8, "planted")
    # a tensor keeps its own device; device="cpu" runs on the CPU
    assert tapi.find_medoid(torch.from_numpy(x)).n == 16
    assert tapi.find_medoid(x, device="cpu").n == 16


@pytest.mark.parametrize("sep", [[], ["--"]])
def test_cli_on_cpu(capsys, sep):
    # "--": what torchrun passes on after its own options on some versions
    tcli.main(sep + ["--device", "cpu", "--n", "256", "--d", "16",
                     "--compare"])
    out = json.loads(capsys.readouterr().out)
    assert out["correct"] is True and out["medoid"] == out["exact"] == 0
    assert out["pulls_scheduled"] == sum(s * t for s, t in out["rounds"])
    assert {"n", "d", "metric", "budget", "backend", "precision", "mode",
            "medoid", "corrsh_s", "exact", "exact_s", "rand",
            "rand_s"} <= set(out)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)
