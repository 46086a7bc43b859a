"""The cases of ``tests/test_torch_distributed.py``, shared by its two
subprocess scripts: the JAX reference (``_torch_dist_jax.py``, eight XLA host
devices) and the port's gloo ranks (``_torch_dist_worker.py``). Plain numpy
here: each script imports its own framework."""
from __future__ import annotations

import numpy as np

# Every case has an id; ``mesh`` is the mesh shape (its product is the world
# size of the spawn that runs it), ``impl`` v1 or v2, ``budget_per_arm`` the
# facade's (20 n is the exact-budget regime: every round scores all arms
# against all points), ``data`` a name of ``make_data``, ``seed`` the key.
CASES = []
for impl in ("v1", "v2"):
    for metric in ("l1", "l2"):
        for backend in ("reference", "pallas_fused"):
            CASES.append(dict(mesh=(8,), impl=impl, metric=metric,
                              backend=backend, budget_per_arm=4,
                              data="gauss", seed=3))
        CASES.append(dict(mesh=(4, 2), impl=impl, metric=metric,
                          backend="reference", budget_per_arm=4,
                          data="gauss", seed=5))
        CASES.append(dict(mesh=(4,), impl=impl, metric=metric,
                          backend="reference", budget_per_arm=4,
                          data="gauss", seed=5))
    CASES.append(dict(mesh=(8,), impl=impl, metric="l1", backend="reference",
                      budget_per_arm=20 * 128, data="gauss", seed=7))
    CASES.append(dict(mesh=(4,), impl=impl, metric="l2",
                      backend="pallas_fused", budget_per_arm=20 * 128,
                      data="gauss", seed=7))
    # tied estimates: v2's halving must keep exactly `keep` arms
    for seed in (50, 51):
        CASES.append(dict(mesh=(8,), impl=impl, metric="l1",
                          backend="reference", budget_per_arm=40,
                          data="ties", seed=seed))
for i, c in enumerate(CASES):
    c["id"] = (f"{c['impl']}-{c['metric']}-{c['backend']}-"
               f"{'x'.join(map(str, c['mesh']))}-{c['data']}-"
               f"b{c['budget_per_arm']}-k{c['seed']}")


def make_data(name: str) -> np.ndarray:
    """``gauss``: 128 x 6 standard normal rows (at 4 pulls per arm the
    halving misses the medoid under some keys); ``ties``: the data of
    ``test_distributed_v2_tied_estimates_regression``, 16 copies of each of
    8 one-hot rows and 128 zero rows (n = 256, d = 16)."""
    if name == "gauss":
        return np.random.default_rng(11).standard_normal(
            (128, 6)).astype(np.float32)
    if name == "ties":
        ones = np.tile(np.eye(8, 16), (16, 1))
        return np.concatenate([ones, np.zeros((128, 16))]).astype(np.float32)
    raise ValueError(name)
