"""The JAX package's answers to every case of ``_torch_dist_cases.py``, on
eight XLA host devices: ``repro.api.find_medoid(..., mesh=)`` on the case's
mesh with the rows sharded by ``make_row_sharding``. Run by
``test_torch_distributed.py`` in its own interpreter (the device-count flag
must be set before JAX starts); prints one JSON object, case id -> [medoid,
pulls, algo, rounds]."""
import json
import os
import sys

import jax
import numpy as np
from jax.sharding import Mesh

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_dist_cases import CASES, make_data  # noqa: E402

from repro.api import find_medoid  # noqa: E402
from repro.core.distributed import make_row_sharding  # noqa: E402

out = {}
for case in CASES:
    shape = case["mesh"]
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    mesh = Mesh(devs, tuple("ab"[:len(shape)]))
    x = jax.device_put(make_data(case["data"]), make_row_sharding(mesh))
    res = find_medoid(x, jax.random.key(case["seed"]), mesh=mesh,
                      distributed_impl=case["impl"], metric=case["metric"],
                      backend=case["backend"],
                      budget_per_arm=case["budget_per_arm"])
    out[case["id"]] = [res.medoid, res.pulls, res.algo,
                       [list(r) for r in res.rounds]]
print(json.dumps(out))
