"""RAND baseline [Eppstein & Wang 2006]: non-adaptive uniform reference
sampling, the counterpart of ``repro/core/rand.py``.

Measures the distance between every point and ``num_refs`` reference points
drawn uniformly at random (``randint``, or a ``permutation`` prefix without
replacement) and returns the argmin of the mean, first index on ties. The
(n, num_refs) block is evaluated in row blocks with the reference distances
(:func:`repro_torch.core.distances.centrality_sums`, which also chunks the ℓ1
broadcast), so neither the block nor the (n, num_refs, d) difference of
``pairwise_l1`` is ever built whole.
"""
from __future__ import annotations

import torch

from repro_torch.core.distances import centrality_sums
from repro_torch.engine import rng
from repro_torch.engine.halving import _mean

# Rows a block: an ℓ1 block's (rows, 32, 256) intermediate stays at 128 MiB.
ROW_BLOCK = 4096


def rand_medoid(data: torch.Tensor, key: rng.Key, *, num_refs: int,
                metric: str = "l2", replace: bool = True) -> torch.Tensor:
    """RAND's medoid of ``data (n, d)`` as a 0-d int64 tensor on its
    device."""
    data = data.float().contiguous()
    n = data.shape[0]
    if replace:
        refs = rng.randint(key, (num_refs,), 0, n)
    else:
        refs = rng.permutation(key, n)[:num_refs]
    y = data[refs]
    sums = torch.cat([centrality_sums(data[i:i + ROW_BLOCK], y, metric)
                      for i in range(0, n, ROW_BLOCK)])
    return torch.argmin(_mean(sums, y.shape[0]))
