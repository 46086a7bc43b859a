"""Shared helpers of the port's tests: the same numpy inputs and keys for
the JAX package and ``repro_torch``, and the tolerances they are held to.

Tolerances (fp32 on both sides, sums taken in different orders):

* ``RTOL = 1e-5`` relative on every centrality sum or mean, with a floor of
  1e-5 of the largest value (a value near 0 has no useful relative error);
* for l2 only, the Gram-trick self-pair allowance: a distance of 0 comes
  out near ``|x| sqrt(eps)`` from the cancellation in ``|x|^2 + |y|^2 - 2
  x.y``, and each side cancels differently, so 1e-3 * the largest row norm
  per reference (per distance for pairwise blocks, once for means).
"""
from __future__ import annotations

import jax
import numpy as np
import torch

from repro_torch.convert import key_from_jax_data

RTOL = 1e-5


def jax_key(seed: int):
    return jax.random.key(seed)


def torch_key(jkey):
    """The port's key for a JAX key, on the CPU."""
    return key_from_jax_data(np.asarray(jax.random.key_data(jkey)), "cpu")


def case(n: int, d: int, seed: int = 0, positive: bool = False) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return np.abs(x) if positive else x


def tolerance(want: np.ndarray, metric: str, rows: np.ndarray,
              per_value_refs: float) -> np.ndarray:
    """Allowed |got - want| for each value (see the module docstring);
    ``per_value_refs`` is how many references enter each value (1 for a
    mean or a single distance, R for a sum over R references)."""
    want = np.abs(np.asarray(want, np.float64))
    tol = RTOL * want + RTOL * (want.max() if want.size else 0.0)
    if metric == "l2":
        tol = tol + 1e-3 * np.linalg.norm(rows, axis=-1).max() * per_value_refs
    return tol


def assert_close(got, want, metric: str, rows: np.ndarray,
                 per_value_refs: float = 1.0) -> None:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    tol = tolerance(want, metric, rows, per_value_refs)
    assert (err <= tol).all(), (float(err.max()), float(tol.min()))
