"""Carry state into the port, and the port's device rule.

The system has no weights: its state is the data matrix and the PRNG key.
:func:`data_from_numpy` and :func:`key_from_jax_data` take what a caller of
the JAX package holds — a numpy array and ``np.asarray(jax.random.key_data(
k))`` — so a test hands the same inputs to both packages.

Device rule (:func:`resolve_device`): an explicit ``device`` wins; otherwise
a tensor keeps its own device; otherwise the port runs on CUDA, and raises
when there is none rather than carry on quietly on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.engine.rng import Key


def resolve_device(device=None, like=None) -> torch.device:
    """The device an entry point runs on (see the module docstring)."""
    if device is not None:
        return torch.device(device)
    if isinstance(like, torch.Tensor):
        return like.device
    if not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on CUDA and none is available; "
                           "pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def data_from_numpy(arr, device=None) -> torch.Tensor:
    """An (n, d) array as a contiguous float32 tensor on ``device``."""
    return torch.as_tensor(np.ascontiguousarray(arr, dtype=np.float32)) \
        .to(resolve_device(device))


def key_from_jax_data(words, device=None) -> Key:
    """A :class:`Key` from the (2,) uint32 ``jax.random.key_data`` words."""
    w = np.asarray(words, dtype=np.uint32).reshape(2).astype(np.int64)
    return Key(torch.as_tensor(w).to(resolve_device(device)))
