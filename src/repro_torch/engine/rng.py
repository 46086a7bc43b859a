"""JAX's threefry2x32 random stream in PyTorch, bit for bit.

The port draws the same reference sets as :mod:`repro` in every round, which
makes the comparison with the JAX package exact instead of statistical. This
module reproduces what ``jax.random`` does with its default settings (impl
``threefry2x32``, ``jax_threefry_partitionable=True``):

* ``key(seed)`` has the key data ``[0, seed]``;
* ``split(key)`` hashes the counters ``(0, i)`` under the key: child ``i`` is
  the pair ``threefry2x32(key, (0, i))``;
* ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``;
* ``bits(key, n)`` is ``hi ^ lo`` of ``threefry2x32(key, (0, i))`` for
  ``i < n`` (the 64-bit counter is ``i``: its high word is 0 below 2**32);
* ``permutation(key, n)`` is ``jax._src.random._shuffle``: ``ceil(3 ln n /
  ln(2**32 - 1))`` rounds, each ``key, sub = split(key)`` followed by a
  *stable* sort of the current order by ``bits(sub, n)``.

uint32 words are carried in int64 tensors masked with ``0xFFFFFFFF`` (torch's
uint32 arithmetic is incomplete). Every function runs on the key's device and
never reads a value back to the host.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


@dataclass(frozen=True)
class Key:
    """One PRNG key: ``data`` is a (2,) int64 tensor of two uint32 words,
    the layout of ``jax.random.key_data``."""
    data: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.data.device

    def to(self, device) -> "Key":
        return Key(self.data.to(device))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The 20-round Threefry-2x32 block cipher on broadcast int64 words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def key(seed: int, device=None) -> Key:
    """``jax.random.key(seed)`` for a seed that fits 32 bits."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 32:
        raise ValueError(f"seed must fit in 32 bits, got {seed}")
    return Key(torch.tensor([0, seed & _MASK], dtype=torch.int64,
                            device=device))


def _hash_counters(k: Key, lo: torch.Tensor):
    return threefry2x32(k.data[0], k.data[1], torch.zeros_like(lo), lo)


def split_many(k: Key, num: int) -> list[Key]:
    """``jax.random.split(key, num)`` as a list of keys."""
    h0, h1 = _hash_counters(k, torch.arange(num, dtype=torch.int64,
                                            device=k.device))
    words = torch.stack([h0, h1], dim=1)
    return [Key(words[i]) for i in range(num)]


def split(k: Key) -> tuple[Key, Key]:
    """``key, sub = jax.random.split(key)``."""
    a, b = split_many(k, 2)
    return a, b


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``."""
    lo = torch.tensor([int(data) & _MASK], dtype=torch.int64, device=k.device)
    h0, h1 = _hash_counters(k, lo)
    return Key(torch.cat([h0, h1]))


def bits(k: Key, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` as int64 values in [0, 2**32)."""
    h0, h1 = _hash_counters(k, torch.arange(n, dtype=torch.int64,
                                            device=k.device))
    return h0 ^ h1


def shuffle_rounds(n: int) -> int:
    """Sort rounds of ``jax.random.permutation(key, n)`` (the same float64
    expression as ``jax._src.random._shuffle``)."""
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))


def permutation(k: Key, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` as an int64 tensor."""
    x = torch.arange(n, dtype=torch.int64, device=k.device)
    for _ in range(shuffle_rounds(n)):
        k, sub = split(k)
        order = torch.sort(bits(sub, n), stable=True).indices
        x = x[order]
    return x
