"""Med-dit's draws for a chunk of steps: ``csrc/threefry.cu`` and its plain
version.

No TPU kernel corresponds: in ``repro/core/meddit.py`` each step of the
``lax.while_loop`` draws ``key, sub = split(key)`` and ``randint(sub, (B,),
0, n)``, and XLA fuses those hashes into the loop. The port runs Med-dit in
chunks of K masked steps (:mod:`repro_torch.core.meddit`) and makes a
chunk's draws first, in one launch on the card: the chain of K splits walked
by one thread, then the K x B references in parallel, bit-equal to
:mod:`repro_torch.engine.rng` (and so to ``jax.random``).

The wrapper follows :mod:`repro_torch.kernels.pairwise_distance`: on a CUDA
key it launches the kernel and adds one to ``LAUNCHES["threefry"]``; on a
CPU key it returns the plain version; anything else raises.
"""
from __future__ import annotations

import torch

from repro_torch.engine import rng
from repro_torch.kernels import build
from repro_torch.kernels.pairwise_distance import LAUNCHES, _on_cuda


def _check(k: int, b: int, n: int) -> None:
    if k < 1 or b < 1:
        raise ValueError(f"threefry_draws: need k >= 1 and b >= 1, got "
                         f"k={k}, b={b}")
    if not 1 <= n < 2 ** 31:
        raise ValueError(f"threefry_draws: n must be in [1, 2**31), got {n}")
    if k * b >= 2 ** 31:
        raise ValueError(f"threefry_draws: {k} x {b} draws exceed int32")


def threefry_draws_plain(key: rng.Key, k: int, b: int, n: int
                         ) -> tuple[torch.Tensor, rng.Key, torch.Tensor]:
    """``k`` steps of ``key, sub = split(key)``; ``randint(sub, (b,), 0,
    n)``: the (k, 2) int64 words of the subs, the key after the last step
    and the (k, b) int32 references."""
    _check(k, b, n)
    subs, refs = [], []
    for _ in range(k):
        key, sub = rng.split(key)
        subs.append(sub.data)
        refs.append(rng.randint(sub, (b,), 0, n))
    return (torch.stack(subs), key,
            torch.stack(refs).to(torch.int32))


def threefry_draws(key: rng.Key, k: int, b: int, n: int
                   ) -> tuple[torch.Tensor, rng.Key, torch.Tensor]:
    """:func:`threefry_draws_plain` in one launch of ``csrc/threefry.cu``
    on a CUDA key (no TPU counterpart, see the module docstring). Bound:
    the chain's ``k`` sequential hashes; its ``4 k b + 16 k + 16`` bytes
    take under a microsecond."""
    _check(k, b, n)
    words = key.data
    if not _on_cuda("threefry_draws", words):
        return threefry_draws_plain(key, k, b, n)
    if words.dtype != torch.int64 or tuple(words.shape) != (2,) \
            or not words.is_contiguous():
        raise ValueError("threefry_draws: the key must be (2,) contiguous "
                         "int64 words")
    subs = torch.empty((k, 2), dtype=torch.int64, device=words.device)
    nxt = torch.empty(2, dtype=torch.int64, device=words.device)
    refs = torch.empty((k, b), dtype=torch.int32, device=words.device)
    fn = build.function("threefry_draws_launch")
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        code = fn(words.data_ptr(), subs.data_ptr(), nxt.data_ptr(),
                  refs.data_ptr(), k, b, n, stream)
    build.check("threefry_draws_launch", code)
    LAUNCHES["threefry"] += 1
    return subs, rng.Key(nxt), refs
