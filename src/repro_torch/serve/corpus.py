"""Versioned mutable corpus store on the device, the counterpart of
``repro/serve/corpus.py``.

A :class:`CorpusStore` owns three device tensors sized to a power-of-two
*capacity* bucket (:func:`repro_torch.core.bucketing.bucket_n`):

* ``buf (cap, d)`` — the point rows (dead rows keep stale data, masked
  everywhere);
* ``cent (cap,)`` — the exact summed distance of each live slot to every
  live slot (+inf at dead slots), maintained incrementally;
* ``alive (cap,)`` — the live mask.

The host keeps a slot freelist and a copy of the live mask, so a mutation
never reads the device to find its row. Every mutation step
(:func:`repro_torch.engine.programs.corpus_insert_program` /
``corpus_delete_program``) acts on the full capacity bucket, so a mutation
stream inside one bucket builds nothing new (the ``"corpus"`` trace
odometer of :mod:`repro_torch.engine.instrument` stays flat). When the
freelist runs dry the bucket doubles.

Each mutation costs one (1, cap) distance row (``cap`` pulls, counted in
:attr:`CorpusStore.mutation_pulls`) and updates the exact centrality of
every live point — what :mod:`repro_torch.serve.maintain` needs to check
its incumbent without re-running the bandit. ``version`` counts mutations.

The store owns its device: ``device`` (CUDA unless ``"cpu"`` is asked;
without CUDA and without ``device`` it raises), and points handed to it move
there whatever their own device.

Precision caveat: centralities accumulate in float32 (add a row on insert,
subtract it on delete), so after many mutations a stored centrality can
differ from a fresh sum by cancellation residue (~1e-3 relative in long
streams). On data in general position the winner is unaffected; under
exact ties or near-ties inside that residue the argmin may differ from a
from-scratch recompute — the served point is then an eps-exact medoid.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.convert import resolve_device
from repro_torch.core.backend import get_backend
from repro_torch.core.bucketing import DEFAULT_MIN_BUCKET, bucket_n
from repro_torch.core.distances import METRICS
from repro_torch.engine import instrument, programs


@dataclasses.dataclass(frozen=True)
class CorpusStats:
    """One snapshot of a store's accounting."""
    n: int                      # live points
    capacity: int               # power-of-two slot bucket
    version: int                # mutations applied so far
    inserts: int
    deletes: int
    grows: int                  # capacity doublings
    mutation_pulls: int         # distance evals spent on mutations
    init_pulls: int             # one-time bootstrap distance evals


def _points(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, dtype=np.float32)).to(device)


class CorpusStore:
    """A mutable, versioned point store with exact incremental centralities.

    ``insert`` returns a stable integer **slot id**, the handle every answer
    speaks in. Slots are recycled through the freelist (lowest free slot
    first, so replayed streams hit the same slot sequence).
    """

    def __init__(self, d: int, *, metric: str = "l2",
                 backend: str = "reference",
                 min_bucket: int = DEFAULT_MIN_BUCKET,
                 capacity: Optional[int] = None,
                 precision: str = "fp32", device=None):
        if d < 1:
            raise ValueError(f"need d >= 1, got {d}")
        if metric not in METRICS:
            raise ValueError(f"unknown metric {metric!r}; one of {METRICS}")
        if precision != "fp32":
            # A quantized store: the bootstrap, the mutation rows and the
            # re-runs (which use store.backend) all take the quantized
            # backend, and the caveat above applies on top of the
            # quantization error.
            from repro_torch import quant
            backend = quant.backend_for(precision, base=backend)
        get_backend(backend)            # fail at construction
        self.device = resolve_device(device)
        self.d = int(d)
        self.metric = metric
        self.backend = backend
        self.precision = precision
        self.min_bucket = int(min_bucket)
        cap = bucket_n(max(1, int(capacity or min_bucket)), self.min_bucket)
        self.buf = torch.zeros((cap, self.d), dtype=torch.float32,
                               device=self.device)
        self.cent = torch.full((cap,), torch.inf, dtype=torch.float32,
                               device=self.device)
        self.alive = torch.zeros((cap,), dtype=torch.bool, device=self.device)
        self._alive_host = np.zeros((cap,), bool)
        self._free: list[int] = list(range(cap - 1, -1, -1))  # pop() -> 0
        self._winner = None             # 0-d device tensor: argmin(cent)
        self.version = 0
        self.inserts = self.deletes = self.grows = 0
        self.mutation_pulls = 0
        self.init_pulls = 0

    @classmethod
    def from_points(cls, data, **kwargs) -> "CorpusStore":
        """A store holding ``data (n, d)`` in slots ``0..n-1``, its exact
        centralities seeded by one (cap, cap) bootstrap block (every
        mutation after it costs one (1, cap) row)."""
        dev = resolve_device(kwargs.pop("device", None))
        data = _points(data, dev)
        if data.ndim != 2:
            raise ValueError(f"expected (n, d) data, got shape "
                             f"{tuple(data.shape)}")
        n = int(data.shape[0])
        store = cls(int(data.shape[1]), device=dev,
                    capacity=max(n, kwargs.pop("capacity", 0) or 0), **kwargs)
        if n:
            cap = store.capacity
            store.buf[:n] = data
            store.alive[:n] = True
            store._alive_host[:n] = True
            store._free = list(range(cap - 1, n - 1, -1))
            fn = programs.corpus_init_program(metric=store.metric,
                                              backend=store.backend)
            instrument.note_dispatch("corpus")
            store.cent, store._winner = fn(store.buf, store.alive)
            store.init_pulls = cap * cap
        return store

    @property
    def capacity(self) -> int:
        return int(self.buf.shape[0])

    @property
    def n(self) -> int:
        return int(self._alive_host.sum())

    def is_live(self, slot: int) -> bool:
        return 0 <= slot < self.capacity and bool(self._alive_host[slot])

    @property
    def exact_medoid_slot(self) -> Optional[int]:
        """Slot of the exact medoid of the current version (one scalar read
        from the device; None for an empty store)."""
        if self.n == 0 or self._winner is None:
            return None
        return int(self._winner)

    def live_slots(self) -> np.ndarray:
        """Live slot ids, ascending: the store's snapshot order."""
        return np.flatnonzero(self._alive_host)

    def snapshot(self) -> np.ndarray:
        """Host copy of the live points in slot order."""
        return self.buf.cpu().numpy()[self._alive_host]

    def gather(self, n_bucket: int) -> torch.Tensor:
        """The live rows as a dense ``(n_bucket, d)`` prefix (index 0 past
        ``n``), the form the ragged programs take."""
        order = self.live_slots()
        if n_bucket < order.size:
            raise ValueError(f"n_bucket={n_bucket} < live count {order.size}")
        idx = np.zeros((n_bucket,), np.int64)
        idx[: order.size] = order
        instrument.note_dispatch("corpus")
        return programs.corpus_gather_program()(
            self.buf, torch.from_numpy(idx).to(self.device))

    def insert(self, x) -> int:
        """Insert one ``(d,)`` point; returns its slot id. Doubles the
        capacity first if the freelist is dry."""
        x = _points(x, self.device)
        if tuple(x.shape) != (self.d,):
            raise ValueError(f"expected a ({self.d},) point, got "
                             f"{tuple(x.shape)}")
        if not self._free:
            self._grow()
        slot = self._free.pop()
        fn = programs.corpus_insert_program(metric=self.metric,
                                            backend=self.backend)
        instrument.note_dispatch("corpus")
        self._winner = fn(self.buf, self.cent, self.alive, x, slot)
        self._alive_host[slot] = True
        self.mutation_pulls += self.capacity
        self.inserts += 1
        self.version += 1
        return slot

    def delete(self, slot: int) -> None:
        """Delete a live slot (its id returns to the freelist)."""
        slot = int(slot)
        if not self.is_live(slot):
            raise ValueError(f"slot {slot} is not live")
        fn = programs.corpus_delete_program(metric=self.metric,
                                            backend=self.backend)
        instrument.note_dispatch("corpus")
        self._winner = fn(self.buf, self.cent, self.alive, slot)
        self._alive_host[slot] = False
        self._free.append(slot)
        self.mutation_pulls += self.capacity
        self.deletes += 1
        self.version += 1

    def _grow(self) -> None:
        cap = self.capacity
        instrument.note_dispatch("corpus")
        self.buf, self.cent, self.alive = programs.corpus_grow_program()(
            self.buf, self.cent, self.alive)
        self._alive_host = np.concatenate(
            [self._alive_host, np.zeros((cap,), bool)])
        # new slots go under the existing free ids: the lowest still pops
        # first
        self._free = list(range(2 * cap - 1, cap - 1, -1)) + self._free
        self.grows += 1

    def stats(self) -> CorpusStats:
        return CorpusStats(n=self.n, capacity=self.capacity,
                           version=self.version, inserts=self.inserts,
                           deletes=self.deletes, grows=self.grows,
                           mutation_pulls=self.mutation_pulls,
                           init_pulls=self.init_pulls)
