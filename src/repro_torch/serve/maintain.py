"""Incremental medoid maintenance over a mutable corpus, the counterpart of
``repro/serve/maintain.py``.

The :class:`~repro_torch.serve.corpus.CorpusStore` mutation steps price the
mutated point against the whole corpus (one (1, cap) distance row) while
they update the exact centrality of every live slot, so after a mutation
whether the incumbent medoid survived is one scalar comparison.
:class:`MaintainedMedoid` runs that protocol:

* the exact argmin did not move -> keep the incumbent; the mutation cost
  one row, ``cap`` pulls, counted in :attr:`incremental_pulls`;
* a challenger beat the incumbent, or the deleted point was the medoid ->
  one full correlated-SH re-run on the current corpus version, through the
  same ragged programs as every other ragged query, under the key
  ``fold_in(key(seed), version)``: a from-scratch ``find_medoids_ragged``
  on this version's snapshot with that key gives the same answer.

With budgets in the exact regime (``budget_per_arm >= n_bucket *
ceil(log2 n_bucket)``) every served answer is the exact medoid of its
corpus version on data in general position (see the precision caveat of
:mod:`repro_torch.serve.corpus`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.bucketing import bucket_n
from repro_torch.core.corr_sh import ragged_medoids
from repro_torch.engine import rng
from repro_torch.engine.schedule import round_schedule, stop_round
from repro_torch.serve.corpus import CorpusStore


@dataclasses.dataclass(frozen=True)
class MedoidUpdate:
    """What one mutation did to the maintained answer."""
    version: int               # corpus version after the mutation
    medoid_slot: Optional[int]  # served incumbent (None: empty corpus)
    reran: bool                # True: full bandit re-run; False: kept
    pulls: int                 # distance evals charged to this mutation
    reason: str                # kept | challenger | deleted_incumbent |
    #                            bootstrap | emptied


class MaintainedMedoid:
    """The maintained medoid of a live :class:`CorpusStore`.

    ``query()`` is free: the incumbent slot is host state. Mutations go
    through :meth:`insert` / :meth:`delete`, which mutate the store and
    re-establish the incumbent per the protocol above; the pulls are split
    incremental and re-run.
    """

    def __init__(self, store: Optional[CorpusStore] = None, *,
                 d: Optional[int] = None, metric: str = "l2",
                 backend: str = "reference", budget_per_arm: int = 24,
                 min_bucket: Optional[int] = None, seed: int = 0,
                 device=None):
        if store is None:
            if d is None:
                raise ValueError("pass a CorpusStore or d= to build one")
            store = CorpusStore(d, metric=metric, backend=backend,
                                device=device,
                                **({} if min_bucket is None
                                   else {"min_bucket": min_bucket}))
        self.store = store
        self.budget_per_arm = int(budget_per_arm)
        self._key = rng.key(seed, store.device)
        self.medoid_slot: Optional[int] = None
        self.reruns = 0
        self.kept = 0
        self.queries = 0
        self.incremental_pulls = 0     # mutation rows
        self.rerun_pulls = 0           # scheduled pulls of full re-runs
        if store.n:
            # an adopted store's incumbent comes from the same re-run a
            # mutation would trigger
            self._rerun()

    def query(self) -> tuple[Optional[int], int]:
        """The maintained answer: ``(medoid slot, corpus version)``."""
        self.queries += 1
        return self.medoid_slot, self.store.version

    @property
    def pulls(self) -> int:
        """Total distance evaluations (bootstrap + mutations + re-runs)."""
        return (self.store.init_pulls + self.incremental_pulls
                + self.rerun_pulls)

    def insert(self, x) -> MedoidUpdate:
        """Insert one point; re-check (and only if dethroned, re-run)."""
        self.store.insert(x)
        return self._settle(deleted_incumbent=False)

    def delete(self, slot: int) -> MedoidUpdate:
        """Delete a live slot; a deleted incumbent always re-runs."""
        was_incumbent = slot == self.medoid_slot
        self.store.delete(slot)
        return self._settle(deleted_incumbent=was_incumbent)

    def _settle(self, *, deleted_incumbent: bool) -> MedoidUpdate:
        store = self.store
        pulls = store.capacity          # the mutation's exact row
        self.incremental_pulls += pulls
        if store.n == 0:
            self.medoid_slot = None
            return MedoidUpdate(store.version, None, False, pulls, "emptied")
        if deleted_incumbent:
            reason = "deleted_incumbent"
        elif self.medoid_slot is None:
            reason = "bootstrap"
        elif store.exact_medoid_slot != self.medoid_slot:
            reason = "challenger"
        else:
            self.kept += 1
            return MedoidUpdate(store.version, self.medoid_slot, False,
                                pulls, "kept")
        rerun_pulls = self._rerun()
        return MedoidUpdate(store.version, self.medoid_slot, True,
                            pulls + rerun_pulls, reason)

    def _rerun(self) -> int:
        """Full correlated-SH re-run on the current corpus version under
        ``fold_in(key(seed), version)``; returns its scheduled pulls."""
        store = self.store
        n = store.n
        order = store.live_slots()
        n_bucket = bucket_n(n, store.min_bucket)
        budget = self.budget_per_arm * n_bucket
        snap = store.gather(n_bucket)
        key = rng.fold_in(self._key, store.version)
        meds = ragged_medoids(snap[None], torch.tensor([n], dtype=torch.int32),
                              key, budget=budget, metric=store.metric,
                              backend=store.backend,
                              min_bucket=store.min_bucket)
        self.medoid_slot = int(order[int(meds[0])])
        rounds = round_schedule(n_bucket, budget)
        pulls = sum(r.pulls for r in rounds[: stop_round(rounds) + 1]) \
            if rounds else 0
        self.rerun_pulls += pulls
        self.reruns += 1
        return pulls

    def stats(self) -> dict:
        s = self.store.stats()
        mutations = s.inserts + s.deletes
        return {
            "n": s.n, "capacity": s.capacity, "version": s.version,
            "mutations": mutations, "kept": self.kept,
            "reruns": self.reruns, "queries": self.queries,
            "grows": s.grows,
            "incremental_pulls": self.incremental_pulls,
            "rerun_pulls": self.rerun_pulls,
            "init_pulls": s.init_pulls,
            "total_pulls": self.pulls,
            "medoid_slot": self.medoid_slot,
            "kept_frac": round(self.kept / mutations, 4) if mutations else 0.0,
        }
