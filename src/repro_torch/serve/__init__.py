"""Live corpus serving of the port, the counterpart of ``repro.serve``:

* :mod:`repro_torch.serve.corpus` — :class:`CorpusStore`, a versioned point
  store on the device (slot freelist inside power-of-two capacity buckets;
  each mutation one cached corpus program of
  :mod:`repro_torch.engine.programs`);
* :mod:`repro_torch.serve.maintain` — :class:`MaintainedMedoid`: a mutation
  re-checks the incumbent with one exact distance row and re-runs
  ``run_halving`` only when the incumbent was dethroned or deleted;
* :mod:`repro_torch.serve.scheduler` — FIFO and earliest-deadline-first
  policies with load shedding, behind ``MedoidServer(policy=...)``;
* :mod:`repro_torch.serve.stream` — the mutation-stream driver
  (``python -m repro_torch.serve.stream``).
"""
from __future__ import annotations

from repro_torch.serve.corpus import CorpusStore
from repro_torch.serve.maintain import MaintainedMedoid, MedoidUpdate
from repro_torch.serve.scheduler import (POLICIES, EdfPolicy, FifoPolicy,
                                         LatencyModel, resolve_policy)

__all__ = [
    "CorpusStore", "EdfPolicy", "FifoPolicy", "LatencyModel",
    "MaintainedMedoid", "MedoidUpdate", "POLICIES", "resolve_policy",
]
