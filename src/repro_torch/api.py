"""The public facade of the port, the counterpart of ``repro/api.py`` for one
query::

    from repro_torch.api import MedoidConfig, find_medoid

    res = find_medoid(data, key)                          # MedoidResult
    res = find_medoid(data, key, backend="pallas_fused", budget_per_arm=32)

``data`` is a torch tensor (it keeps its device) or anything numpy takes (it
goes to CUDA); ``device=`` overrides both, and ``device="cpu"`` runs the
plain-torch path on the CPU. Without CUDA and without ``device`` a numpy
input raises. ``key`` is a :class:`repro_torch.engine.rng.Key`
(``rng.key(seed)``, or :func:`repro_torch.convert.key_from_jax_data` for a
JAX key); ``None`` means ``rng.key(config.seed)``.

Ported so far: ``algo="corr_sh"`` (the paper's Algorithm 1) and
``algo="exact"``, fp32 only, without telemetry. The other algorithms and
options raise ``ValueError`` naming the ROADMAP queue that holds them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.convert import data_from_numpy, resolve_device
from repro_torch.core.corr_sh import _medoid_impl
from repro_torch.core.exact import exact_medoid
from repro_torch.engine import rng
from repro_torch.engine.schedule import round_schedule, stop_round

ALGOS = ("corr_sh", "meddit", "rand", "exact")

__all__ = ["ALGOS", "MedoidConfig", "MedoidResult", "find_medoid"]


@dataclass(frozen=True)
class MedoidConfig:
    """How a medoid query runs; the fields of ``repro.api.MedoidConfig``.
    ``budget = budget_per_arm * n``. ``min_bucket`` and
    ``quant_error_model`` belong to the ragged and quantized paths, which
    are not ported yet."""
    metric: str = "l2"
    backend: str = "reference"
    budget_per_arm: int = 24
    algo: str = "corr_sh"
    min_bucket: int = 8
    seed: int = 0          # key when the caller passes none
    telemetry: bool = False
    precision: str = "fp32"
    quant_error_model: str = "probe"


@dataclass(frozen=True)
class MedoidResult:
    """One answered medoid query: the winning index plus exact (scheduled)
    pull accounting and the executed round plan (survivors, num_refs)."""
    medoid: int
    pulls: int
    n: int
    algo: str
    metric: str
    backend: str
    rounds: tuple = ()
    telemetry: Optional[dict] = None
    precision: str = "fp32"
    verified: Optional[bool] = None
    hardness: Optional[dict] = None


def _resolve(config, overrides):
    cfg = config if config is not None else MedoidConfig()
    if not isinstance(cfg, MedoidConfig):
        raise TypeError(f"config must be a MedoidConfig, got {type(cfg)!r}")
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def _check_ported(cfg: MedoidConfig) -> None:
    if cfg.algo not in ALGOS:
        raise ValueError(f"unknown algo {cfg.algo!r}; one of {ALGOS}")
    if cfg.algo in ("meddit", "rand"):
        raise ValueError(f"algo={cfg.algo!r} is not ported to repro_torch "
                         "yet: see ROADMAP Queue 1 item 7")
    if cfg.telemetry:
        raise ValueError("telemetry=True is not ported to repro_torch yet: "
                         "see ROADMAP Queue 1 item 10")
    if cfg.precision != "fp32":
        raise ValueError(f"precision={cfg.precision!r} is not ported to "
                         "repro_torch yet (only 'fp32'): see ROADMAP Queue 1 "
                         "item 9")


def find_medoid(data, key: Optional[rng.Key] = None, *,
                config: Optional[MedoidConfig] = None, device=None,
                **overrides) -> MedoidResult:
    """Find the medoid of ``data (n, d)`` — the paper's correlated
    sequential halving on the configured backend (``algo="corr_sh"``), or
    the exact O(n^2) oracle (``algo="exact"``)."""
    cfg = _resolve(config, overrides)
    _check_ported(cfg)
    dev = resolve_device(device, data)
    if isinstance(data, torch.Tensor):
        data = data.to(device=dev, dtype=torch.float32).contiguous()
    else:
        data = data_from_numpy(data, dev)
    if data.ndim != 2:
        raise ValueError(f"expected (n, d) data, got shape {tuple(data.shape)}")
    n = int(data.shape[0])
    key = rng.key(cfg.seed, dev) if key is None else key.to(dev)
    budget = cfg.budget_per_arm * n

    if cfg.algo == "exact":
        return MedoidResult(medoid=int(exact_medoid(data, cfg.metric)),
                            pulls=n * n, n=n, algo="exact",
                            metric=cfg.metric, backend=cfg.backend)
    if n == 1:
        return MedoidResult(medoid=0, pulls=0, n=1, algo="corr_sh",
                            metric=cfg.metric, backend=cfg.backend)
    medoid = int(_medoid_impl(data, key, budget=budget, metric=cfg.metric,
                              backend=cfg.backend))
    rounds = round_schedule(n, budget)
    executed = rounds[: stop_round(rounds) + 1]
    return MedoidResult(medoid=medoid,
                        pulls=sum(r.pulls for r in executed), n=n,
                        algo="corr_sh", metric=cfg.metric,
                        backend=cfg.backend,
                        rounds=tuple((r.survivors, r.num_refs)
                                     for r in executed))
