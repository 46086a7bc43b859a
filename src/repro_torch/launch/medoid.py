"""Medoid CLI of the port: one correlated-SH query on the card (or the CPU).

Prints one JSON line with the keys of ``repro.launch.medoid`` that apply to
the port. The data comes from numpy with ``--seed``; the query key is
``fold_in(key(seed), 1)``, as in the JAX CLI.

Example (the README's command, on the card):
  PYTHONPATH=src python -m repro_torch.launch.medoid --n 4096 --d 512 \
      --metric l1 --budget-per-arm 30 --dataset rnaseq20k_like \
      --backend pallas_fused --compare

``--precision bf16`` or ``int8`` runs the quantized path; the line then
carries ``verified`` (true: the quantized certificate held; false: the
answer came from the exact fp32 re-run).
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.api import find_medoid
from repro_torch.convert import data_from_numpy, resolve_device
from repro_torch.core.backend import list_backends
from repro_torch.core.exact import exact_medoid
from repro_torch.data.medoid_datasets import DATASETS, planted_medoid
from repro_torch.engine import rng
from repro_torch.engine.schedule import round_schedule, schedule_pulls


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(n: int, d: int, metric: str, budget_per_arm: int, dataset: str, *,
        seed: int = 0, compare: bool = False, backend: str = "reference",
        device=None, precision: str = "fp32") -> dict:
    dev = resolve_device(device)
    if dataset in DATASETS:
        metric = metric or DATASETS[dataset][0]
        arr = DATASETS[dataset][1](seed, n, d)
    else:
        metric = metric or "l2"
        arr = planted_medoid(seed, n, d)
    data = data_from_numpy(arr, dev)
    key = rng.fold_in(rng.key(seed, dev), 1)

    budget = budget_per_arm * n
    out = {"n": n, "d": d, "metric": metric, "budget": budget,
           "backend": backend, "precision": precision, "device": str(dev),
           "pulls_scheduled": schedule_pulls(n, budget),
           "rounds": [(r.survivors, r.num_refs)
                      for r in round_schedule(n, budget)]}
    _sync(dev)
    t0 = time.perf_counter()
    res = find_medoid(data, key, metric=metric, backend=backend,
                      budget_per_arm=budget_per_arm, precision=precision)
    _sync(dev)
    out["corrsh_s"] = round(time.perf_counter() - t0, 3)
    out["mode"] = backend
    out["medoid"] = res.medoid
    if precision != "fp32":
        out["verified"] = res.verified
    if compare:
        t0 = time.perf_counter()
        truth = int(exact_medoid(data, metric))
        out["exact"] = truth
        out["exact_s"] = round(time.perf_counter() - t0, 3)
        out["correct"] = truth == res.medoid
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--d", type=int, default=512)
    ap.add_argument("--metric", default="",
                    choices=["", "l1", "l2", "sql2", "cosine"])
    ap.add_argument("--budget-per-arm", type=int, default=30)
    ap.add_argument("--dataset", default="planted",
                    choices=["planted"] + list(DATASETS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="reference",
                    choices=list(list_backends()))
    ap.add_argument("--precision", default="fp32",
                    choices=["fp32", "bf16", "int8"],
                    help="distance precision: quantized distances with "
                         "margin-widened halving and an exact fp32 check of "
                         "the finalists (answers stay fp32-exact)")
    ap.add_argument("--compare", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default when present) or cpu")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.n, args.d, args.metric, args.budget_per_arm,
                         args.dataset, seed=args.seed, compare=args.compare,
                         backend=args.backend, device=args.device,
                         precision=args.precision)))


if __name__ == "__main__":
    main()
