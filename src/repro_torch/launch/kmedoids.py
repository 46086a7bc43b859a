"""Bandit k-medoids CLI of the port: one clustering job on the card (or the
CPU), one JSON line with the keys of ``repro.launch.kmedoids`` that apply.

The data comes from ``CLUSTER_DATASETS`` (numpy, ``--seed``) with its
planted labels; the job's key is ``fold_in(key(seed), 1)``, as in the JAX
CLI. ``--compare`` also runs exact PAM (``n^2`` distances: keep n modest)
and reports ``cost_vs_pam`` and the ARI against it.

Example (on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.kmedoids --device cpu \
      --n 300 --d 16 --k 4 --dataset planted --compare
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.api import KMedoidsConfig, kmedoids
from repro_torch.cluster import adjusted_rand_index, pam_exact, pam_pulls
from repro_torch.convert import data_from_numpy, resolve_device
from repro_torch.core.backend import list_backends
from repro_torch.data.medoid_datasets import CLUSTER_DATASETS
from repro_torch.engine import rng
from repro_torch.launch.medoid import _sync


def run(n: int, d: int, k: int, dataset: str, *, metric: str = "",
        backend: str = "reference", seed: int = 0,
        build_budget_per_arm: int = 16, swap_budget_per_arm: int = 16,
        refine_budget_per_arm: int = 20, refine_sweeps: int = 1,
        max_swap_rounds: int = 8, compare: bool = False,
        device=None) -> dict:
    if dataset not in CLUSTER_DATASETS:
        raise ValueError(f"unknown dataset {dataset!r}; "
                         f"one of {sorted(CLUSTER_DATASETS)}")
    dev = resolve_device(device)
    ds_metric, gen = CLUSTER_DATASETS[dataset]
    metric = metric or ds_metric
    arr, labels = gen(seed, n, d, k)
    data = data_from_numpy(arr, dev)
    cfg = KMedoidsConfig(metric=metric, backend=backend,
                         build_budget_per_arm=build_budget_per_arm,
                         swap_budget_per_arm=swap_budget_per_arm,
                         refine_budget_per_arm=refine_budget_per_arm,
                         refine_sweeps=refine_sweeps,
                         max_swap_rounds=max_swap_rounds)
    _sync(dev)
    t0 = time.perf_counter()
    res = kmedoids(data, k, rng.fold_in(rng.key(seed, dev), 1), config=cfg)
    _sync(dev)
    wall = time.perf_counter() - t0

    out = {
        "n": n, "d": d, "k": k, "dataset": dataset, "metric": metric,
        "backend": backend, "mode": "direct", "device": str(dev),
        "medoids": res.medoids, "cost": round(res.cost, 3),
        "ari": round(adjusted_rand_index(res.labels, labels), 4),
        "pulls": res.pulls,
        "pulls_breakdown": {"build": res.build_pulls,
                            "assign": res.assign_pulls,
                            "refine": res.refine_pulls,
                            "swap": res.swap_pulls},
        "swaps": res.swaps, "refine_updates": res.refine_updates,
        "pam_pulls": pam_pulls(n),
        "pulls_ratio": round(pam_pulls(n) / max(1, res.pulls), 2),
        "wall_s": round(wall, 2),
    }
    if compare:
        t0 = time.perf_counter()
        pam = pam_exact(data, k, metric)
        out["pam"] = {
            "medoids": pam.medoids, "cost": round(pam.cost, 3),
            "ari": round(adjusted_rand_index(pam.labels, labels), 4),
            "swaps": pam.swaps,
            "wall_s": round(time.perf_counter() - t0, 2),
        }
        out["cost_vs_pam"] = round(res.cost / max(pam.cost, 1e-12), 4)
        out["ari_vs_pam"] = round(
            adjusted_rand_index(res.labels, pam.labels), 4)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--dataset", default="rnaseq_like",
                    choices=sorted(CLUSTER_DATASETS))
    ap.add_argument("--metric", default="",
                    choices=["", "l1", "l2", "sql2", "cosine"])
    ap.add_argument("--backend", default="reference",
                    choices=list(list_backends()))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--build-budget-per-arm", type=int, default=16)
    ap.add_argument("--swap-budget-per-arm", type=int, default=16)
    ap.add_argument("--refine-budget-per-arm", type=int, default=20)
    ap.add_argument("--refine-sweeps", type=int, default=1)
    ap.add_argument("--max-swap-rounds", type=int, default=8)
    ap.add_argument("--compare", action="store_true",
                    help="also run exact PAM (O(n^2): keep n modest)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default when present) or cpu")
    args = ap.parse_args(argv)
    print(json.dumps(run(
        args.n, args.d, args.k, args.dataset, metric=args.metric,
        backend=args.backend, seed=args.seed,
        build_budget_per_arm=args.build_budget_per_arm,
        swap_budget_per_arm=args.swap_budget_per_arm,
        refine_budget_per_arm=args.refine_budget_per_arm,
        refine_sweeps=args.refine_sweeps,
        max_swap_rounds=args.max_swap_rounds,
        compare=args.compare, device=args.device)))


if __name__ == "__main__":
    main()
