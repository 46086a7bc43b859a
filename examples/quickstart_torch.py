"""Quickstart of the PyTorch port: find the medoid of a dataset 30-100x
cheaper than exact, on an NVIDIA card (``--cpu`` runs a smaller dataset on
the CPU instead).

    PYTHONPATH=src python examples/quickstart_torch.py [--cpu]
"""
import argparse
import time

import torch

from repro_torch.api import find_medoid, find_medoids_batch
from repro_torch.convert import data_from_numpy
from repro_torch.core.exact import exact_medoid
from repro_torch.core.hardness import hardness_stats
from repro_torch.data.medoid_datasets import rnaseq_like
from repro_torch.engine import rng


def _timed(dev, fn):
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU at n=256, d=64")
    args = ap.parse_args(argv)
    dev = torch.device("cpu" if args.cpu else "cuda")
    n, d = (256, 64) if args.cpu else (2048, 512)
    print(f"generating RNA-Seq-like dataset: n={n}, d={d} (l1 metric) on "
          f"{dev}")
    data = data_from_numpy(rnaseq_like(0, n, d), dev)
    key = rng.key(1, dev)

    res, t_corr = _timed(dev, lambda: find_medoid(
        data, key, metric="l1", budget_per_arm=24))  # ~24 evals per point
    medoid, pulls = res.medoid, res.pulls
    print(f"corrSH:  medoid={medoid}   pulls={pulls:,} "
          f"({pulls / n:.1f}/arm)  {t_corr:.2f}s")

    truth, t_exact = _timed(dev, lambda: int(exact_medoid(data, "l1")))
    print(f"exact:   medoid={truth}   pulls={n * n:,} "
          f"({n}/arm)  {t_exact:.2f}s")
    print(f"correct: {medoid == truth}   "
          f"pull reduction: {n * n / pulls:.0f}x   "
          f"speedup: {t_exact / max(t_corr, 1e-9):.1f}x")

    hs = hardness_stats(data, "l1")
    print(f"hardness: sigma={float(hs.sigma):.3f}  "
          f"H2={float(hs.h2):.3g}  H2~={float(hs.h2_tilde):.3g}  "
          f"ratio={float(hs.h2 / hs.h2_tilde):.1f} "
          f"(the paper's predicted correlation gain)")

    # The same algorithm on the fused backend: on the card each round's
    # (s_r, t_r) distance block is reduced inside the l1_centrality kernel
    # and never reaches device memory.
    m_fused = find_medoid(data, key, metric="l1", budget_per_arm=24,
                          backend="pallas_fused").medoid
    print(f"pallas_fused backend: medoid={m_fused} "
          f"(agrees: {m_fused == medoid})")

    # The paper's baselines behind the same call: Med-dit (UCB, independent
    # references; a CUDA graph of masked steps on the card) and RAND
    # (budget_per_arm uniform references for every point).
    for algo in ("meddit", "rand"):
        r, t = _timed(dev, lambda: find_medoid(data, key, metric="l1",
                                               algo=algo, budget_per_arm=24))
        print(f"{algo + ':':8} medoid={r.medoid}   pulls={r.pulls:,} "
              f"({r.pulls / n:.1f}/arm)  correct: {r.medoid == truth}  "
              f"{t:.2f}s")

    # Batched multi-query engine: B candidate sets -> B medoids.
    b, nb = 4, 256
    sets = torch.randn(b, nb, 32, generator=torch.Generator().manual_seed(2))
    batch_medoids, t = _timed(dev, lambda: find_medoids_batch(
        sets.to(dev), rng.key(3, dev), metric="l2", budget_per_arm=24))
    print(f"batched: {b} queries of n={nb} -> "
          f"{[int(m) for m in batch_medoids]}  {t:.2f}s")


if __name__ == "__main__":
    main()
