"""Serve a small model with continuous batching, plus the batched medoid
engine as a sidecar service: the PyTorch port of ``examples/serve_lm.py``,
on an NVIDIA card (``--cpu`` runs on the CPU instead).

LM serving and medoid identification share the serving pattern: many
independent queries, one device dispatch. ``--medoid-batch B`` answers B
"representative selection" queries (each: pick the medoid of a candidate
embedding set, e.g. for prompt-cache clustering or retrieval dedup) in a
single ``repro_torch.api.find_medoids_batch`` call on the selected distance
backend (``pallas_fused``: the ``dot_centrality`` kernel on the card).

    PYTHONPATH=src python examples/serve_lm_torch.py --cpu --medoid-batch 4
"""
import argparse
import json
import time

import torch

from repro_torch.api import find_medoids_batch
from repro_torch.convert import resolve_device
from repro_torch.core.backend import list_backends
from repro_torch.engine import rng
from repro_torch.launch.serve import Request, Server, prompts


def serve_medoid_queries(batch: int, backend: str, *, n: int = 512,
                         d: int = 64, budget_per_arm: int = 24,
                         seed: int = 0, device=None) -> dict:
    """Answer ``batch`` independent cosine medoid queries of (n, d) normal
    rows in one dispatch (the reference's sets: ``normal(fold_in(key(seed),
    1), (batch, n, d))``, key ``fold_in(key(seed), 2)``)."""
    dev = resolve_device(device)
    key = rng.key(seed, dev)
    sets = rng.normal(rng.fold_in(key, 1), (batch, n, d))
    t0 = time.time()
    medoids = find_medoids_batch(sets, rng.fold_in(key, 2),
                                 budget_per_arm=budget_per_arm,
                                 metric="cosine", backend=backend)
    medoids = [int(m) for m in medoids]
    return {"queries": batch, "n": n, "d": d, "backend": backend,
            "medoids": medoids, "batch_s": round(time.time() - t0, 3)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--medoid-batch", type=int, default=0,
                    help="also serve B batched medoid queries")
    ap.add_argument("--medoid-backend", default="pallas_fused",
                    choices=list(list_backends()))
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    dev = torch.device("cpu" if args.cpu else "cuda")

    srv = Server(args.arch, smoke=True, batch_slots=3, max_len=96, device=dev)
    reqs = [Request(rid=i, prompt=p, max_new=args.max_new)
            for i, p in enumerate(prompts(args.requests, 12,
                                          srv.cfg.vocab_size, dev, seed=0))]
    stats = srv.run(reqs)
    print(json.dumps(stats, indent=2))
    for r in reqs:
        print(f"request {r.rid}: generated {r.out}")

    if args.medoid_batch > 0:
        out = serve_medoid_queries(args.medoid_batch, args.medoid_backend,
                                   device=dev)
        print("medoid sidecar:", json.dumps(out))


if __name__ == "__main__":
    main()
