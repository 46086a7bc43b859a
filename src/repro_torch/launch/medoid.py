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
answer came from the exact fp32 re-run). ``--compare`` adds the exact
medoid and RAND's answer with ``min(n, 1000)`` references (key
``fold_in(key(seed), 2)``), as the JAX CLI does.

``--ckpt-dir DIR`` saves the answer as the checkpoint of step 0 (``{"medoid":
...}`` with ``n``, ``metric`` and ``budget`` in its META, as the JAX CLI
writes it).

``--distributed`` runs the communication-optimal engine (v2) over every
process of a ``torchrun`` job, rows sharded over a one-dimensional mesh of
all of them (NCCL and one card a process, or gloo with ``--device cpu``);
rank 0 prints the line:
  torchrun --standalone --nproc_per_node 4 -m repro_torch.launch.medoid \
      -- --n 20000 --d 784 --backend pallas_fused --distributed --compare
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.api import find_medoid
from repro_torch.checkpoint import manager as ckpt
from repro_torch.convert import data_from_numpy, resolve_device
from repro_torch.core.backend import list_backends
from repro_torch.core.exact import exact_medoid
from repro_torch.core.rand import rand_medoid
from repro_torch.data.medoid_datasets import DATASETS, planted_medoid
from repro_torch.engine import rng
from repro_torch.engine.schedule import round_schedule, schedule_pulls


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _init_distributed(device) -> tuple:
    """The default process group (NCCL on the card, gloo on the CPU) from
    torchrun's environment, unless one is up already, and a one-dimensional
    mesh over all of it: (mesh, this process's device)."""
    from torch.distributed.device_mesh import init_device_mesh

    cpu = device is not None and torch.device(device).type == "cpu"
    if cpu:
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("gloo" if cpu else "nccl")
    mesh = init_device_mesh(dev.type, (dist.get_world_size(),),
                            mesh_dim_names=("data",))
    return mesh, dev


def run(n: int, d: int, metric: str, budget_per_arm: int, dataset: str, *,
        seed: int = 0, compare: bool = False, backend: str = "reference",
        device=None, precision: str = "fp32",
        distributed: bool = False, ckpt_dir: Optional[str] = None) -> dict:
    mesh = None
    if distributed:
        if precision != "fp32":
            raise ValueError("--precision requires the single-host engine; "
                             "run without --distributed")
        mesh, dev = _init_distributed(device)
    else:
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
    if mesh is not None:
        res = find_medoid(data, key, metric=metric, backend=backend,
                          budget_per_arm=budget_per_arm, mesh=mesh,
                          distributed_impl="v2")
        out["mode"] = f"distributed-v2 x{mesh.size()} ({backend})"
    else:
        res = find_medoid(data, key, metric=metric, backend=backend,
                          budget_per_arm=budget_per_arm, precision=precision)
        out["mode"] = backend
    _sync(dev)
    out["corrsh_s"] = round(time.perf_counter() - t0, 3)
    out["medoid"] = res.medoid
    if precision != "fp32":
        out["verified"] = res.verified
    if ckpt_dir and (mesh is None or dist.get_rank() == 0):
        ckpt.save(ckpt_dir, 0, {"medoid": torch.tensor(res.medoid,
                                                       dtype=torch.int32)},
                  extra={"n": n, "metric": metric, "budget": budget})
    if compare:
        t0 = time.perf_counter()
        truth = int(exact_medoid(data, metric))
        out["exact"] = truth
        out["exact_s"] = round(time.perf_counter() - t0, 3)
        out["correct"] = truth == res.medoid
        t0 = time.perf_counter()
        out["rand"] = int(rand_medoid(data, rng.fold_in(rng.key(seed, dev), 2),
                                      num_refs=min(n, 1000), metric=metric))
        _sync(dev)
        out["rand_s"] = round(time.perf_counter() - t0, 3)
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
    ap.add_argument("--distributed", action="store_true",
                    help="the v2 engine over every process of a torchrun "
                         "job (rank 0 prints)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="save {'medoid'} as a step-0 checkpoint there")
    ap.add_argument("--device", default=None,
                    help="cuda (the default when present) or cpu")
    argv = sys.argv[1:] if argv is None else list(argv)
    # torchrun needs "--" before a script argument that abbreviates one of
    # its own options (--n: --nnodes, --nproc-per-node), and some versions
    # pass the "--" on
    args = ap.parse_args(argv[1:] if argv[:1] == ["--"] else argv)
    out = run(args.n, args.d, args.metric, args.budget_per_arm, args.dataset,
              seed=args.seed, compare=args.compare, backend=args.backend,
              device=args.device, precision=args.precision,
              distributed=args.distributed, ckpt_dir=args.ckpt_dir)
    if not args.distributed or dist.get_rank() == 0:
        print(json.dumps(out))
    if args.distributed:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
