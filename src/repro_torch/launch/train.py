"""End-to-end training driver.

The port of ``repro.launch.train``: it streams the deterministic data
pipeline, takes train steps, checkpoints atomically in the reference's
format (a checkpoint that ``repro.launch.train`` wrote resumes here, and
the other way round), auto-resumes from the latest checkpoint, restarts
through ``run_with_restarts`` and records straggler statistics.

Under an initialised ``torch.distributed`` world (any size, NCCL or gloo)
it runs the reference's sharded path: the mesh from the live rank count
(``elastic_remesh``, tp = min(16, world)), the weights on
the dry run's ``param_specs`` as DTensors, the moments (and compression
residuals) on the same specs, each batch drawn alike on every rank and
kept by ``batch_specs``, the step under the mesh's logical rules, a
resume placed onto the current mesh (``restore(shardings=)``) whatever
mesh wrote the checkpoint. Without a process group it runs on one device.
Runs on CUDA unless ``device`` (``--device``) says otherwise; under NCCL
on the rank's current card.

Examples (CPU, reduced config):
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
      --smoke --device cpu --steps 50 --batch 8 --seq-len 128 \\
      --ckpt-dir build/ckpt
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
      -m repro_torch.launch.train --arch internlm2-1.8b --smoke \\
      --device cpu --steps 50 --batch 8 --seq-len 128 --ckpt-dir build/ckpt
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import Optional

import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import InputShape
from repro_torch.configs.registry import ARCH_NAMES, input_specs
from repro_torch.convert import (load_train_state, resolve_device,
                                 train_state_tree)
from repro_torch.data.pipeline import DataCfg, batch_at
from repro_torch.launch import partition
from repro_torch.launch.mesh import logical_rules
from repro_torch.models.model import build_model
from repro_torch.models.sharding import (P, NamedSharding, distribute,
                                         local_value, logical_axis_rules)
from repro_torch.optim import adamw
from repro_torch.optim.compress import EFState
from repro_torch.runtime.fault_tolerance import (StepWatchdog,
                                                 elastic_remesh,
                                                 run_with_restarts)
from repro_torch.train.train_step import (TrainCfg, TrainState,
                                          init_train_state, make_train_step)


def train(arch: str, *, smoke: bool = True, steps: int = 50,
          batch_size: int = 8, seq_len: int = 128,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 20,
          tcfg: Optional[TrainCfg] = None, grad_compression: bool = False,
          log_every: int = 10, device=None) -> dict:
    """Train ``arch`` (its smoke config with ``smoke``) to ``steps`` on
    ``device`` (CUDA unless asked otherwise) and return the reference's
    summary (``final_loss``, ``first_loss``, ``stragglers``, ``steps``)
    plus this run's ``start_step``, ``mesh`` (its shape, None on one
    device) and, a step each, ``losses``, ``grad_norms`` and ``step_s``
    (wall seconds to the loss on the host)."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    dist = torch.distributed
    mesh = None
    if dist.is_available() and dist.is_initialized():
        mesh = elastic_remesh(preferred_tp=min(16, dist.get_world_size()))
    if mesh is not None and device is None:
        device = torch.device(mesh.device_type,
                              torch.cuda.current_device()) \
            if mesh.device_type == "cuda" else mesh.device_type
    dev = resolve_device(device)
    shape = InputShape("custom", seq_len, batch_size, "train")
    model = build_model(cfg)
    tcfg = tcfg or TrainCfg(peak_lr=1e-3, warmup_steps=max(2, steps // 10),
                            total_steps=steps, remat=True,
                            grad_compression=grad_compression)
    step_fn = make_train_step(model, tcfg)

    # ---- init or resume ----------------------------------------------------
    start_step = 0
    state = init_train_state(model, 42, tcfg, device=dev)
    shardings = bspecs = None
    scope = contextlib.nullcontext
    if mesh is not None:
        specs = partition.param_specs(state.params, cfg, mesh)
        state = shard_train_state(state, specs, mesh)
        shardings = _stacked_shardings(cfg, state, specs, mesh)
        bspecs = partition.shardings(partition.batch_specs(
            input_specs(cfg, shape), mesh), mesh)
        rules = logical_rules(mesh)

        @contextlib.contextmanager
        def scope():
            with implicit_replication(), logical_axis_rules(rules):
                yield

    def restore():
        tree, meta = ckpt.restore(ckpt_dir, _restore_target(cfg, state),
                                  shardings=shardings)
        load_train_state(cfg, state, tree)
        return meta["step"]

    if ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        start_step = restore()
        print(f"# resumed from step {start_step}", file=sys.stderr)

    watchdog = StepWatchdog()
    losses, norms, secs = [], [], []
    saved = [None]

    def do_step(t: int) -> int:
        nonlocal state
        b = batch_at(cfg, shape, t, DataCfg(), dev)
        if bspecs is not None:
            b = {k: distribute(v, bspecs[k]) for k, v in b.items()}
        t0 = time.time()
        with scope():
            state, metrics = step_fn(state, b)
        loss = float(local_value(metrics["loss"]))
        dt = time.time() - t0
        straggler = watchdog.record(dt)
        losses.append(loss)
        norms.append(float(local_value(metrics["grad_norm"])))
        secs.append(dt)
        if t % log_every == 0:
            print(json.dumps({"step": t, "loss": round(loss, 4),
                              "sec": round(dt, 3),
                              "straggler": straggler}), file=sys.stderr)
        if ckpt_dir and (t + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, t + 1, train_state_tree(cfg, state, True))
            saved[0] = t + 1
        return t + 1

    def on_restart(step_, exc):
        print(f"# restart after {type(exc).__name__} at step {step_}",
              file=sys.stderr)
        if ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
            return restore()
        return step_

    run_with_restarts(do_step, start_step=start_step, total_steps=steps,
                      on_restart=on_restart)
    # the final state, unless the last step's checkpoint holds it already
    if ckpt_dir and saved[0] != steps:
        ckpt.save(ckpt_dir, steps, train_state_tree(cfg, state, True))
    return {"final_loss": losses[-1] if losses else None,
            "first_loss": losses[0] if losses else None,
            "stragglers": watchdog.stragglers, "steps": steps,
            "start_step": start_step, "losses": losses,
            "grad_norms": norms, "step_s": secs,
            "mesh": None if mesh is None else tuple(mesh.shape)}


def shard_train_state(state: TrainState, specs: dict, mesh) -> TrainState:
    """``state`` (the same full values on every rank) with its weights,
    moments and residuals as DTensors of ``specs`` on ``mesh``: each rank
    keeps its own shard, with no communication; the steps stay plain
    (replicated) scalars."""
    def put(t, name):
        return distribute(t.detach(), NamedSharding(mesh, specs[name]))

    for name, p in list(state.params.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = state.params.get_submodule(owner) if owner else state.params
        mod._parameters[leaf] = torch.nn.Parameter(
            put(p, name), requires_grad=p.requires_grad)

    def moments(d):
        return {k: put(v, k) for k, v in d.items()}

    opt = adamw.AdamWState(step=state.opt.step, mu=moments(state.opt.mu),
                           nu=moments(state.opt.nu))
    ef = None if state.ef is None else EFState(error=moments(
        state.ef.error))
    return TrainState(params=state.params, opt=opt, ef=ef, step=state.step)


def _stacked_shardings(cfg, state: TrainState, specs: dict, mesh) -> dict:
    """The checkpoint's tree (:func:`train_state_tree`'s paths) of
    ``NamedSharding``: a stacked leaf takes its layers' spec after one
    ``None`` a layer axis; the steps are plain."""
    tree: dict = {}
    for name, spec in specs.items():
        path, k, _ = partition.stacked_leaf(cfg, name, ())
        *heads, last = path.split("/")
        node = tree
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = NamedSharding(mesh, P(*((None,) * k + tuple(spec))))
    return {"params": tree, "opt": {"mu": tree, "nu": tree},
            "ef": None if state.ef is None else {"error": tree}}


def _restore_target(cfg, state) -> dict:
    """:func:`train_state_tree` of ``state`` on the meta device: the
    checkpoint's keys, shapes and dtypes, holding no memory."""
    def m(t):
        return torch.empty(t.shape, dtype=t.dtype, device="meta")

    def ms(d):
        return {k: m(v) for k, v in d.items()}

    meta = TrainState(
        params=ms(adamw.named(state.params)),
        opt=adamw.AdamWState(step=m(state.opt.step), mu=ms(state.opt.mu),
                             nu=ms(state.opt.nu)),
        ef=None if state.ef is None else EFState(error=ms(state.ef.error)),
        step=m(state.step))
    return train_state_tree(cfg, meta)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCH_NAMES))
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    args = ap.parse_args(argv)
    dist = torch.distributed
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        # torchrun: one rank a process; gloo on the CPU, NCCL on the cards
        cpu = args.device is not None and \
            torch.device(args.device).type == "cpu"
        if not cpu:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("gloo" if cpu else "nccl")
    try:
        out = train(args.arch, smoke=args.smoke, steps=args.steps,
                    batch_size=args.batch, seq_len=args.seq_len,
                    ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                    grad_compression=args.grad_compression,
                    device=args.device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if out["mesh"] is None or int(os.environ.get("RANK", 0)) == 0:
        print(json.dumps({k: out[k] for k in ("final_loss", "first_loss",
                                              "stragglers", "steps")}))


if __name__ == "__main__":
    main()
