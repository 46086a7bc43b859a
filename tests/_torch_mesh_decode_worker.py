"""One gloo rank of ``test_torch_mesh_decode.py``. Usage::

    python _torch_mesh_decode_worker.py RANK WORK_DIR CASE [CASE ...]

Four ranks open one gloo world and run each CASE in turn (``decode_*`` or
``train_*``) once the test has written its file, WORK_DIR/CASE.pt:

* decode: the case's weights laid out by ``partition.param_specs`` and its
  prefill cache by ``partition.cache_specs_tree`` (the decode_32k rules:
  the batch over the data axis, the cache's sequence over the model axis)
  on the case's mesh, then two decode steps under the mesh's logical rules;
  the logits of each, gathered.
* train: the case's weights, zero AdamW moments, laid out as
  ``launch.train`` lays them out (``partition.param_specs`` and the mesh's
  logical rules), or with ``"layout": "fsdp_seq"`` as the dry run lays out
  a (2, 16, 16) train cell (``partition.pure_fsdp_specs``, no tensor
  parallelism, the sequence over the model axis), and one
  ``make_train_step`` step on the case's batch, sharded by
  ``partition.batch_specs``; the loss, the grad norm, every updated weight
  and every first moment, gathered.

Rank 0 writes ``{case: result}`` to WORK_DIR/out.pt."""
import os
import sys
import time

import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import InputShape
from repro_torch.configs.registry import input_specs
from repro_torch.launch import partition
from repro_torch.launch.mesh import logical_rules, make_mesh
from repro_torch.launch.train import shard_train_state
from repro_torch.models.model import build_model, weights_init
from repro_torch.models.sharding import (NamedSharding, distribute,
                                         local_value, logical_axis_rules)
from repro_torch.optim import adamw
from repro_torch.train.train_step import TrainCfg, TrainState, make_train_step


def _weights(cfg, saved, specs, mesh, trainable):
    params = weights_init(cfg, None, "meta")
    for name, _ in list(params.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = params.get_submodule(owner) if owner else params
        mod._parameters[leaf] = torch.nn.Parameter(
            distribute(saved[name], NamedSharding(mesh, specs[name])),
            requires_grad=trainable)
    return params


def _place(tree, specs, mesh):
    if isinstance(tree, dict):
        return {k: _place(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_place(v, s, mesh) for v, s in zip(tree, specs)])
    return distribute(tree, NamedSharding(mesh, specs))


def decode(case, mesh):
    cfg = get_smoke_config(case["arch"]).scaled(**case["kw"])
    specs = partition.param_specs(partition.expected_params(cfg), cfg, mesh)
    params = _weights(cfg, case["weights"], specs, mesh, trainable=False)
    tokens, s0 = case["tokens"], case["prompt"]
    cache = case["cache"]
    cspecs = partition.cache_specs_tree(cache, cfg, mesh, tokens.shape[0],
                                        seq_len=case["max_len"])
    cache = _place(cache, cspecs, mesh)
    model = build_model(cfg)
    logits = []
    with implicit_replication(), logical_axis_rules(logical_rules(mesh)):
        for i in range(case["steps"]):
            out, cache = model.decode_step(params, tokens[:, s0 + i], cache,
                                           s0 + i)
            logits.append(local_value(out))
    return {"logits": torch.stack(logits)}


def train(case, mesh):
    cfg = get_smoke_config(case["arch"]).scaled(**case["kw"])
    model = build_model(cfg)
    tcfg = TrainCfg(**case["tcfg"])
    params = weights_init(cfg, None, "meta")
    for name, _ in list(params.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = params.get_submodule(owner) if owner else params
        mod._parameters[leaf] = torch.nn.Parameter(
            case["weights"][name].clone(), requires_grad=True)
    state = TrainState(params=params, opt=adamw.init(params), ef=None,
                       step=torch.zeros((), dtype=torch.int32))
    rules = logical_rules(mesh)
    if case.get("layout") == "fsdp_seq":
        rules = dict(logical_rules(mesh, seq_shard=True), model=None,
                     expert=None)
        specs = partition.pure_fsdp_specs(partition.expected_params(cfg),
                                          mesh, cfg)
    else:
        specs = partition.param_specs(state.params, cfg, mesh)
    state = shard_train_state(state, specs, mesh)
    batch = case["batch"]
    shape = InputShape("custom", batch["tokens"].shape[1],
                       batch["tokens"].shape[0], "train")
    bspecs = partition.batch_specs(input_specs(cfg, shape), mesh)
    batch = {k: distribute(v, NamedSharding(mesh, bspecs[k]))
             for k, v in batch.items()}
    with implicit_replication(), logical_axis_rules(rules):
        state, metrics = make_train_step(model, tcfg)(state, batch)
    return {"loss": float(local_value(metrics["loss"])),
            "grad_norm": float(local_value(metrics["grad_norm"])),
            "weights": {k: local_value(p.detach())
                        for k, p in state.params.named_parameters()},
            "mu": {k: local_value(m) for k, m in state.opt.mu.items()}}


def main():
    rank, work, names = int(sys.argv[1]), sys.argv[2], sys.argv[3:]
    dist.init_process_group("gloo", init_method=f"file://{work}/store",
                            rank=rank, world_size=4)
    out = {}
    for name in names:
        path = os.path.join(work, name + ".pt")
        while not os.path.exists(path):
            time.sleep(0.05)
        case = torch.load(path, weights_only=False)
        mesh = make_mesh(case["mesh"], ("data", "model"))
        out[name] = (decode if name.startswith("decode") else train)(case,
                                                                     mesh)
    if rank == 0:
        torch.save(out, os.path.join(work, "out.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
