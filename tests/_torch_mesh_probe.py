"""The process-group half of ``test_torch_mesh_cost.py``, in a process of
its own (a group opened in a pytest worker would leak into later files).
Usage::

    python _torch_mesh_probe.py STORE_FILE IN_NPZ OUT_JSON
    python _torch_mesh_probe.py --multi-pod OUT_JSON

1. A gloo world of one rank, a (1, 1) ("data", "model") mesh: the port's
   ``fused_xent`` on DTensors (the hidden states batch-sharded, the head
   laid out as ``param_specs`` lays out ``lm_head``'s transpose) under the
   mesh's logical rules, with the vocab axis (chunked branch) and without
   it (the full-logits branch): its value and the gradients of x and head.
2. A ``fake`` world of 256 ranks on the (16, 16) production mesh: one
   matmul on DTensors counted by ``op_cost`` and by ``FlopCounterMode``,
   two collectives counted by ``op_cost`` and the same two issued by
   ``torch.distributed``'s own calls (the medoid engines' kind), the dry
   run's internlm2-1.8b x decode_32k row, ``dryrun_medoid_engine``'s
   rows for v1 and v2 at n = ENGINE_N, d = ENGINE_D, and the row of
   TRAIN_ARCH x train_4k cut to TRAIN_LAYERS layers, and ``fused_xent``'s
   forward and backward alone at XENT's widths, laid out as that train
   cell on (2, 16, 16) lays them out (x sharded by batch on the data axis
   and by sequence on the model axis, the head by vocab rows on the model
   axis): its peak, and each collective's kind and shape.
3. With ``--multi-pod`` (a process of its own, run beside the first): a
   ``fake`` world of 512 ranks, the (2, 16, 16) mesh, and the same train
   row there.

Writes one JSON object to OUT_JSON."""
import json
import sys

import numpy as np
import torch
import torch.distributed as dist

# the medoid engines' dry run: n rows of d on the (16, 16) mesh (v1's
# rounds cost more host time a row, so it runs at fewer)
ENGINE_N = {"v1": 1 << 12, "v2": 1 << 14}
ENGINE_D = 64
# the train cell held on both meshes, its depth cut
TRAIN_ARCH, TRAIN_LAYERS = "internlm2-1.8b", 1
# fused_xent alone on the (16, 16) mesh: B_loc rows a data shard, S, d,
# internlm2's vocab, chunk c (d cut so the hidden states weigh little
# beside a chunk's logits)
XENT = {"B_loc": 2, "S": 4096, "d": 256, "V": 92544, "c": 256}


def xent_on_mesh(store, data):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import logical_rules, make_mesh
    from repro_torch.models.model import fused_xent
    from repro_torch.models.sharding import logical_axis_rules

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    mesh = make_mesh((1, 1), ("data", "model"))
    out = {}
    for name, vocab in (("chunked", "model"), ("full", None)):
        x = distribute_tensor(torch.from_numpy(data["x"]), mesh,
                              [Shard(0), Replicate()]).requires_grad_(True)
        head = distribute_tensor(torch.from_numpy(data["head"]), mesh,
                                 [Replicate(), Shard(0)]
                                 ).requires_grad_(True)
        tokens = distribute_tensor(torch.from_numpy(data["tokens"]), mesh,
                                   [Shard(0), Replicate()])
        rules = dict(logical_rules(mesh), vocab=vocab)
        with implicit_replication(), logical_axis_rules(rules):
            loss = fused_xent(x, tokens, head, chunk=int(data["chunk"]))
            loss.backward()
        out[name] = {"loss": float(loss.full_tensor()),
                     "dx": x.grad.full_tensor().tolist(),
                     "dhead": head.grad.full_tensor().tolist()}
    dist.destroy_process_group()
    return out


def on_fake_world():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._functional_collectives import (all_gather_tensor,
                                                           all_reduce)
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.roofline.op_cost import OpCounter

    dryrun.init_fake_world()
    mesh = make_production_mesh()
    out = {}
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(256, 4096, 2048), mesh,
                              [Shard(0), Replicate()], src_data_rank=None)
        w = distribute_tensor(torch.empty(2048, 8192), mesh,
                              [Replicate(), Shard(1)], src_data_rank=None)
        with OpCounter() as c:
            x @ w
        with FlopCounterMode(display=False) as f:
            x @ w
        out["matmul"] = {"op_cost": c.cost().dot_flops,
                         "flop_counter": f.get_total_flops()}
    with OpCounter() as c:
        all_reduce(torch.zeros(1024, 512), "sum", dist.group.WORLD)
        all_gather_tensor(torch.zeros(8, dtype=torch.bfloat16), 0,
                          dist.group.WORLD)
    out["collectives"] = c.cost().collective_by_kind
    out["decode_row"] = dryrun.dryrun_cell("internlm2-1.8b", "decode_32k",
                                           verbose=False)
    with OpCounter() as c:
        dist.all_reduce(torch.zeros(1024, 512))
        dist.all_gather([torch.zeros(8, dtype=torch.bfloat16)
                         for _ in range(256)],
                        torch.zeros(8, dtype=torch.bfloat16))
    out["c10d_collectives"] = c.cost().collective_by_kind
    out["engine_rows"] = {e: dryrun.dryrun_medoid_engine(
        n=n, d=ENGINE_D, engine=e, verbose=False)
        for e, n in ENGINE_N.items()}
    out["train_row"] = train_row(False)
    out["xent_fake"] = xent_on_fake_mesh(mesh)
    return out


def xent_on_fake_mesh(mesh):
    """The peak bytes and the collectives (kind, shape) of ``fused_xent``'s
    forward and backward on one rank, under the train cell's rules."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import logical_rules
    from repro_torch.models.model import fused_xent
    from repro_torch.models.sharding import logical_axis_rules
    from repro_torch.roofline.op_cost import COLLECTIVES, OpCounter

    class Counter(OpCounter):
        def _count(self, func, args, kwargs, out, leaves):
            name = func.overloadpacket.__name__
            if func.namespace == "_c10d_functional" and name in COLLECTIVES:
                self.issued.append((COLLECTIVES[name], list(out.shape)))
            super()._count(func, args, kwargs, out, leaves)

    n = XENT
    rules = logical_rules(mesh, seq_shard=True)
    with FakeTensorMode():
        def place(shape, dtype, placements):
            return distribute_tensor(torch.empty(shape, dtype=dtype), mesh,
                                     placements, src_data_rank=None)
        x = place((16 * n["B_loc"], n["S"], n["d"]), torch.bfloat16,
                  [Shard(0), Shard(1)]).requires_grad_(True)
        head = place((n["V"], n["d"]), torch.bfloat16,
                     [Replicate(), Shard(0)]).requires_grad_(True)
        tokens = place((16 * n["B_loc"], n["S"]), torch.int64,
                       [Shard(0), Replicate()])
        c = Counter()
        c.issued = []
        c.track_arguments([x, head, tokens])
        with c, implicit_replication(), logical_axis_rules(rules):
            loss = fused_xent(x, tokens, head, chunk=n["c"])
            loss.backward()
    return {"peak": c.cost().peak_bytes, "collectives": c.issued}


def train_row(multi_pod):
    from repro_torch.launch import dryrun
    return dryrun.dryrun_cell(TRAIN_ARCH, "train_4k", multi_pod=multi_pod,
                              layers=TRAIN_LAYERS, verbose=False)


def main():
    if sys.argv[1] == "--multi-pod":
        from repro_torch.launch import dryrun
        dryrun.init_fake_world(multi_pod=True)
        res, path = {"train_row": train_row(True)}, sys.argv[2]
    else:
        data = dict(np.load(sys.argv[2]))
        res = {"xent": xent_on_mesh(sys.argv[1], data)}
        res.update(on_fake_world())
        path = sys.argv[3]
    with open(path, "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
