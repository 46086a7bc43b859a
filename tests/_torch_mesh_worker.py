"""One gloo rank of ``test_torch_mesh_train.py``: the port's sharded
trainer. Usage::

    python _torch_mesh_worker.py RANK STORE_DIR OUT_JSON CKPT DP_CKPT

Four ranks train the float32 smoke internlm2 (batch 8 x 32, a checkpoint
every 3 steps) from CKPT's latest checkpoint to step 6 on
``elastic_remesh``'s (1, 4) mesh, then take one step from DP_CKPT's
checkpoint on a (2, 2) mesh, whose data axis shards the batch; then ranks
0 and 1 leave that world for one of two ranks and resume CKPT to step 9 on
a (1, 2) mesh. Rank 0 writes the runs' summaries to OUT_JSON; every rank
must report the same losses. With the environment's ``WAIT_FOR`` a rank
imports, then waits for that file to exist before it starts."""
import json
import os
import sys
import time

import torch.distributed as dist

from repro_torch.launch import train as tl
from repro_torch.launch.mesh import make_mesh

RUN = dict(smoke=True, batch_size=8, seq_len=32, ckpt_every=3,
           device="cpu", log_every=100)
# the smoke config in float32 (the test's docstring says why)
SMOKE32 = tl.get_smoke_config("internlm2-1.8b").scaled(dtype="float32")
tl.get_smoke_config = lambda arch: SMOKE32


def summary(out):
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, out["losses"])
    assert all(g == got[0] for g in got), got
    return {k: out[k] for k in ("losses", "grad_norms", "start_step",
                                "mesh")}


def world(store, rank, size):
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=size)


def main():
    rank, stores, out, ckpt, dp_ckpt = sys.argv[1:6]
    rank = int(rank)
    wait = os.environ.get("WAIT_FOR")
    while wait and not os.path.exists(wait):
        time.sleep(0.05)
    res = {}
    world(os.path.join(stores, "four"), rank, 4)
    res["four"] = summary(tl.train("internlm2-1.8b", steps=6,
                                   ckpt_dir=ckpt, **RUN))
    remesh = tl.elastic_remesh
    tl.elastic_remesh = lambda **kw: make_mesh((2, 2), ("data", "model"))
    res["dp"] = summary(tl.train("internlm2-1.8b", steps=1,
                                 ckpt_dir=dp_ckpt, **RUN))
    tl.elastic_remesh = remesh
    dist.destroy_process_group()
    if rank < 2:
        world(os.path.join(stores, "two"), rank, 2)
        res["two"] = summary(tl.train("internlm2-1.8b", steps=9,
                                      ckpt_dir=ckpt, **RUN))
        dist.destroy_process_group()
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)


if __name__ == "__main__":
    main()
