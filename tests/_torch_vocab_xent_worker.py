"""One gloo rank of ``test_torch_vocab_xent.py``. Usage::

    python _torch_vocab_xent_worker.py RANK STORE_FILE IN_NPZ OUT_JSON

Two ranks on a (1, 2) ("data", "model") mesh run the port's ``fused_xent``
under the mesh's logical rules (the vocab on the model axis: the chunked
branch, each chunk's logits cut in two by vocab columns): the hidden
states and tokens batch-sharded, the (V, d) head laid out by vocab rows.
Rank 0 writes the loss, the gradients of x and head (whole) and the
collectives its ranks issued, by kind, to OUT_JSON."""
import json
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.launch.mesh import logical_rules, make_mesh
from repro_torch.models.model import fused_xent
from repro_torch.models.sharding import logical_axis_rules
from repro_torch.roofline.op_cost import OpCounter


def main():
    rank, store, inp, out = sys.argv[1:5]
    data = dict(np.load(inp))
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=int(rank), world_size=2)
    mesh = make_mesh((1, 2), ("data", "model"))
    x = distribute_tensor(torch.from_numpy(data["x"]), mesh,
                          [Shard(0), Replicate()]).requires_grad_(True)
    head = distribute_tensor(torch.from_numpy(data["head"]), mesh,
                             [Replicate(), Shard(0)]).requires_grad_(True)
    tokens = distribute_tensor(torch.from_numpy(data["tokens"]), mesh,
                               [Shard(0), Replicate()])
    with OpCounter() as c, implicit_replication(), \
            logical_axis_rules(logical_rules(mesh)):
        loss = fused_xent(x, tokens, head, chunk=int(data["chunk"]))
        loss.backward()
    res = {"loss": float(loss.full_tensor()),
           "dx": x.grad.full_tensor().tolist(),
           "dhead": head.grad.full_tensor().tolist(),
           "collectives": c.cost().collective_count}
    dist.destroy_process_group()
    if rank == "0":
        with open(out, "w") as f:
            json.dump(res, f)


if __name__ == "__main__":
    main()
