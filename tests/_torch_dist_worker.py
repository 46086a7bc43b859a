"""One gloo rank of ``test_torch_distributed.py``: the port's answers to the
cases of ``_torch_dist_cases.py`` whose mesh has ``world`` ranks, plus the
mesh layout of a (4, 2) mesh, the facade's error cases and the CLI's
``--distributed`` mode. Usage::

    python _torch_dist_worker.py RANK WORLD STORE_FILE OUT_JSON

Rank 0 writes one JSON object to OUT_JSON; every rank must answer every case
alike."""
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_dist_cases import CASES, make_data  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.core import distributed  # noqa: E402
from repro_torch.engine import rng  # noqa: E402
from repro_torch.launch import medoid as cli  # noqa: E402


def same_everywhere(value):
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, value)
    assert all(g == got[0] for g in got), got
    return value


def error_of(fn):
    try:
        fn()
    except (ValueError, TypeError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    dist.init_process_group("gloo", init_method=f"file://{sys.argv[3]}",
                            rank=rank, world_size=world)
    meshes = {}
    out = {"cases": {}}
    for i, case in enumerate(CASES):
        shape = tuple(case["mesh"])
        if int(np.prod(shape)) != world:
            continue
        if shape not in meshes:
            meshes[shape] = init_device_mesh(
                "cpu", shape, mesh_dim_names=tuple("ab"[:len(shape)]))
        mesh = meshes[shape]
        x = torch.from_numpy(make_data(case["data"]))
        # half the cases hand over a DTensor, half the whole rows
        data = distributed.shard_rows(x, mesh) if i % 2 else x
        res = api.find_medoid(data, rng.key(case["seed"]), mesh=mesh,
                              distributed_impl=case["impl"],
                              metric=case["metric"], backend=case["backend"],
                              budget_per_arm=case["budget_per_arm"])
        out["cases"][case["id"]] = same_everywhere(
            [res.medoid, res.pulls, res.algo, [list(r) for r in res.rounds]])

    if world == 8:
        # the (4, 2) mesh: shard id = row-major coordinate, and a DTensor
        # row-sharded over both dimensions holds that shard's rows
        mesh = meshes.get((4, 2)) or init_device_mesh("cpu", (4, 2))
        lay = distributed.mesh_layout(mesh)
        x = torch.arange(64 * 3, dtype=torch.float32).reshape(64, 3)
        local = distributed.shard_rows(x, mesh).to_local()
        coord = mesh.get_coordinate()
        layouts = [None] * world
        dist.all_gather_object(layouts, [rank, list(coord), lay.shard_id,
                                         bool(torch.equal(local, x[
                                             8 * lay.shard_id:
                                             8 * (lay.shard_id + 1)]))])
        out["layout_4x2"] = layouts
        from torch.distributed.tensor import Shard, distribute_tensor

        # torch's own row sharding puts the same rows on each rank
        dt = distribute_tensor(x, mesh, distributed.make_row_sharding(mesh))
        flags = [None] * world
        dist.all_gather_object(flags, bool(torch.equal(dt.to_local(), local)))
        out["dtensor_rows_match"] = flags
        mesh8 = meshes[(8,)]
        x = torch.from_numpy(make_data("gauss"))
        key = rng.key(0)
        out["errors"] = same_everywhere({
            "algo": error_of(lambda: api.find_medoid(
                x, key, mesh=mesh8, algo="meddit")),
            "impl": error_of(lambda: api.find_medoid(
                x, key, mesh=mesh8, distributed_impl="v3")),
            "divisible": error_of(lambda: api.find_medoid(
                x[:100], key, mesh=mesh8)),
            "telemetry": error_of(lambda: api.find_medoid(
                x, key, mesh=mesh8, telemetry=True)),
            "precision": error_of(lambda: api.find_medoid(
                x, key, mesh=mesh8, precision="bf16")),
            "placement": error_of(lambda: api.find_medoid(
                distribute_tensor(x, mesh8, [Shard(1)]), key, mesh=mesh8)),
        })
    if world == 4:
        line = cli.run(256, 16, "", 24, "planted", compare=True,
                       device="cpu", backend="pallas_fused", distributed=True)
        out["cli"] = same_everywhere({k: v for k, v in line.items()
                                      if not k.endswith("_s")})
    if rank == 0:
        with open(sys.argv[4], "w") as fh:
            json.dump(out, fh)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
