"""Production-mesh dry run: one train / prefill / decode step of every
(arch x shape) cell on 256 or 512 placeholder ranks, with no card.

The port of ``repro.launch.dryrun``. Run it as its own process
(``python -m repro_torch.launch.dryrun``): it opens a ``fake``-backend
process group (``FakeStore``, rank 0 of 256, or of 512 with
``--multi-pod``) whose collectives do nothing, builds the production mesh
on it, shards the cell's state with the partition rules and runs the step
under ``FakeTensorMode``: every tensor is a shape and a dtype, no memory
and no arithmetic. Per cell this proves, without hardware:

  * the shardings are coherent (every DTensor op places),
  * the step runs on the (16, 16) and (2, 16, 16) meshes,
  * the per-card memory footprint: the arguments' local bytes, the
    outputs', the peak of the step's own allocations (``temp``), the
    outputs that are updated arguments (``alias``),

and counts the roofline's inputs with ``roofline.op_cost`` (one rank's
dispatched ops: dot and elementwise flops, unfused traffic, collective
bytes by kind). The memory policy (microbatches, FSDP, pure FSDP, the
batch over every axis) is the reference's, line for line.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b \\
      --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod \\
      --out build/dryrun.jsonl
  PYTHONPATH=src python -m repro_torch.launch.dryrun --medoid-engine v2 \\
      [--n 1048576]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs import SHAPES, cell_is_supported, get_config
from repro_torch.configs.registry import ARCH_NAMES, input_specs
from repro_torch.launch import partition
from repro_torch.launch.mesh import logical_rules, make_production_mesh
from repro_torch.models.model import build_model
from repro_torch.models.sharding import (NamedSharding, distribute,
                                         logical_axis_rules)
from repro_torch.roofline import analysis as RA
from repro_torch.roofline.op_cost import OpCounter, storage_bytes
from repro_torch.train.train_step import TrainCfg, TrainState, make_train_step


def init_fake_world(multi_pod: bool = False) -> int:
    """Open the ``fake`` process group the production mesh is built on
    (once a process); returns its size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    world = 512 if multi_pod else 256
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    if dist.get_world_size() != world:
        raise RuntimeError(f"a fake world of {dist.get_world_size()} ranks "
                           f"is open; this mesh needs {world}")
    return world


def _fake(t: torch.Tensor) -> torch.Tensor:
    """A fake tensor of ``t``'s shape and dtype (call under the mode)."""
    return torch.empty(t.shape, dtype=t.dtype)


def _sharded_weights(cfg, specs: dict, mesh, trainable: bool):
    """The weights module of ``cfg``, each parameter a DTensor of its spec
    over fake local shards."""
    from repro_torch.models.model import weights_init
    params = weights_init(cfg, None, "meta")
    for name, p in list(params.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = params.get_submodule(owner) if owner else params
        mod._parameters[leaf] = torch.nn.Parameter(
            distribute(_fake(p), NamedSharding(mesh, specs[name])),
            requires_grad=trainable)
    return params


def _state_tree(state: TrainState) -> list:
    return [list(state.params.parameters()), state.opt, state.ef, state.step]


def dryrun_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                tcfg=None, verbose: bool = True,
                layers: Optional[int] = None) -> dict:
    """One cell's row. ``layers`` cuts the config's depth to that many
    layers (a quick look at the layout; the row's ``num_layers`` says
    so); ``None`` keeps the published depth."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.scaled(num_layers=layers)
    shape = SHAPES[shape_name]
    ok, reason = cell_is_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": reason}

    init_fake_world(multi_pod)
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size()
    model = build_model(cfg)
    rules = logical_rules(mesh)  # refined below for train cells

    t0 = time.time()
    params_shape = partition.expected_params(cfg)
    pspecs = partition.param_specs(params_shape, cfg, mesh)
    n_params = RA.count_params(params_shape)

    # memory policy: microbatch count + FSDP kick in by model size
    n_batch_shards = chips // 16   # pod x data
    per_dev_batch = max(1, shape.global_batch // n_batch_shards)
    if cfg.d_model >= 4096:
        target = 2
    elif cfg.d_model >= 2048:
        target = 4
    else:
        target = 8
    mb = max(1, per_dev_batch // target)
    while shape.global_batch % mb:
        mb -= 1
    if cfg.moe is not None and cfg.moe.num_experts % 16:
        # the reference's XLA verifier limit (microbatch reshape x
        # TP-in-expert sharding with non-divisible expert counts); kept so
        # the cells' layouts stay the reference's
        mb = 1
    param_bytes_per_chip = 2 * n_params / 16     # bf16, model-axis sharded
    fsdp = param_bytes_per_chip > 3e9
    # very large d_model trains as pure FSDP/ZeRO-3 (batch over ALL mesh
    # axes, no tensor parallelism), except MoE archs whose expert count
    # divides the model axis (expert-parallel dispatch); the reference's
    # measured policy, kept as it is
    fsdp_pure = shape.kind == "train" and not (
        cfg.moe is not None and cfg.moe.num_experts % 16 == 0)
    pure_dp = False
    seq_shard = False
    batch_over = None
    if fsdp_pure:
        mb = 1
        if shape.global_batch % chips == 0:
            batch_over = tuple(mesh.mesh_dim_names)
        else:
            seq_shard = shape.seq_len % 16 == 0
    if tcfg is None:
        tcfg = TrainCfg(remat=True, num_microbatches=mb)

    batch_meta = input_specs(cfg, shape)
    with FakeTensorMode():
        if shape.kind == "train":
            rules = logical_rules(mesh, seq_shard=seq_shard)
            if fsdp_pure:
                rules["model"] = None      # no tensor parallelism
                rules["expert"] = None
                if batch_over is not None:
                    rules["batch"] = batch_over
                    rules["vocab"] = None  # model axis taken by batch
                pspecs = partition.pure_fsdp_specs(params_shape, mesh, cfg)
                zspecs = pspecs
            elif fsdp:
                pspecs = partition.zero_specs(params_shape, pspecs, mesh,
                                              cfg)
                zspecs = partition.zero_specs(params_shape, pspecs, mesh,
                                              cfg)
            else:
                zspecs = partition.zero_specs(params_shape, pspecs, mesh,
                                              cfg)
            params = _sharded_weights(cfg, pspecs, mesh, trainable=True)
            from repro_torch.optim import adamw, compress
            moments = {k: distribute(torch.empty(p.shape,
                                                 dtype=torch.float32),
                                     NamedSharding(mesh, zspecs[k]))
                       for k, p in params_shape.items()}
            state = TrainState(
                params=params,
                opt=adamw.AdamWState(
                    step=torch.zeros((), dtype=torch.int32), mu=moments,
                    nu={k: torch.empty_like(v) for k, v in moments.items()}),
                ef=None if not tcfg.grad_compression else compress.EFState(
                    error={k: torch.empty_like(v)
                           for k, v in moments.items()}),
                step=torch.zeros((), dtype=torch.int32))
            bspecs = partition.batch_specs(batch_meta, mesh, axes=batch_over)
            batch = {k: distribute(_fake(v), NamedSharding(mesh, bspecs[k]))
                     for k, v in batch_meta.items()}
            step_fn = make_train_step(model, tcfg)
            args = (_state_tree(state), batch)

            def run():
                new, metrics = step_fn(state, batch)
                return _state_tree(new), metrics
            model_flops = RA.model_flops_train(
                n_params, shape.global_batch * shape.seq_len,
                active_frac=_active_frac(cfg))
        else:
            params = _sharded_weights(cfg, pspecs, mesh, trainable=False)
            cache_meta = model.init_cache(shape.global_batch, shape.seq_len,
                                          device="meta")
            cspecs = partition.cache_specs_tree(
                cache_meta, cfg, mesh, shape.global_batch,
                seq_len=shape.seq_len)
            cache = _place(cache_meta, cspecs, mesh)
            if shape.kind == "prefill":
                bspecs = partition.batch_specs(batch_meta, mesh)
                batch = {k: distribute(_fake(v),
                                       NamedSharding(mesh, bspecs[k]))
                         for k, v in batch_meta.items()}
                args = (list(params.parameters()), batch)

                def run():
                    return model.prefill(params, batch, shape.seq_len)
                model_flops = RA.model_flops_train(
                    n_params, shape.global_batch * shape.seq_len,
                    active_frac=_active_frac(cfg)) / 3.0   # fwd only
            else:
                token = distribute(
                    torch.empty((shape.global_batch,), dtype=torch.int32),
                    NamedSharding(mesh, partition.P(None)))
                pos = shape.seq_len - 1
                args = (list(params.parameters()), token, cache)

                def run():
                    return model.decode_step(params, token, cache, pos)
                model_flops = RA.model_flops_decode(
                    n_params, shape.global_batch,
                    active_frac=_active_frac(cfg))
        t_setup = time.time() - t0

        counter = OpCounter()
        arg_bytes = counter.track_arguments(args)
        t0 = time.time()
        with counter, implicit_replication(), logical_axis_rules(rules):
            out = run()
        t_run = time.time() - t0
        cost = counter.cost()
        held, outs = storage_bytes(args), storage_bytes(out)
        alias = sum(b for k, b in outs.items() if k in held)
        out_bytes = sum(outs.values())
        temp = max(cost.peak_bytes - (out_bytes - alias), 0.0)

    live = arg_bytes + out_bytes + temp - alias
    roof = RA.from_cost(cost, chips=chips, live_bytes=live,
                        model_flops=model_flops)
    coll = RA.collective_stats(cost)
    result = {
        "arch": arch, "shape": shape_name, "status": "ok",
        "mesh": "2x16x16" if multi_pod else "16x16", "chips": chips,
        "params": n_params, "num_layers": cfg.num_layers,
        "microbatches": tcfg.num_microbatches,
        "fsdp": bool(fsdp), "fsdp_pure": bool(fsdp_pure),
        "pure_dp": bool(pure_dp),
        "seq_shard": bool(seq_shard),
        "setup_s": round(t_setup, 1), "run_s": round(t_run, 1),
        "per_device_bytes": {
            "arguments": int(arg_bytes),
            "output": int(out_bytes),
            "temp": int(temp),
            "alias": int(alias),
            "total_live": int(live),
        },
        "collectives": {"bytes": coll.bytes_by_kind,
                        "count": coll.count_by_kind},
        **{k: (round(v, 6) if isinstance(v, float) else v)
           for k, v in roof.row().items()},
    }
    if verbose:
        print(json.dumps(result))
        sys.stdout.flush()
    return result


def _place(meta_tree, specs, mesh):
    """A tree of fake DTensors: each meta leaf's shape and dtype on its
    spec."""
    if isinstance(meta_tree, dict):
        return {k: _place(v, specs[k], mesh) for k, v in meta_tree.items()}
    if isinstance(meta_tree, tuple) and hasattr(meta_tree, "_fields"):
        return type(meta_tree)(*[_place(v, s, mesh)
                                 for v, s in zip(meta_tree, specs)])
    return distribute(_fake(meta_tree), NamedSharding(mesh, specs))


def _active_frac(cfg) -> float:
    """Active-parameter fraction for MoE archs (for 6*N_active*D)."""
    if cfg.moe is None:
        return 1.0
    m = cfg.moe
    d_e = m.d_expert or cfg.d_ff
    # per-layer moe params vs activated subset (+ shared always on)
    routed = m.num_experts * 3 * cfg.d_model * d_e
    active = (m.top_k + m.num_shared) * 3 * cfg.d_model * d_e
    dense_rest_guess = 4 * cfg.d_model * cfg.d_model
    per_layer = routed + dense_rest_guess
    per_layer_active = active + dense_rest_guess
    return per_layer_active / per_layer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCH_NAMES))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every supported (arch x shape) cell")
    ap.add_argument("--medoid-engine", default=None, choices=("v1", "v2"),
                    help="dry-run the distributed corrSH engine instead "
                         "(dryrun_medoid_engine)")
    ap.add_argument("--n", type=int, default=1 << 20,
                    help="--medoid-engine's rows (the reference's default)")
    ap.add_argument("--out", default=None, help="write JSONL results here")
    args = ap.parse_args(argv)

    if args.medoid_engine:
        r = dryrun_medoid_engine(n=args.n, multi_pod=args.multi_pod,
                                 engine=args.medoid_engine)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(r) + "\n")
        return 0

    cells = []
    if args.all:
        for arch in ARCH_NAMES:
            for shape in SHAPES:
                cells.append((arch, shape))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    results = []
    for arch, shape in cells:
        try:
            r = dryrun_cell(arch, shape, multi_pod=args.multi_pod)
        except Exception as e:  # noqa: BLE001 — report & continue
            r = {"arch": arch, "shape": shape, "status": "error",
                 "mesh": "2x16x16" if args.multi_pod else "16x16",
                 "error": f"{type(e).__name__}: {e}",
                 "trace": traceback.format_exc()[-2000:]}
            print(json.dumps({k: r[k] for k in
                              ("arch", "shape", "status", "error")}))
            sys.stdout.flush()
        results.append(r)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(r) + "\n")

    n_ok = sum(1 for r in results if r["status"] == "ok")
    n_skip = sum(1 for r in results if r["status"] == "skipped")
    n_err = sum(1 for r in results if r["status"] == "error")
    print(f"# dry-run done: {n_ok} ok, {n_skip} skipped, {n_err} errors",
          file=sys.stderr)
    return 0 if n_err == 0 else 1


def dryrun_medoid_engine(*, n: int = 1 << 20, d: int = 1024,
                         budget_per_arm: int = 24, metric: str = "l1",
                         multi_pod: bool = False, verbose: bool = True,
                         engine: str = "v2") -> dict:
    """Dry-run the paper's engine itself on the production mesh: one
    distributed corrSH call (``engine`` "v1" or "v2") over an (n, d)
    row-sharded dataset at ``budget_per_arm`` pulls an arm, counted on rank
    0's fake shard of n / chips rows.

    The engines run as they run on cards. The one host read they make, the
    mesh's rank table (``core.distributed.mesh_layout``), is made here
    before ``FakeTensorMode``, and the layout is handed to the engine in
    place of its mesh; every other value, the last round's index included,
    stays on the device. The row gives the per-card bytes (the shard, the
    peak of the engine's own allocations), the collectives by kind and the
    roofline of one rank's ops."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.distributed import (distributed_corr_sh,
                                              mesh_layout)
    from repro_torch.core.distributed_v2 import distributed_corr_sh_v2
    from repro_torch.engine import rng
    from repro_torch.engine.schedule import schedule_pulls

    if engine not in ("v1", "v2"):
        raise ValueError(f"engine must be 'v1' or 'v2', got {engine!r}")
    init_fake_world(multi_pod)
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size()
    lay = mesh_layout(mesh)        # the rank table, read on the host
    fn = distributed_corr_sh if engine == "v1" else distributed_corr_sh_v2
    t0 = time.time()
    with FakeTensorMode():
        x_local = torch.empty((n // chips, d), dtype=torch.float32)
        key = rng.key(0, "cpu")
        counter = OpCounter()
        arg_bytes = counter.track_arguments([x_local])
        with counter:
            fn(x_local, key, lay, budget=budget_per_arm * n, metric=metric)
    t_run = time.time() - t0
    cost = counter.cost()
    per_pull = {"l1": 3 * d, "l2": 2 * d, "sql2": 2 * d, "cosine": 2 * d}[metric]
    model_flops = float(schedule_pulls(n, budget_per_arm * n)) * per_pull
    live = arg_bytes + cost.peak_bytes
    roof = RA.from_cost(cost, chips=chips, live_bytes=live,
                        model_flops=model_flops)
    coll = RA.collective_stats(cost)
    result = {
        "arch": f"corrsh-engine-{engine}",
        "shape": f"n{n}_d{d}_b{budget_per_arm}",
        "status": "ok", "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": chips, "run_s": round(t_run, 1),
        "per_device_bytes": {"arguments": int(arg_bytes),
                             "temp": int(cost.peak_bytes),
                             "total_live": int(live)},
        "collectives": {"bytes": coll.bytes_by_kind,
                        "count": coll.count_by_kind},
        **{k: (round(v, 6) if isinstance(v, float) else v)
           for k, v in roof.row().items()},
    }
    if verbose:
        print(json.dumps(result))
        sys.stdout.flush()
    return result


if __name__ == "__main__":
    sys.exit(main())

