#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one or more lines each; any failure raises and the script exits
nonzero:

1. the card (``nvidia-smi`` name and power limit, torch's device name) and
   the build of every CUDA kernel from ``src/repro_torch/kernels/csrc``;
2. every kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it (each round of each cell below) plus ragged
   shapes, random reference masks and, for the survivor ordering, ties,
   -0.0/+0.0, +inf and NaN. Centrality sums must agree within rtol 1e-5
   (plus the l2 self-pair allowance, see ``_tolerance``); the ordering must
   be bit-equal. Each kernel is timed with CUDA events beside its bound,
   its plain version and, where one PyTorch call computes the same function,
   that call (``library_ms``; the port never calls it);
3. the main path at full size: ``repro_torch.api.find_medoid`` (corr_sh,
   budget 30 per arm) on the five cells below with the kernel launch
   counters zeroed just before each run and read just after. Each winner is
   held against the ``reference`` backend's on the card with the same key,
   and against the exact medoid (l1 at n=4096, d=512, the README command);
   the planted cells must answer 0.

It then prints the kernels' JSON line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``. It needs one CUDA card and the rest
of the repository beside it; without either it fails before printing any
result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BUDGET_PER_ARM = 30
SEED = 0
RTOL = 1e-5
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12          # fp32 outside the tensor cores
PALLAS = "src/repro/kernels/pairwise_distance.py"

# name, dataset, n, d, metric, backend
CELLS = (
    ("planted_l2_fused", "planted", 20000, 784, "l2", "pallas_fused"),
    ("planted_l2_topk", "planted", 20000, 784, "l2", "pallas_fused_topk"),
    ("rnaseq_l1_fused", "rnaseq20k_like", 20000, 4096, "l1", "pallas_fused"),
    ("netflix_cosine_fused", "netflix20k_like", 20000, 2048, "cosine",
     "pallas_fused"),
    ("mnist_l2_topk", "mnist_zeros_like", 6424, 784, "l2",
     "pallas_fused_topk"),
)

KERNELS = {   # name -> (source, TPU kernel it replaces)
    "dot_centrality": ("src/repro_torch/kernels/csrc/dot_centrality.cu",
                       f"{PALLAS}:269"),
    "l1_centrality": ("src/repro_torch/kernels/csrc/l1_centrality.cu",
                      f"{PALLAS}:181"),
    "topk_rank": ("src/repro_torch/kernels/csrc/topk_smallest.cu",
                  f"{PALLAS}:355"),
    "topk_select": ("src/repro_torch/kernels/csrc/topk_smallest.cu",
                    f"{PALLAS}:366"),
}


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _bound_s(nbytes: float, ops: float) -> tuple[float, float]:
    return nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S


class Ledger:
    """Per-kernel sums of time, bound and error over the launches of the
    main path, one entry per (kernel, shape) launch."""

    def __init__(self):
        self.rows = {k: {"ms": 0.0, "plain_ms": 0.0, "bytes_s": 0.0,
                         "ops_s": 0.0, "bound_s": 0.0, "library_ms": None,
                         "max_abs_err": 0.0, "launches": 0}
                     for k in KERNELS}

    def add(self, name, ms, plain_ms, nbytes, ops, err, library_ms=None):
        row = self.rows[name]
        b, o = _bound_s(nbytes, ops)
        row["ms"] += ms
        row["plain_ms"] += plain_ms
        row["bytes_s"] += b
        row["ops_s"] += o
        row["bound_s"] += max(b, o)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if library_ms is not None:
            row["library_ms"] = (row["library_ms"] or 0.0) + library_ms

    def note_err(self, name, err):
        row = self.rows[name]
        row["max_abs_err"] = max(row["max_abs_err"], err)

    def line(self) -> str:
        out = []
        for name, (src, replaces) in KERNELS.items():
            row = self.rows[name]
            out.append({
                "name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": row["launches"],
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_s"] * 1e3,
                "bound_by": ("bytes" if row["bytes_s"] >= row["ops_s"]
                             else "operations"),
                "library_ms": row["library_ms"]})
        return json.dumps({"kernels": out})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this smoke "
              "run needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.api import find_medoid
    from repro_torch.convert import data_from_numpy
    from repro_torch.core.corr_sh import correlated_sequential_halving
    from repro_torch.core.exact import exact_medoid
    from repro_torch.data.medoid_datasets import DATASETS, planted_medoid
    from repro_torch.engine import rng
    from repro_torch.engine.schedule import round_schedule, stop_round
    from repro_torch.kernels import build
    from repro_torch.kernels import ops
    from repro_torch.kernels import pairwise_distance as pk

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _smi()
    print(f"phase1 card: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}",
          flush=True)
    t0 = time.perf_counter()
    bdir = build.build()
    print(f"phase1 build: {time.perf_counter() - t0:.2f} s into "
          f"{bdir.relative_to(ROOT)}", flush=True)
    for src, log in build.build_logs().items():
        lines = log.splitlines()
        regs = sorted({ln.split("Used ")[1] for ln in lines if "Used " in ln})
        spills = any(" 0 bytes spill stores" not in ln
                     for ln in lines if "spill stores" in ln)
        print(f"phase1 ptxas {src}: {' | '.join(regs)}; spills={spills}")

    # ------------------------------------------------------------- data
    t0 = time.perf_counter()
    arrays = {"planted": planted_medoid(SEED, 20000, 784)}
    for cell in CELLS:
        name, ds, n, d = cell[:4]
        if ds not in arrays:
            arrays[ds] = DATASETS[ds][1](SEED, n, d)
    data = {ds: data_from_numpy(a, dev) for ds, a in arrays.items()}
    torch.cuda.synchronize()
    print(f"phase1 data: {time.perf_counter() - t0:.2f} s for "
          f"{sorted(data)}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def timed(fn, reps):
        """Device ms per call: ``reps`` calls captured in one CUDA graph and
        timed with CUDA events around its replay. Launching from Python
        costs tens of microseconds a call, more than many of these kernels
        run, so back-to-back eager launches would time the host."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):      # warm-up off the capture stream
            for _ in range(2):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def _tolerance(plain, metric, x, y, w):
        # rtol 1e-5 on each sum (fp32 sums in another order), a floor of
        # 1e-5 of the largest sum, and for l2 the self-pair allowance: the
        # Gram trick's cancellation at a zero distance leaves ~|x| sqrt(eps)
        # under the sqrt, so 1e-3 * max row norm per valid reference.
        tol = RTOL * plain.abs() + RTOL * plain.abs().max()
        if metric == "l2":
            nref = float(w.sum()) if w is not None else y.shape[0]
            norm = max(float(x.norm(dim=1).max()), float(y.norm(dim=1).max()))
            tol = tol + 1e-3 * norm * nref
        return tol

    def centrality_inputs(metric, x, y):
        if metric == "cosine":
            return ops._unit_rows(x), ops._unit_rows(y), None, None
        return x, y, ops._norms_sq(x), ops._norms_sq(y)

    def check_centrality(metric, x, y, w, reps=0):
        """Kernel vs plain on the card; returns (max_abs_err, ms, plain_ms,
        bytes, ops) with times only when reps > 0."""
        xk, yk, xn2, yn2 = centrality_inputs(metric, x, y)
        if metric == "l1":
            def kern():
                return pk.l1_centrality(xk, yk, w)

            def plain():
                return pk.l1_centrality_plain(xk, yk, w)
        else:
            def kern():
                return pk.dot_centrality(xk, yk, xn2, yn2, w, metric=metric)

            def plain():
                return pk.dot_centrality_plain(xk, yk, xn2, yn2, w,
                                               metric=metric)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = (got - want).abs()
        tol = _tolerance(want, metric, x, y, w)
        _require(bool(torch.isfinite(got).all()), f"{metric}: non-finite")
        _require(bool((err <= tol).all()),
                 f"{metric} kernel disagrees at C={x.shape[0]} "
                 f"R={y.shape[0]} d={x.shape[1]}: max err "
                 f"{float(err.max())}, tol {float(tol.min())}")
        c, d = x.shape
        r = y.shape[0]
        nbytes = 4 * (c * d + r * d + c)
        if metric in ("l2", "sql2"):
            nbytes += 4 * (c + r)
        if w is not None:
            nbytes += 4 * r
        nops = (3 if metric == "l1" else 2) * c * r * d
        if reps == 0:
            return float(err.max()), 0.0, 0.0, nbytes, nops
        return (float(err.max()), timed(kern, reps), timed(plain, max(1, reps // 4)),
                nbytes, nops)

    def rounds_of(n):
        rounds = round_schedule(n, BUDGET_PER_ARM * n)
        return rounds[: stop_round(rounds) + 1]

    def _breakdown(x, key, n, metric, backend):
        """Where a steady call's time goes: (host ms of the random draws
        alone — the same splits and permutations, nothing else; device busy
        ms of one call under torch.profiler, or None where the profiler saw
        no device activity)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        k = key
        for rd in rounds_of(n):
            k, sub = rng.split(k)
            if rd.num_refs < n:
                rng.permutation(sub, n)
        torch.cuda.synchronize()
        draws_ms = (time.perf_counter() - t0) * 1e3
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            find_medoid(x, key, metric=metric, backend=backend,
                        budget_per_arm=BUDGET_PER_ARM)
            torch.cuda.synchronize()
        spans = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if not spans:
            return draws_ms, None
        return draws_ms, (len(spans), sum(spans) / 1e3)

    # ------------------------------------------------ phase 2: kernels
    led = Ledger()
    # ragged shapes (no tile multiple) and random reference masks
    for (c, r, d) in ((1, 1, 1), (77, 131, 300), (130, 65, 257),
                      (333, 1234, 784), (333, 1234, 2048), (97, 1234, 4096),
                      (5, 8000, 4096), (20000, 3, 784)):
        x = torch.randn(c, d, device=dev, generator=gen)
        y = torch.randn(r, d, device=dev, generator=gen)
        for masked in (False, True):
            w = (torch.rand(r, device=dev, generator=gen) > 0.3).float() \
                if masked else None
            for metric in ("l1", "l2", "sql2", "cosine"):
                err = check_centrality(metric, x, y, w)[0]
                led.note_err("l1_centrality" if metric == "l1"
                             else "dot_centrality", err)
    print("phase2 ragged shapes and masks: l1/l2/sql2/cosine agree",
          flush=True)

    cache = {}
    for name, ds, n, d, metric, backend in CELLS:
        kern = "l1_centrality" if metric == "l1" else "dot_centrality"
        xall = data[ds]
        tot = {"ms": 0.0, "plain": 0.0, "bound": 0.0, "err": 0.0}
        for rd in rounds_of(n):
            c, r = rd.survivors, rd.num_refs
            ck = (kern, ds, c, r, metric)
            if ck not in cache:
                idx = torch.randperm(n, device=dev, generator=gen)[:c]
                refs = torch.randperm(n, device=dev, generator=gen)[:r]
                cache[ck] = check_centrality(metric, xall[idx].contiguous(),
                                             xall[refs].contiguous(), None,
                                             reps=10)
            err, ms, pms, nbytes, nops = cache[ck]
            led.add(kern, ms, pms, nbytes, nops, err)
            tot["ms"] += ms
            tot["plain"] += pms
            tot["bound"] += max(_bound_s(nbytes, nops)) * 1e3
            tot["err"] = max(tot["err"], err)
        print(f"phase2 {kern} {name}: {len(rounds_of(n))} round shapes, "
              f"kernel {tot['ms']:.3f} ms, plain {tot['plain']:.3f} ms, "
              f"bound {tot['bound']:.4f} ms, max_abs_err {tot['err']:.3g}",
              flush=True)

    def check_topk(theta):
        keys = ops.totalorder_keys(theta)
        rank_k, rank_p = pk.topk_rank(keys), pk.topk_rank_plain(keys)
        _require(torch.equal(rank_k, rank_p), "topk_rank disagrees")
        c = theta.shape[0]
        sel_k = pk.topk_select(rank_k, c)
        sel_p = pk.topk_select_plain(rank_k, c)
        lib = torch.argsort(keys, stable=True)
        _require(torch.equal(sel_k, sel_p), "topk_select disagrees")
        _require(torch.equal(sel_k, lib),
                 "topk pair differs from a stable argsort")
        return keys, rank_k

    for c in (1, 2, 3, 129, 1000, 4097, 20000):
        theta = torch.randn(c, device=dev, generator=gen)
        theta[::7] = 0.0
        theta[::11] = -0.0
        theta[::13] = float("inf")
        theta[::17] = float("nan")
        theta[::5] = theta[0].clone()
        check_topk(theta)
    print("phase2 topk ties, -0.0/+0.0, +inf, nan: bit-equal", flush=True)

    for name, ds, n, d, metric, backend in CELLS:
        if backend != "pallas_fused_topk":
            continue
        tot = [0.0, 0.0, 0.0, 0.0]
        pre_output = rounds_of(n)[:-1]        # the output round takes argmin
        for rd in pre_output:
            c = rd.survivors
            ck = ("topk", c)
            if ck not in cache:
                keys, rank = check_topk(torch.rand(c, device=dev,
                                                   generator=gen))
                out = torch.empty(c, dtype=torch.int64, device=dev)
                ar = torch.arange(c, device=dev)
                rank_l = rank.long()
                cache[ck] = (
                    timed(lambda: pk.topk_rank(keys), 10),
                    timed(lambda: pk.topk_rank_plain(keys), 3),
                    timed(lambda: torch.argsort(keys, stable=True), 10),
                    timed(lambda: pk.topk_select(rank, c), 10),
                    timed(lambda: pk.topk_select_plain(rank, c), 10),
                    timed(lambda: out.scatter_(0, rank_l, ar), 10))
            rk, rp, rl, sk, sp, sl = cache[ck]
            led.add("topk_rank", rk, rp, 8 * c, c * c, 0.0, library_ms=rl)
            led.add("topk_select", sk, sp, 12 * c, c, 0.0, library_ms=sl)
            tot[0] += rk
            tot[1] += sk
            tot[2] += rl
            tot[3] += rp + sp
        print(f"phase2 topk {name}: {len(pre_output)} orderings, rank "
              f"{tot[0]:.3f} ms + select {tot[1]:.3f} ms, plain "
              f"{tot[3]:.3f} ms, torch.argsort(stable) {tot[2]:.3f} ms",
              flush=True)

    # ---------------------------------------------- phase 3: main path
    for name, ds, n, d, metric, backend in CELLS:
        x = data[ds]
        key = rng.fold_in(rng.key(SEED, dev), 1)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        pk.reset_launches()
        t0 = time.perf_counter()
        res = find_medoid(x, key, metric=metric, backend=backend,
                          budget_per_arm=BUDGET_PER_ARM)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(pk.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        nrounds = len(res.rounds)
        kern = "l1_centrality" if metric == "l1" else "dot_centrality"
        want = {kern: nrounds}
        if backend == "pallas_fused_topk":
            want.update(topk_rank=nrounds - 1, topk_select=nrounds - 1)
        _require(counts == want, f"{name}: launches {counts}, expected {want}")
        for k, v in counts.items():
            led.rows[k]["launches"] += v

        t0 = time.perf_counter()
        again = find_medoid(x, key, metric=metric, backend=backend,
                            budget_per_arm=BUDGET_PER_ARM)
        torch.cuda.synchronize()
        steady = time.perf_counter() - t0
        _require(again.medoid == res.medoid, f"{name}: rerun differs")
        draws_ms, busy = _breakdown(x, key, n, metric, backend)

        ref = correlated_sequential_halving(x, BUDGET_PER_ARM * n, key,
                                            metric=metric,
                                            backend="reference")
        theta = torch.sort(ref.theta_hat).values
        gap = float(theta[1] - theta[0]) if theta.numel() > 1 else float("inf")
        ref_winner = int(ref.medoid)
        if res.medoid != ref_winner:
            _require(gap <= 2 * RTOL * float(theta[0].abs()),
                     f"{name}: winner {res.medoid} != reference "
                     f"{ref_winner} with output-round gap {gap}")
        if metric == "l1":
            small = data_from_numpy(DATASETS[ds][1](SEED, 4096, 512), dev)
            sres = find_medoid(small, key, metric=metric, backend=backend,
                               budget_per_arm=BUDGET_PER_ARM)
            exact = int(exact_medoid(small, metric))
            exact_note = (f"exact(n=4096,d=512)={exact} "
                          f"corr_sh={sres.medoid}")
        else:
            exact = int(exact_medoid(x, metric))
            exact_note = f"exact={exact} agree={exact == res.medoid}"
        if ds == "planted":
            _require(res.medoid == 0 and exact == 0,
                     f"{name}: planted medoid not found ({res.medoid})")
        _require(res.pulls == sum(s * t for s, t in res.rounds),
                 f"{name}: pull accounting")
        print(f"phase3 {name} n={n} d={d} {metric} {backend}: medoid "
              f"{res.medoid} (reference {ref_winner}, output-round gap "
              f"{gap:.6g}), {exact_note}, wall {wall * 1e3:.1f} ms first / "
              f"{steady * 1e3:.1f} ms again, pulls {res.pulls}, rounds "
              f"{nrounds}, launches {counts}, max_memory_allocated "
              f"{peak / 2 ** 20:.1f} MiB = {resident / 2 ** 20:.1f} MiB "
              f"resident before the call + {(peak - resident) / 2 ** 20:.1f} "
              f"MiB of its own", flush=True)
        busy_note = ("device busy: not measured (the profiler saw no device "
                     "activity)" if busy is None else
                     f"profiled call: {busy[0]} device activities, busy "
                     f"{busy[1]:.2f} ms = {busy[1] / (steady * 1e3):.1%} of "
                     f"the unprofiled repeat")
        print(f"phase3 {name} breakdown: random draws alone "
              f"{draws_ms:.1f} ms; {busy_note}", flush=True)

    print(led.line())
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
