#!/usr/bin/env python3
"""Time the fp32 Gram kernels' d split at several floors on one NVIDIA card.

    python3 tools/split_floor.py [--out chiprun_out/split_floor.json]

``SPLIT_MIN_D`` in ``src/repro_torch/kernels/pairwise_distance.py`` sets
the fewest d columns a rank of the split keeps, one floor for the stream
path's split and one for the tile path's, and ``SPLIT_MIN_WIDTH`` the
narrowest rows it splits. This script sets each floor to every value in
``FLOORS`` in turn, with no narrowest width, asks ``pairwise_plan`` /
``centrality_plan`` for the wrapper's fp32 plan at each shape, and times
every distinct plan (and the one without a split) with CUDA events around
a CUDA graph of ``REPS`` launches, twice in turns (plans in order, then
reversed). ``dot_pairwise`` and ``dot_centrality`` (l2, a random 0/1
reference mask) run at

* the embedding medoid's Gram launches (``chip_smoke.embed_round_shapes``)
  at d = 92544 and 32000, the vocabulary widths of internlm2-1.8b and
  zamba2-2.7b;
* the Gram rounds of chip_smoke.py's phases 3-7 (``gram_round_shapes``:
  find_medoid's and k-medoids' rounds, the (1, n) row and the (n, k)
  cache at n = 20000 and 6424) at d = 784 and 2048, the widths of the
  main path's other Gram cells, and at 4096 and 8192.

Each plan's output is held against the one without a split (rtol 1e-4,
with a floor of 1e-4 of the largest value; the l2 allowance of
chip_smoke.py's rule) before it is timed. It prints one line a (kernel,
d, path) group: each floor's summed time over the group's shapes and the
shapes where that floor's plan is slower than the unsplit one by more
than NOISE of the faster time; and writes every shape's times to
``--out``. It exits 1 without a card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

FLOORS = {"stream_split": (256, 512, 1024, 2048, 4096),
          "tile_split": (256, 512, 1024, 2048)}
REPS = 10
D_MAIN = (784, 2048, 4096, 8192)
NOISE = 0.03                    # chip_smoke.py's SPLIT_NOISE


def timed(fn, reps: int) -> float:
    """Device us a call of ``fn``, ``reps`` calls in one CUDA graph."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
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
    return 1e3 * start.elapsed_time(end) / reps


def gram_round_shapes(cs) -> list:
    """The (C, R) of the Gram rounds of chip_smoke.py's phases 3-7 at their
    cells' n: find_medoid's rounds (BUDGET_PER_ARM pulls an arm) and
    k-medoids' (KM_BUILD), the (1, n) row and the (n, k) cache."""
    ns = sorted({cell[2] for cell in cs.CELLS + cs.KM_CELLS})
    ks = sorted({cell[4] for cell in cs.KM_CELLS})
    return sorted({(s.survivors, s.num_refs) for n in ns
                   for budget in (cs.BUDGET_PER_ARM, cs.KM_BUILD)
                   for s in cs.executed_rounds(n, budget * n)}
                  | {(1, n) for n in ns} | {(n, k) for n in ns for k in ks})


@contextlib.contextmanager
def floors(pk, stream: int, tile: int, width: int = 0):
    """``pk.SPLIT_MIN_D`` set to these floors, and ``pk.SPLIT_MIN_WIDTH`` to
    ``width``, for the plans made inside."""
    old, old_width = dict(pk.SPLIT_MIN_D), pk.SPLIT_MIN_WIDTH
    pk.SPLIT_MIN_D.update({pk.STREAM_SPLIT: stream, pk.TILE_SPLIT: tile})
    pk.SPLIT_MIN_WIDTH = width
    try:
        yield
    finally:
        pk.SPLIT_MIN_D.update(old)
        pk.SPLIT_MIN_WIDTH = old_width


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "split_floor.json"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("split_floor: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import ops
    from repro_torch.kernels import pairwise_distance as pk

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    main_shapes = gram_round_shapes(cs)
    cells = [(d, cs.embed_round_shapes()) for d in (92544, 32000)]
    cells += [(d, main_shapes) for d in D_MAIN]
    big = torch.rand(max(max(s) for s in main_shapes), max(D_MAIN),
                     device=dev, generator=gen)
    wide = torch.rand(cs.EMB_SEQS, 92544, device=dev, generator=gen)

    rows, groups = [], {}
    for d, shapes in cells:
        for c, r in shapes:
            src = big if d in D_MAIN else wide
            x = src[:c, :d].contiguous()
            y = src[-r:, :d].contiguous() if r <= src.shape[0] else \
                torch.rand(r, d, device=dev, generator=gen)
            w = (torch.rand(r, device=dev, generator=gen) > 0.3).float()
            xn2, yn2 = ops._norms_sq(x), ops._norms_sq(y)
            for kern, plan_of, launch in (
                    ("dot_pairwise", pk.pairwise_plan,
                     lambda p: pk.launch_pairwise("dot_pairwise", x, y, p)),
                    ("dot_centrality",
                     lambda *a, **k: pk.centrality_plan(
                         *a, crossover=pk.DOT_CENTRALITY_S, **k),
                     lambda p: pk.launch_dot_centrality(
                         x, y, xn2, yn2, w, p, "l2"))):
                with floors(pk, 1 << 30, 1 << 30):    # no split
                    unsplit = plan_of(c, r, d, sms, fp32_gram=True)
                by_floor = {}
                for path, values in FLOORS.items():
                    for f in values:
                        other = pk.SPLIT_MIN_D[
                            pk.TILE_SPLIT if path == pk.STREAM_SPLIT
                            else pk.STREAM_SPLIT]
                        fl = (f, other) if path == pk.STREAM_SPLIT \
                            else (other, f)
                        with floors(pk, *fl):
                            by_floor[(path, f)] = plan_of(c, r, d, sms,
                                                          fp32_gram=True)
                plans = [unsplit] + sorted(set(by_floor.values())
                                           - {unsplit})
                if len(plans) == 1:
                    continue
                want = launch(unsplit)
                tol = 1e-4 * want.abs() + 1e-4 * want.abs().max()
                if kern == "dot_centrality":     # the l2 self-pair allowance
                    tol = tol + 1e-3 * w.sum() * yn2.max().sqrt()
                for p in plans[1:]:
                    err = (launch(p) - want).abs()
                    if not bool((err <= tol).all()):
                        print(f"split_floor: {kern} {p} at ({c}, {r}, {d}) "
                              f"off by {float(err.max()):.3g}",
                              file=sys.stderr)
                        return 1
                us = {p: [] for p in plans}
                for p in plans + plans[::-1]:
                    us[p].append(timed(lambda p=p: launch(p), REPS))
                mean = {p: sum(v) / 2 for p, v in us.items()}
                path = next(p[0] for p in plans if p[0] in pk.SPLIT_PATHS)
                g = groups.setdefault((kern, d, path), {
                    "shapes": 0, "unsplit": 0.0,
                    **{f: [0.0, 0] for f in FLOORS[path]}})
                g["shapes"] += 1
                g["unsplit"] += mean[unsplit]
                for f in FLOORS[path]:
                    t = mean[by_floor[(path, f)]]
                    g[f][0] += t
                    g[f][1] += t > (1 + NOISE) * mean[unsplit]
                rows.append({"kernel": kern, "c": c, "r": r, "d": d,
                             "unsplit": [unsplit, us[unsplit]],
                             "floors": {f"{pth} {f}": [p, us[p]]
                                        for (pth, f), p in by_floor.items()}})
    del big, wide
    for (kern, d, path), g in sorted(groups.items()):
        print(f"split_floor {kern} d {d} {path}: {g['shapes']} shapes, us "
              f"summed: unsplit {g['unsplit']:.1f}; " + ", ".join(
                  f"floor {f} {g[f][0]:.1f} ({g[f][1]} slower)"
                  for f in FLOORS[path]),
              flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(
        {"device": torch.cuda.get_device_name(0), "smi": cs._smi(),
         "current": dict(pk.SPLIT_MIN_D), "width": pk.SPLIT_MIN_WIDTH,
         "rows": rows}, indent=1))
    print(f"split_floor: {cs._smi()}; {len(rows)} timed shapes in {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
