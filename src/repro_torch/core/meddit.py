"""Med-dit baseline [Bagaria et al. 2017]: UCB best-arm identification, the
counterpart of ``repro/core/meddit.py``.

Every pull of arm i draws an independent uniform reference J and observes
d(x_i, x_J). Each step pulls the ``batch`` arms of smallest lower confidence
bound, each against its own reference; the run stops when UCB(best) <=
LCB(every other arm), or at ``max_pulls``. The arithmetic follows the JAX
function expression for expression, in fp32: ``log_term = log(2 n /
delta)``, ``beta(c) = sigma * sqrt(2 log_term / c)``, the update ``(means[arms]
* c + vals) / (c + 1)``, paired distances computed directly (l2 is
``sqrt(sum((x - y)^2))``, not the Gram trick), first-index argmins, and the
step's arms in the order of ``lax.top_k(-lcb, batch)``
(:func:`repro_torch.engine.halving.default_select`), so ``arms[i]`` meets
``refs[i]`` as in JAX. Two roundings follow XLA's rather than torch's: square
roots are correctly rounded, and ``means[arms] * c + vals`` rounds once, as
the fused multiply-add XLA:CPU contracts it into.

A run is sequential and adaptive: an ulp in one estimate can swap two
near-tied lower bounds and send the rest of the run down another path. The
paired distances' fp32 sums round in each package's own order (XLA:CPU
contracts some products into FMAs and vectorises long rows), so on
real-valued rows the two packages agree in distribution, not step for step.
On integer-valued rows every paired distance is exact and the runs coincide
(``tests/test_torch_baselines.py``).

**The loop.** JAX runs the steps as one ``lax.while_loop`` on the device.
Here they run in chunks of ``chunk`` steps, each step masked by ``active =
~stopped & (pulls < max_pulls)`` evaluated on the state it starts from, so a
step after the stop changes nothing: the medoid, the pulls and ``means``
come out as JAX's for any chunk length. The host reads one flag a chunk.
The lower and upper bounds are kept per arm and updated at the pulled arms
only, by the same expressions, so no step recomputes them over all n.

On the card (``graph=None`` or ``True``) a chunk's draws are one launch of
``csrc/threefry.cu`` (:func:`repro_torch.kernels.threefry.threefry_draws`),
and the chunk's steps are one CUDA graph, captured once per (n, d, metric,
batch, chunk, device) on static buffers and replayed; each step's selection
is a ``topk_smallest`` launch. Data, state and scalars are copied into the
buffers outside the capture. A failed capture or launch raises: nothing
falls back to eager steps. ``graph=False`` runs the same steps eagerly with
the plain draws of :mod:`repro_torch.engine.rng` — the CPU's path, and on
the card the comparison the graph path is held bit-equal to.

Reachable through ``repro_torch.api.find_medoid(x, key, algo="meddit")``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.engine import rng
from repro_torch.engine.halving import _mean, default_select
from repro_torch.kernels import build
from repro_torch.kernels import pairwise_distance as pk
from repro_torch.kernels.threefry import threefry_draws, threefry_draws_plain

# Steps a chunk: the host reads one flag a chunk, and a run does at most
# CHUNK - 1 masked steps past its stop.
CHUNK = 128


class MedditResult(NamedTuple):
    medoid: torch.Tensor   # 0-d int64
    pulls: torch.Tensor    # 0-d int64, distance computations
    means: torch.Tensor    # (n,) float32, the final estimates


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    # The correctly rounded fp32 square root, as XLA and CUDA take it:
    # torch's vectorised CPU sqrt is within 0.5001 ulp, and through float64
    # the root rounds once more without error.
    return torch.sqrt(x.double()).float()


def _paired_distance(x: torch.Tensor, y: torch.Tensor,
                     metric: str) -> torch.Tensor:
    """Row-wise d(x_i, y_i) for x, y: (m, d) -> (m,)."""
    if metric == "l1":
        return (x - y).abs().sum(-1)
    if metric == "sql2":
        return ((x - y) ** 2).sum(-1)
    if metric == "l2":
        return _sqrt(((x - y) ** 2).sum(-1))
    if metric == "cosine":
        num = (x * y).sum(-1)
        den = torch.clamp_min(_sqrt((x * x).sum(-1)) * _sqrt((y * y).sum(-1)),
                              1e-12)
        return 1.0 - num / den
    raise ValueError(f"unknown metric {metric!r}")


@dataclass
class _State:
    """The loop's tensors: the per-arm state, its scalars and the data."""
    data: torch.Tensor        # (n, d) float32
    means: torch.Tensor       # (n,) float32
    counts: torch.Tensor      # (n,) float32
    lcb: torch.Tensor         # (n,) float32, means - beta(counts)
    ucb: torch.Tensor         # (n,) float32, means + beta(counts)
    pulls: torch.Tensor       # 0-d int64
    sigma: torch.Tensor       # 0-d float32
    two_log: torch.Tensor     # 0-d float32, 2 * log_term
    max_pulls: torch.Tensor   # 0-d int64
    arange: torch.Tensor      # (n,) int64


def _beta(st: _State, c: torch.Tensor) -> torch.Tensor:
    return st.sigma * _sqrt(st.two_log / c)


def _active(st: _State) -> torch.Tensor:
    """The while_loop's condition on the current state, a 0-d bool:
    not stopped (UCB(best) > LCB of some other arm) and pulls < max."""
    best = torch.argmin(st.means).reshape(1)
    others = torch.where(st.arange == best, torch.inf, st.lcb)
    stopped = st.ucb.gather(0, best)[0] <= others.min()
    return ~stopped & (st.pulls < st.max_pulls)


def _step(st: _State, refs: torch.Tensor, batch: int, metric: str) -> None:
    """One masked step in place: pull the ``batch`` arms of smallest LCB
    against ``refs (batch,)`` if the loop's condition holds."""
    active = _active(st)
    arms = default_select(st.lcb, batch)
    vals = _paired_distance(st.data[arms], st.data[refs], metric)
    c = st.counts[arms]
    m = st.means[arms]
    # XLA contracts m * c + vals into one fused multiply-add: round once
    # (the fp32 product is exact in float64)
    mc_v = (m.double() * c.double() + vals.double()).float()
    new_m = torch.where(active, mc_v / (c + 1.0), m)
    new_c = torch.where(active, c + 1.0, c)
    beta = _beta(st, new_c)
    st.means.index_copy_(0, arms, new_m)
    st.counts.index_copy_(0, arms, new_c)
    st.lcb.index_copy_(0, arms, new_m - beta)
    st.ucb.index_copy_(0, arms, new_m + beta)
    st.pulls.add_(active.long() * batch)


def _log_term(n: int, delta: float) -> np.float32:
    # jnp.log of the float32 2n/delta, rounded once from float64
    return np.float32(math.log(float(np.float32(2.0 * n / delta))))


def _init_state(data: torch.Tensor, key: rng.Key, metric: str, sigma: float,
                delta: float, init_pulls: int, max_pulls: int):
    """The state after the initial pulls (``init_pulls`` independent
    references per arm) and the key the steps start from."""
    n, dev = data.shape[0], data.device
    key, sub = rng.split(key)
    refs0 = rng.randint(sub, (n, init_pulls), 0, n)
    means = torch.zeros(n, dtype=torch.float32, device=dev)
    for k in range(init_pulls):
        means = means + _paired_distance(data, data[refs0[:, k]], metric)
    means = _mean(means, init_pulls)
    counts = torch.full((n,), float(init_pulls), device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    st = _State(data=data, means=means, counts=counts, lcb=means, ucb=means,
                pulls=torch.full((), n * init_pulls, **i64),
                sigma=torch.full((), float(np.float32(sigma)), **f32),
                two_log=torch.full((), float(np.float32(2.0)
                                             * _log_term(n, delta)), **f32),
                max_pulls=torch.full((), max_pulls, **i64),
                arange=torch.arange(n, device=dev))
    beta = _beta(st, counts)
    st.lcb, st.ucb = means - beta, means + beta
    return st, key


class _ChunkGraph:
    """One chunk of ``chunk`` masked steps captured as a CUDA graph on
    static buffers, with the loop's condition after the chunk in ``flag``.
    ``per_replay`` holds the kernel launches one replay makes, and
    ``per_replay_paths`` those of them by path (``PATH_LAUNCHES``)."""

    def __init__(self, n: int, d: int, metric: str, batch: int, chunk: int,
                 dev: torch.device):
        f32 = dict(dtype=torch.float32, device=dev)
        i64 = dict(dtype=torch.int64, device=dev)
        self.st = _State(
            data=torch.empty((n, d), **f32), means=torch.empty(n, **f32),
            counts=torch.empty(n, **f32), lcb=torch.empty(n, **f32),
            ucb=torch.empty(n, **f32), pulls=torch.empty((), **i64),
            sigma=torch.empty((), **f32), two_log=torch.empty((), **f32),
            max_pulls=torch.empty((), **i64),
            arange=torch.arange(n, device=dev))
        self.refs = torch.zeros((chunk, batch), dtype=torch.int32,
                                device=dev)
        build.function("topk_smallest_launch")    # load it before capture
        before = pk.LAUNCHES.copy()
        before_paths = pk.PATH_LAUNCHES.copy()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            for k in range(chunk):
                _step(self.st, self.refs[k], batch, metric)
            self.flag = _active(self.st)
        # capture enqueued nothing: a replay launches what it recorded
        self.per_replay = pk.LAUNCHES - before
        self.per_replay_paths = pk.PATH_LAUNCHES - before_paths
        pk.LAUNCHES.clear()
        pk.LAUNCHES.update(before)
        pk.PATH_LAUNCHES.clear()
        pk.PATH_LAUNCHES.update(before_paths)

    def load(self, st: _State) -> None:
        for name in ("data", "means", "counts", "lcb", "ucb", "pulls",
                     "sigma", "two_log", "max_pulls"):
            getattr(self.st, name).copy_(getattr(st, name))

    def run(self, refs: torch.Tensor) -> bool:
        """Replay on this chunk's references; True while the loop goes
        on."""
        self.refs.copy_(refs)
        self.graph.replay()
        pk.LAUNCHES.update(self.per_replay)
        pk.PATH_LAUNCHES.update(self.per_replay_paths)
        return bool(self.flag)


_GRAPHS: dict[tuple, _ChunkGraph] = {}


def clear_graphs() -> None:
    """Drop the captured chunk graphs and their buffers."""
    _GRAPHS.clear()


def meddit_medoid(data: torch.Tensor, key: rng.Key, *, metric: str = "l2",
                  sigma: float = 1.0, delta: Optional[float] = None,
                  batch: int = 64, init_pulls: int = 1, max_pulls: int = 0,
                  chunk: int = CHUNK,
                  graph: Optional[bool] = None) -> MedditResult:
    """Med-dit's medoid of ``data (n, d)`` (see the module docstring).
    ``max_pulls <= 0`` means ``1000 n``, ``delta=None`` means ``1 / n``.
    ``graph`` picks the card's path: ``None`` or ``True`` the kernel draws
    and the captured chunk graph, ``False`` eager steps on the plain draws;
    on the CPU only ``None`` and ``False`` are allowed."""
    data = data.float().contiguous()
    n, d = data.shape
    if not 1 <= batch <= n:
        raise ValueError(f"meddit: batch must be in [1, n={n}], got {batch}")
    if init_pulls < 1 or chunk < 1:
        raise ValueError("meddit: init_pulls and chunk must be >= 1")
    on_card = data.is_cuda
    if graph is None:
        graph = on_card
    if graph and not on_card:
        raise ValueError("meddit: graph=True needs a CUDA tensor")
    if key.device != data.device:
        raise ValueError(f"meddit: key on {key.device}, data on "
                         f"{data.device}")
    delta = 1.0 / n if delta is None else delta
    max_pulls = n * 1000 if max_pulls <= 0 else max_pulls
    st, key = _init_state(data, key, metric, sigma, delta, init_pulls,
                          max_pulls)
    going = bool(_active(st))
    if graph:
        gk = (n, d, metric, batch, chunk, data.device)
        if gk not in _GRAPHS:
            _GRAPHS[gk] = _ChunkGraph(n, d, metric, batch, chunk, data.device)
        g = _GRAPHS[gk]
        g.load(st)
        st = g.st
        while going:
            _, key, refs = threefry_draws(key, chunk, batch, n)
            going = g.run(refs)
    else:
        while going:
            _, key, refs = threefry_draws_plain(key, chunk, batch, n)
            for k in range(chunk):
                _step(st, refs[k], batch, metric)
            going = bool(_active(st))
    return MedditResult(medoid=torch.argmin(st.means), pulls=st.pulls.clone(),
                        means=st.means.clone())
