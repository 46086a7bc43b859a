"""Runtime hardening: step watchdog, straggler stats, restart loop.

The port of ``repro.runtime.fault_tolerance`` (pure Python):

* :class:`StepWatchdog` tracks step wall times with a robust (median +
  MAD) straggler threshold; ``record`` flags steps beyond it;
* :func:`run_with_restarts` supervises a step function, restarting from
  the latest committed checkpoint on failure, up to ``max_restarts``. With
  the stateless data pipeline (skip to a step) and atomic checkpoints this
  gives exactly-once-equivalent training;
* :func:`elastic_mesh_shape` sizes the largest (dp, tp) grid for the
  healthy device count, and :func:`elastic_remesh` builds that
  ("data", "model") ``DeviceMesh`` over the live ``torch.distributed``
  world; ``checkpoint.manager.restore(shardings=)`` places a checkpoint
  onto it (``launch/train.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional


@dataclasses.dataclass
class StepWatchdog:
    window: int = 50
    mad_factor: float = 5.0
    min_samples: int = 8
    _times: list = dataclasses.field(default_factory=list)
    stragglers: int = 0

    def record(self, seconds: float) -> bool:
        """Record a step time; returns True if it's a straggler step."""
        ts = self._times
        is_straggler = False
        if len(ts) >= self.min_samples:
            srt = sorted(ts)
            med = srt[len(srt) // 2]
            mad = sorted(abs(t - med) for t in ts)[len(ts) // 2]
            if seconds > med + self.mad_factor * max(mad, 0.05 * med):
                is_straggler = True
                self.stragglers += 1
        ts.append(seconds)
        if len(ts) > self.window:
            ts.pop(0)
        return is_straggler


def run_with_restarts(step_fn: Callable[[int], int], *, start_step: int,
                      total_steps: int, max_restarts: int = 3,
                      on_restart: Optional[Callable[[int, Exception], int]]
                      = None) -> int:
    """Drive ``step_fn(step) -> next_step`` to completion with restart on
    a crash. ``on_restart(step, exc) -> resume_step`` reloads the state (a
    checkpoint) and returns where to resume."""
    step = start_step
    restarts = 0
    while step < total_steps:
        try:
            step = step_fn(step)
        except Exception as exc:  # noqa: BLE001 — supervisor boundary
            restarts += 1
            if restarts > max_restarts:
                raise
            if on_restart is None:
                raise
            step = on_restart(step, exc)
    return step


def elastic_mesh_shape(num_devices: int, preferred_tp: int = 16
                       ) -> tuple[int, int]:
    """Largest (dp, tp) grid for the currently healthy device count: keep
    tp if it divides, else the largest power-of-two tp that does."""
    tp = preferred_tp
    while tp > 1 and num_devices % tp:
        tp //= 2
    return num_devices // tp, tp


def elastic_remesh(axis_names=("data", "model"), preferred_tp: int = 16):
    """A (dp, tp) ``DeviceMesh`` over every rank of the initialised
    process group, shaped by :func:`elastic_mesh_shape`."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    return make_mesh(elastic_mesh_shape(dist.get_world_size(), preferred_tp),
                     axis_names)
