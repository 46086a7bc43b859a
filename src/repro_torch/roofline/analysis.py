"""Three-term roofline from a dry-run count.

The port of ``repro.roofline.analysis``:

  compute term    = dot_flops / peak_MMA + elem_flops / peak_f32
  memory term     = per-card live bytes / HBM bandwidth
  collective term = per-card collective bytes / link bandwidth

The inputs come from ``op_cost`` (the counterpart of ``hlo_cost``): the ops
one rank dispatches in a fake-backend run, so every byte and flop is PER
CARD. Collective bytes are the result bytes of every all-reduce /
all-gather / reduce-scatter / all-to-all, an all-reduce counted twice
(reduce-scatter then all-gather on a ring).

Hardware model, one NVIDIA H100 SXM5 80GB (NVIDIA's data sheet, dense
rates; H100 80GB HBM3, 700.00 W): 989 TFLOP/s bf16 on the tensor cores,
67 TFLOP/s f32 outside them, 3.35 TB/s HBM, NVLink 4 at 450 GB/s per
direction. The collective term assumes every collective runs over NVLink,
which holds inside one node of 8 cards; a mesh axis longer than 8 crosses
nodes, whose network is slower, so there the term is a lower bound.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

# H100 SXM5 80GB, 700.00 W (data-sheet peaks)
PEAK_FLOPS = 989e12          # bf16 dense, tensor cores
VPU_FLOPS = 67e12            # f32 outside the tensor cores
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 450e9              # bytes/s, NVLink 4, one direction


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict
    total_bytes: int
    count_by_kind: dict


@dataclasses.dataclass
class Roofline:
    """All byte/flop figures are PER CARD (one rank's dispatched ops)."""
    flops: float                 # per-card flops (dot + elementwise)
    hbm_bytes: float             # per-card bytes the step must stream
    collective_bytes: float      # per-card collective bytes
    chips: int
    model_flops: float = 0.0     # analytic 6*N*D (or 6*N_active*D), ALL cards
    dot_flops: float = 0.0       # tensor-core-eligible portion
    elem_flops: float = 0.0      # elementwise / reduction portion

    @property
    def t_compute(self) -> float:
        if self.dot_flops or self.elem_flops:
            return self.dot_flops / PEAK_FLOPS + self.elem_flops / VPU_FLOPS
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Roofline-optimistic step time: max of the three terms (perfect
        overlap of compute, HBM and links)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_frac(self) -> Optional[float]:
        if not self.model_flops:
            return None
        return self.model_flops / max(self.flops * self.chips, 1.0)

    @property
    def mfu(self) -> Optional[float]:
        """Model-FLOPs utilization at the roofline-optimistic step time."""
        if not self.model_flops:
            return None
        return (self.model_flops / (self.chips * PEAK_FLOPS)) / \
            max(self.step_time, 1e-30)

    def row(self) -> dict:
        out = {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck, "step_time_s": self.step_time,
            "model_flops": self.model_flops,
            "useful_flops_frac": self.useful_flops_frac, "mfu": self.mfu,
            "dot_flops": self.dot_flops, "elem_flops": self.elem_flops,
        }
        if hasattr(self, "traffic_upper"):
            out["traffic_upper"] = self.traffic_upper
        return out


def count_params(params) -> int:
    """Elements of a weights module or ``{name: tensor}`` (the global
    count for DTensors)."""
    if hasattr(params, "named_parameters"):
        params = dict(params.named_parameters())
    return sum(int(t.numel()) for t in params.values())


def model_flops_train(num_params: int, tokens: int,
                      active_frac: float = 1.0) -> float:
    """6*N*D for a train step (fwd+bwd)."""
    return 6.0 * num_params * active_frac * tokens


def model_flops_decode(num_params: int, batch: int,
                       active_frac: float = 1.0) -> float:
    """2*N per generated token (one fwd)."""
    return 2.0 * num_params * active_frac * batch


def from_cost(cost, *, chips: int, live_bytes: float,
              model_flops: float = 0.0) -> Roofline:
    """The roofline of one rank's :class:`~repro_torch.roofline.op_cost.
    OpCost`. Memory term: the per-card LIVE bytes (arguments + outputs +
    temporaries), the bytes a perfectly fused step streams at least once;
    the count's unfused operand + result bytes stay as ``traffic_upper``
    (eager PyTorch fuses nothing, so it overestimates)."""
    r = Roofline(flops=cost.flops, hbm_bytes=float(live_bytes),
                 collective_bytes=cost.collective_bytes, chips=chips,
                 model_flops=model_flops, dot_flops=cost.dot_flops,
                 elem_flops=cost.elem_flops)
    r.traffic_upper = cost.traffic_bytes
    return r


def collective_stats(cost) -> CollectiveStats:
    return CollectiveStats(
        bytes_by_kind=dict(cost.collective_by_kind),
        total_bytes=int(cost.collective_bytes),
        count_by_kind=dict(cost.collective_count))
