"""Mesh construction.

The port of ``repro.launch.mesh``. Functions, never module-level meshes, so
importing this module touches no process group. The meshes are
``torch.distributed.device_mesh.DeviceMesh`` objects over the initialised
process group, on its device type: CUDA under NCCL, the CPU under gloo or
the ``fake`` backend (the dry run's 256 or 512 placeholder ranks).

The production shapes and axis names are the reference's, so the partition
rules and the dry run's memory policy (``chips // 16``, ``% 16``) read the
same layouts: (16, 16) ("data", "model") is 256 cards, (2, 16, 16) ("pod",
"data", "model") 512.
"""
from __future__ import annotations


def _device_type() -> str:
    import torch.distributed as dist
    backend = dist.get_backend() if dist.is_initialized() else None
    return "cuda" if backend == "nccl" else "cpu"


def make_mesh(shape, axes):
    """A ``DeviceMesh`` of ``shape`` with dim names ``axes`` over the
    initialised process group (ranks in row-major order)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 (256 cards) or 2x16x16 (two groups of 256, 512 cards)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def axis_names(mesh) -> tuple:
    """A mesh's axis names: a ``DeviceMesh``'s dim names, a JAX mesh's
    ``axis_names``, or the first item of a plain (names, sizes) pair."""
    if isinstance(mesh, tuple):
        return tuple(mesh[0])
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of any mesh :func:`axis_names` reads."""
    if isinstance(mesh, tuple):
        sizes = mesh[1]
    elif hasattr(mesh, "mesh_dim_names"):
        sizes = mesh.shape
    else:
        sizes = mesh.devices.shape
    return dict(zip(axis_names(mesh), tuple(sizes)))


def batch_axes(mesh) -> tuple:
    """Mesh axes the global batch shards over."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def logical_rules(mesh, seq_shard: bool = False) -> dict:
    """Logical-axis mapping installed around model code (see
    ``models.sharding``).

    ``seq_shard=True`` maps the logical "seq" axis (used on residual-stream
    constraints) to the model axis — Megatron-style sequence parallelism:
    activations between blocks live seq-sharded, attention/MLP gather/scatter
    around their TP compute, halving collective bytes vs all-reduce and
    cutting live activation memory by the TP degree.
    """
    return {
        "batch": batch_axes(mesh),
        "model": "model",
        "expert": "model",
        "vocab": "model",   # vocab/logits sharding survives pure-FSDP mode
        "seq": "model" if seq_shard else None,
    }
