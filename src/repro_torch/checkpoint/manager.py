"""Checkpoint manager: atomic commits, rotation, auto-resume.

The port of ``repro.checkpoint.manager``, with the reference's on-disk
format, so a checkpoint that either package wrote restores in the other:

  <dir>/step_<N>/   arrays.npz   (flattened tree leaves, keyed by path)
                    META.json    (sorted keys, step, extra)
  <dir>/step_<N>.tmp             (staging; renamed to commit)

A tree is nested dicts, lists / tuples and NamedTuples whose leaves are
tensors, numpy arrays or numbers (``None`` holds no leaf); a leaf's key is
its path joined by ``/`` as ``jax.tree_util`` names it: a dict key, ``[i]``
for a list index, a NamedTuple's field name (``params/layers/attn/wq``,
``opt/mu/embed``, ``opt/step``). A leaf may also be a callable returning
one, called when it is written, so a full-width train state is converted
one leaf at a time. bf16 is stored as f32 (npz has no bf16; lossless) and
``restore`` casts each array to its target leaf's dtype.

* atomic commit: a writer stages into a tmp dir and renames it, so a
  crashed writer never corrupts the latest checkpoint;
* rotation keeps the newest ``keep`` checkpoints;
* ``latest_step`` / ``restore`` pick the newest committed checkpoint.

Under an initialised ``torch.distributed`` world every rank calls
``save``: a DTensor leaf is gathered whole (``full_tensor``, a collective,
in the same order on every rank), rank 0 alone writes, and it commits
after a barrier, so every rank returns with the checkpoint committed.
``restore(shardings=)`` is the reference's elastic placement: each rank
reads the full array and keeps its own shard of the leaf's
``NamedSharding`` (``distribute_tensor(..., src_data_rank=None)``, no
scatter), whatever mesh wrote it.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_with_paths(tree, prefix=()):
    """[(path parts, leaf)] in ``jax.tree_util``'s order (dict keys
    sorted)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten_with_paths(tree[k], prefix + (str(k),))]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in _flatten_with_paths(getattr(tree, f),
                                              prefix + (f,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree)
                for kv in _flatten_with_paths(x, prefix + (f"[{i}]",))]
    return [(prefix, tree)]


def _world():
    """(rank, world size) of the initialised process group, else (0, 1)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _materialize(leaf):
    """A leaf's value: a callable called, a DTensor gathered whole."""
    from torch.distributed.tensor import DTensor
    if callable(leaf) and not isinstance(leaf, (torch.Tensor, np.ndarray)):
        leaf = leaf()
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    return leaf


def _to_numpy(leaf) -> np.ndarray:
    leaf = _materialize(leaf)
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:   # npz has no bf16: store f32
            t = t.float()
        return t.cpu().numpy()
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return a


def _write_npz(path: str, items: list) -> list:
    """``np.savez``'s file, its arrays converted and written one at a
    time: a worker thread converts the next leaf (a device-to-host copy)
    while this one is written. Returns the keys."""
    keys = []
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf, \
            ThreadPoolExecutor(1) as pool:
        nxt = pool.submit(_to_numpy, items[0][1]) if items else None
        for i, (key, _) in enumerate(items):
            arr = nxt.result()
            nxt = pool.submit(_to_numpy, items[i + 1][1]) \
                if i + 1 < len(items) else None
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(arr),
                                          allow_pickle=False)
            keys.append(key)
            del arr
    return keys


def save(ckpt_dir: str, step: int, tree: Any, *, extra: Optional[dict] = None,
         keep: int = 3) -> str:
    """Atomically write the checkpoint of ``step``; rotate old ones. Under
    a process group every rank calls it (see the module docstring)."""
    rank, world = _world()
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    items = [("/".join(p), leaf) for p, leaf in _flatten_with_paths(tree)]
    if rank:
        for _, leaf in items:        # the gathers rank 0 makes as it writes
            _materialize(leaf)
    else:
        os.makedirs(ckpt_dir, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        keys = _write_npz(os.path.join(tmp, "arrays.npz"), items)
        meta = {"step": step, "keys": sorted(keys), "extra": extra or {}}
        with open(os.path.join(tmp, "META.json"), "w") as f:
            json.dump(meta, f)
    if world > 1:
        torch.distributed.barrier()
    if not rank:
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)         # atomic commit
        _rotate(ckpt_dir, keep)
    if world > 1:
        torch.distributed.barrier()
    return final


def _rotate(ckpt_dir: str, keep: int):
    steps = all_steps(ckpt_dir)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "META.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, target: Any, step: Optional[int] = None,
            shardings: Any = None) -> tuple[Any, dict]:
    """Restore into the structure of ``target``, a tree whose leaves are
    tensors (on the meta device, a shape and dtype only) or numpy arrays.
    Each leaf comes back as ``target``'s kind of leaf in its dtype: a
    tensor on the leaf's device (the CPU for a meta leaf), or a numpy
    array. ``shardings``: a tree of the same paths whose leaves are
    ``models.sharding.NamedSharding`` (or None); such a leaf comes back as
    a DTensor of that sharding on its mesh's device, this rank's shard of
    the full array. Returns (tree, META)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "META.json")) as f:
        meta = json.load(f)
    npz = os.path.join(d, "arrays.npz")
    placed = dict((p, s) for p, s in _flatten_with_paths(shardings)) \
        if shardings is not None else {}

    def load(path, leaf):
        arr = _read_member(npz, "/".join(path))
        if isinstance(leaf, torch.Tensor):
            if not arr.flags.c_contiguous:
                arr = np.ascontiguousarray(arr)
            t = torch.from_numpy(arr).to(leaf.dtype)
            dev = leaf.device if leaf.device.type != "meta" else "cpu"
            t = t.to(dev)
            if placed.get(path) is not None:
                from repro_torch.models.sharding import distribute
                t = distribute(t, placed[path])
            return t
        return np.asarray(arr).astype(np.asarray(leaf).dtype)

    return _map_with_paths(load, target), meta


def _read_member(npz: str, key: str) -> np.ndarray:
    """Array ``key`` of an ``.npz``: a stored (uncompressed) member, as
    ``np.savez`` and :func:`save` write them, is read straight from its
    offset in the file (no chunked copy through ``zipfile`` and its
    CRC: the commit is atomic); a compressed one through ``np.load``."""
    with zipfile.ZipFile(npz) as zf:
        info = zf.getinfo(key + ".npy")
    readers = {(1, 0): np.lib.format.read_array_header_1_0,
               (2, 0): np.lib.format.read_array_header_2_0}
    stored = info.compress_type == zipfile.ZIP_STORED
    with open(npz, "rb") as f:
        f.seek(info.header_offset)
        head = f.read(30)                       # the local file header
        name_len = int.from_bytes(head[26:28], "little")
        extra_len = int.from_bytes(head[28:30], "little")
        f.seek(info.header_offset + 30 + name_len + extra_len)
        version = np.lib.format.read_magic(f) if stored else None
        if version in readers:
            shape, fortran, dtype = readers[version](f)
            if not dtype.hasobject:
                arr = np.fromfile(f, dtype=dtype,
                                  count=int(np.prod(shape, dtype=np.int64)))
                return arr.reshape(shape, order="F" if fortran else "C")
    with np.load(npz) as data:
        return data[key]


def _map_with_paths(fn, tree, prefix=()):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_paths(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*[_map_with_paths(fn, getattr(tree, f),
                                            prefix + (f,))
                            for f in tree._fields])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_paths(fn, x, prefix + (f"[{i}]",))
                          for i, x in enumerate(tree))
    return fn(prefix, tree)
