"""Carry state into the port, and the port's device rule.

The medoid system has no weights: its state is the data matrix and the
PRNG key. :func:`data_from_numpy` and :func:`key_from_jax_data` take what a
caller of the JAX package holds — a numpy array and
``np.asarray(jax.random.key_data(k))`` — so a test hands the same inputs to
both packages. The LM scaffold's weights cross with
:func:`lm_params_from_jax`, from the JAX params pytree as numpy arrays.

Device rule (:func:`resolve_device`): an explicit ``device`` wins; otherwise
a tensor keeps its own device; otherwise the port runs on CUDA, and raises
when there is none rather than carry on quietly on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.engine.rng import Key


def resolve_device(device=None, like=None) -> torch.device:
    """The device an entry point runs on (see the module docstring)."""
    if device is not None:
        return torch.device(device)
    if isinstance(like, torch.Tensor):
        return like.device
    if not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on CUDA and none is available; "
                           "pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def data_from_numpy(arr, device=None) -> torch.Tensor:
    """An (n, d) array as a contiguous float32 tensor on ``device``."""
    return torch.as_tensor(np.ascontiguousarray(arr, dtype=np.float32)) \
        .to(resolve_device(device))


def key_from_jax_data(words, device=None) -> Key:
    """A :class:`Key` from the (2,) uint32 ``jax.random.key_data`` words."""
    w = np.asarray(words, dtype=np.uint32).reshape(2).astype(np.int64)
    return Key(torch.as_tensor(w).to(resolve_device(device)))


def _numpy_to_torch(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a tensor with the same bits: bf16 arrays (numpy
    dtype ``bfloat16`` from ``np.asarray`` of a JAX bf16 array, which
    ``torch.from_numpy`` refuses) through their int16 bit patterns."""
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _lm_state_dict(cfg, tree) -> dict:
    """The port's ``state_dict`` for the JAX params pytree ``tree`` (nested
    dicts of numpy arrays); see :func:`lm_params_from_jax`."""
    from repro_torch.models.transformer import transformer_init

    want = transformer_init(None, cfg, "meta").state_dict()
    got = {}

    def walk(node, prefix, layer_axis):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}.", layer_axis or prefix + k == "layers")
            return
        a = np.asarray(node)
        name = prefix[:-1]
        if not layer_axis:
            got[name] = a
            return
        rest = name[len("layers."):]
        if a.ndim == 0 or a.shape[0] != cfg.num_layers:
            raise ValueError(f"lm_params_from_jax: {name} has shape "
                             f"{a.shape}, no leading axis of "
                             f"{cfg.num_layers} layers")
        for i in range(cfg.num_layers):
            got[f"layers.{i}.{rest}"] = a[i]

    walk(tree, "", False)
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"lm_params_from_jax: {cfg.name}: missing keys "
                         f"{missing}, extra keys {extra}")
    out = {}
    for name, spec in want.items():
        t = _numpy_to_torch(got[name])
        if tuple(t.shape) != tuple(spec.shape) or t.dtype != spec.dtype:
            raise ValueError(f"lm_params_from_jax: {name} is "
                             f"{tuple(t.shape)} {t.dtype}, the port wants "
                             f"{tuple(spec.shape)} {spec.dtype}")
        out[name] = t
    return out


def lm_params_from_jax(cfg, tree, device=None):
    """The port's model (a ``repro_torch.models.transformer.Transformer``)
    holding the JAX package's dense-decoder ``params`` pytree ``tree``, bit
    for bit, on ``device`` (CUDA unless asked otherwise). The leading
    layer axis of ``tree["layers"]`` (stacked by ``jax.vmap`` over split
    keys) is unstacked into ``layers.{i}.*``; every array keeps its dtype
    and bits. Raises ``ValueError`` for a missing or extra key, a wrong
    shape or a dtype other than the config's."""
    from repro_torch.models.transformer import transformer_init

    sd = _lm_state_dict(cfg, tree)
    model = transformer_init(None, cfg, "meta")
    model.load_state_dict(sd, assign=True)
    return model.to(resolve_device(device))
