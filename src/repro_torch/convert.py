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
        return torch.from_numpy(bits.copy()).view(torch.bfloat16) \
            .reshape(a.shape)
    return torch.from_numpy(np.array(a, copy=True))


def _stacked_axes(cfg) -> dict:
    """The subtrees of the JAX params whose leaves carry stacked layer
    axes (``jax.vmap`` over split keys), by dotted path: their sizes."""
    if cfg.family == "audio":
        return {"enc": (cfg.encoder_layers or cfg.num_layers,),
                "dec": (cfg.num_layers,)}
    if cfg.family == "ssm":
        from repro_torch.models.recurrent import _xlstm_layout
        G, R = _xlstm_layout(cfg)
        return {"groups.mlstm": (G, R), "groups.mln": (G, R),
                "groups.slstm": (G,), "groups.sln": (G,)}
    if cfg.family == "hybrid":
        from repro_torch.models.recurrent import _hybrid_layout
        G, E = _hybrid_layout(cfg)
        return {"mamba": (G, E), "mln": (G, E)}
    if cfg.cross_attn_every:
        groups = cfg.num_layers // cfg.cross_attn_every
        return {"groups.self": (groups, cfg.cross_attn_every - 1),
                "groups.cross": (groups,)}
    return {"layers": (cfg.num_layers,)}


def _lm_state_dict(cfg, tree) -> dict:
    """The port's ``state_dict`` for the JAX params pytree ``tree`` (nested
    dicts of numpy arrays); see :func:`lm_params_from_jax`."""
    from repro_torch.models.model import weights_init

    want = weights_init(cfg, None, "meta").state_dict()
    stacks = _stacked_axes(cfg)
    got = {}

    def walk(node, path, stack):
        if isinstance(node, dict):
            for k, v in node.items():
                p = f"{path}.{k}" if path else k
                walk(v, p, (p, stacks[p]) if p in stacks else stack)
            return
        a = np.asarray(node)
        if stack is None:
            got[path] = a
            return
        spath, sizes = stack
        if a.shape[:len(sizes)] != sizes:
            raise ValueError(f"lm_params_from_jax: {path} has shape "
                             f"{a.shape}, no leading axes of {sizes} "
                             f"stacked layers")
        rest = path[len(spath) + 1:]
        for idx in np.ndindex(*sizes):
            got[".".join([spath, *map(str, idx), rest])] = a[idx]

    walk(tree, "", None)
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
    """The port's weights module (``repro_torch.models.transformer.
    Transformer``; ``models.encdec.EncDec`` for the audio family,
    ``models.recurrent.XLSTM`` / ``Hybrid`` for ssm / hybrid) holding the
    JAX package's ``params`` pytree ``tree``, bit for bit, on ``device``
    (CUDA unless asked otherwise). The stacked layer axes (``layers``; a
    VLM's ``groups.self`` (groups, per - 1) and ``groups.cross``; enc-dec's
    ``enc`` and ``dec``; xLSTM's ``groups.{mlstm,mln}`` (G, R) and
    ``groups.{slstm,sln}`` (G,); the hybrid's ``mamba`` and ``mln`` (G, E))
    are unstacked into ``layers.{i}.*``, ``groups.self.{g}.{j}.*`` and so
    on; every array keeps its dtype and bits (the MoE router, xLSTM's gates,
    Mamba2's ``A_log`` / ``D`` / ``dt_bias`` and the norms in f32). Raises
    ``ValueError`` for a missing or extra key, a wrong shape or a dtype
    other than the config's."""
    from repro_torch.models.model import weights_init

    sd = _lm_state_dict(cfg, tree)
    model = weights_init(cfg, None, "meta")
    model.load_state_dict(sd, assign=True)
    return model.to(resolve_device(device))
