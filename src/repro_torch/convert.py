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

import functools

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


def _unstack(cfg, tree) -> dict:
    """``{port name: leaf}`` of a tree in the JAX params layout (nested
    dicts whose leaves carry the stacked layer axes of
    :func:`_stacked_axes`; numpy arrays or tensors), each stacked leaf cut
    into its layers. Raises ``ValueError`` unless the names are exactly
    the port's."""
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
        if stack is None:
            got[path] = node
            return
        spath, sizes = stack
        if tuple(node.shape[:len(sizes)]) != sizes:
            raise ValueError(f"{cfg.name}: {path} has shape "
                             f"{tuple(node.shape)}, no leading axes of "
                             f"{sizes} stacked layers")
        rest = path[len(spath) + 1:]
        for idx in np.ndindex(*sizes):
            got[".".join([spath, *map(str, idx), rest])] = node[idx]

    walk(tree, "", None)
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"{cfg.name}: missing keys {missing}, extra keys "
                         f"{extra}")
    return got


def stacked_tree(cfg, named: dict, lazy: bool = False) -> dict:
    """The inverse of :func:`_unstack`: ``{port name: tensor}`` as nested
    dicts in the JAX params layout, each stacked leaf the ``torch.stack``
    of its layers' tensors (reshaped to the stacked axes). ``lazy``: each
    stacked leaf is a function that stacks when called (the checkpoint
    writer calls them one at a time, so a full-width state is never
    stacked whole)."""
    stacks = _stacked_axes(cfg)
    tree: dict = {}

    def put(path, leaf):
        node = tree
        *heads, last = path.split(".")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf

    def stacked(tensors, sizes):
        return torch.stack(tensors).reshape(sizes + tuple(tensors[0].shape))

    groups: dict = {}
    for name, t in named.items():
        for spath, sizes in stacks.items():
            if name.startswith(spath + "."):
                parts = name[len(spath) + 1:].split(".")
                idx = tuple(int(i) for i in parts[:len(sizes)])
                rest = ".".join(parts[len(sizes):])
                groups.setdefault((spath, rest), {})[idx] = t
                break
        else:
            put(name, t)
    for (spath, rest), layers in groups.items():
        sizes = stacks[spath]
        ts = [layers[idx] for idx in np.ndindex(*sizes)]
        put(f"{spath}.{rest}", functools.partial(stacked, ts, sizes)
            if lazy else stacked(ts, sizes))
    return tree


def _lm_state_dict(cfg, tree) -> dict:
    """The port's ``state_dict`` for the JAX params pytree ``tree`` (nested
    dicts of numpy arrays); see :func:`lm_params_from_jax`."""
    from repro_torch.models.model import weights_init

    want = weights_init(cfg, None, "meta").state_dict()
    try:
        got = _unstack(cfg, tree)
    except ValueError as e:
        raise ValueError(f"lm_params_from_jax: {e}") from None
    out = {}
    for name, spec in want.items():
        t = _numpy_to_torch(np.asarray(got[name]))
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


def train_state_from_jax(cfg, state, device=None):
    """The port's ``train.train_step.TrainState`` for the JAX package's
    ``TrainState`` ``state`` (its leaves numpy arrays,
    ``jax.tree.map(np.asarray, state)``), bit for bit on ``device`` (CUDA
    unless asked otherwise): the weights through :func:`lm_params_from_jax`
    (made trainable), AdamW's step and f32 moments, the error-feedback
    residuals where there are any, and the step."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.optim.compress import EFState
    from repro_torch.train.train_step import TrainState

    dev = resolve_device(device)

    def moments(tree):
        return {k: _numpy_to_torch(np.asarray(v, dtype=np.float32)).to(dev)
                for k, v in _unstack(cfg, tree).items()}

    def scalar(v):
        return torch.tensor(int(np.asarray(v)), dtype=torch.int32,
                            device=dev)

    params = lm_params_from_jax(cfg, state.params,
                                device=dev).requires_grad_(True)
    opt = AdamWState(step=scalar(state.opt.step), mu=moments(state.opt.mu),
                     nu=moments(state.opt.nu))
    ef = None if state.ef is None else EFState(error=moments(state.ef.error))
    return TrainState(params=params, opt=opt, ef=ef, step=scalar(state.step))


def train_state_tree(cfg, state, lazy: bool = False) -> dict:
    """A port ``TrainState`` as the JAX ``TrainState``'s tree (the
    checkpoint's keys: ``params/...``, ``opt/step``, ``opt/mu/...``,
    ``opt/nu/...``, ``ef/error/...``, ``step``), stacked as JAX stacks its
    layers; ``lazy`` as in :func:`stacked_tree`."""
    from repro_torch.optim.adamw import named

    def tree(d):
        return stacked_tree(cfg, d, lazy)

    return {"params": tree({k: p.detach()
                            for k, p in named(state.params).items()}),
            "opt": {"step": state.opt.step, "mu": tree(state.opt.mu),
                    "nu": tree(state.opt.nu)},
            "ef": None if state.ef is None else {"error": tree(
                state.ef.error)},
            "step": state.step}


def load_train_state(cfg, state, tree) -> None:
    """Copy ``tree`` (:func:`train_state_tree`'s layout, as
    ``checkpoint.manager.restore`` returns it) into ``state``'s tensors in
    place."""
    from repro_torch.optim.adamw import named

    def load(dst: dict, src):
        with torch.no_grad():
            for k, t in _unstack(cfg, src).items():
                dst[k].copy_(t)

    load(named(state.params), tree["params"])
    load(state.opt.mu, tree["opt"]["mu"])
    load(state.opt.nu, tree["opt"]["nu"])
    if state.ef is not None:
        load(state.ef.error, tree["ef"]["error"])
    state.opt.step.copy_(tree["opt"]["step"])
    state.step.copy_(tree["step"])
