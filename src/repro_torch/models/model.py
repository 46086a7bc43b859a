"""Unified Model interface: init / prefill / decode for the dense family.

The port of ``repro.models.model``. ``build_model(cfg)`` returns a
:class:`Model` whose members are plain functions over the weights module
that ``init`` builds. Batches are dicts ``{"tokens": (B, S) ints}``.

Ported: the dense decoders. The other families raise
``NotImplementedError`` at ``build_model``, naming the ROADMAP item that
ports them: MoE (14b), VLM and audio (14c), the recurrent ssm / hybrid
families (14d). ``loss`` (with ``fused_xent`` and ``_xent``) comes with
training, item 14e.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Union

import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.convert import resolve_device
from repro_torch.models import transformer as T

_UNPORTED = {
    "moe": "MoE decoders (models/moe.py, models/mla.py): ROADMAP item 14b",
    "vlm": "the VLM family (cross-attention layers): ROADMAP item 14c",
    "audio": "the enc-dec audio family (models/encdec.py): ROADMAP item 14c",
    "ssm": "the recurrent ssm family (models/xlstm.py, models/recurrent.py):"
           " ROADMAP item 14d",
    "hybrid": "the hybrid family (models/mamba2.py, models/recurrent.py): "
              "ROADMAP item 14d",
}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelCfg
    init: Callable[..., Any]            # (seed | generator, device=) -> weights
    prefill: Callable[..., Any]         # (params, batch, max_len) -> (logits, cache)
    decode_step: Callable[..., Any]     # (params, token, cache, pos, batch=) -> (logits, cache)
    init_cache: Callable[..., Any]      # (batch_size, max_len, device=) -> cache


def _generator(seed: Union[int, torch.Generator], device) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device=device).manual_seed(int(seed))


def check_ported(cfg: ModelCfg) -> None:
    """Raise ``NotImplementedError`` for a family (or a dense config with
    MoE, MLA or cross-attention layers) the port does not run yet, naming
    its ROADMAP item; ``ValueError`` for an unknown family."""
    fam = cfg.family
    if fam in _UNPORTED:
        raise NotImplementedError(f"{cfg.name}: {_UNPORTED[fam]}")
    if fam != "dense":
        raise ValueError(f"unknown family {fam!r}")
    T.check_dense(cfg)


def build_model(cfg: ModelCfg) -> Model:
    check_ported(cfg)

    def init(seed: Union[int, torch.Generator] = 0, device=None):
        """The weights on ``device`` from a seed or a ``torch.Generator``
        (on that device): CUDA unless ``device`` (or the generator's
        device) says otherwise."""
        if device is None and isinstance(seed, torch.Generator):
            device = seed.device
        device = resolve_device(device)
        return T.transformer_init(_generator(seed, device), cfg, device)

    def prefill(params, batch, max_len):
        return T.transformer_prefill(params, cfg, batch["tokens"], max_len)

    def decode_step(params, token, cache, pos, batch=None):
        return T.transformer_decode_step(params, cfg, token, cache, pos)

    def init_cache(batch_size, max_len, device=None):
        return T.init_kv_cache(cfg, batch_size, max_len, device)

    return Model(cfg=cfg, init=init, prefill=prefill,
                 decode_step=decode_step, init_cache=init_cache)
