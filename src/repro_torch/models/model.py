"""Unified Model interface: init / prefill / decode for the transformer
and enc-dec families.

The port of ``repro.models.model``. ``build_model(cfg)`` returns a
:class:`Model` whose members are plain functions over the weights module
that ``init`` builds. Batches are dicts:

  {"tokens": (B, S) ints}                               dense, moe
  {"tokens", "image_embed": (B, N_img, d_model)}        vlm (patch stub)
  {"tokens", "frames": (B, S_enc, d_model)}             audio (conv stub)

Ported: the dense, moe (MoE and MLA layers), vlm and audio families. The
recurrent ssm / hybrid families raise ``NotImplementedError`` at
``build_model``, naming ROADMAP item 14d. ``loss`` (with ``fused_xent``
and ``_xent``) comes with training, item 14e.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Union

import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.convert import resolve_device
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as T

_UNPORTED = {
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
    """Raise ``NotImplementedError`` for a family the port does not run
    yet, naming its ROADMAP item; ``ValueError`` for an unknown family."""
    fam = cfg.family
    if fam in _UNPORTED:
        raise NotImplementedError(f"{cfg.name}: {_UNPORTED[fam]}")
    if fam not in ("dense", "moe", "vlm", "audio"):
        raise ValueError(f"unknown family {fam!r}")


def weights_init(cfg: ModelCfg, gen, device=None):
    """The family's weights module from ``gen`` on ``device`` (the rule of
    ``transformer.transformer_init``; the meta device draws nothing)."""
    check_ported(cfg)
    if cfg.family == "audio":
        return ED.encdec_init(gen, cfg, device)
    return T.transformer_init(gen, cfg, device)


def build_model(cfg: ModelCfg) -> Model:
    check_ported(cfg)

    def init(seed: Union[int, torch.Generator] = 0, device=None):
        """The weights on ``device`` from a seed or a ``torch.Generator``
        (on that device): CUDA unless ``device`` (or the generator's
        device) says otherwise."""
        if device is None and isinstance(seed, torch.Generator):
            device = seed.device
        device = resolve_device(device)
        return weights_init(cfg, _generator(seed, device), device)

    if cfg.family == "audio":
        def prefill(params, batch, max_len):
            return ED.encdec_prefill(params, cfg, batch["tokens"],
                                     batch["frames"], max_len)

        def decode_step(params, token, cache, pos, batch=None):
            return ED.encdec_decode_step(params, cfg, token, cache, pos)

        def init_cache(batch_size, max_len, device=None):
            return ED.encdec_init_cache(cfg, batch_size, max_len, device)
    else:
        def prefill(params, batch, max_len):
            return T.transformer_prefill(params, cfg, batch["tokens"],
                                         max_len,
                                         image_embed=batch.get("image_embed"))

        def decode_step(params, token, cache, pos, batch=None):
            img = None if batch is None else batch.get("image_embed")
            return T.transformer_decode_step(params, cfg, token, cache, pos,
                                             image_embed=img)

        def init_cache(batch_size, max_len, device=None):
            return T.init_kv_cache(cfg, batch_size, max_len, device)

    return Model(cfg=cfg, init=init, prefill=prefill,
                 decode_step=decode_step, init_cache=init_cache)
