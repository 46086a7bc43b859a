"""Unified Model interface: init / prefill / decode for every family.

The port of ``repro.models.model``. ``build_model(cfg)`` returns a
:class:`Model` whose members are plain functions over the weights module
that ``init`` builds. Batches are dicts:

  {"tokens": (B, S) ints}                               dense, moe, ssm, hybrid
  {"tokens", "image_embed": (B, N_img, d_model)}        vlm (patch stub)
  {"tokens", "frames": (B, S_enc, d_model)}             audio (conv stub)

Every family runs: dense and moe (MoE and MLA layers) decoders, vlm,
audio (enc-dec), ssm (xLSTM) and hybrid (Zamba2: Mamba2 blocks with a
shared attention block). ``loss`` (with ``fused_xent`` and ``_xent``)
comes with training, ROADMAP item 14e.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Union

import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.convert import resolve_device
from repro_torch.models import encdec as ED
from repro_torch.models import recurrent as R
from repro_torch.models import transformer as T

FAMILIES = ("dense", "moe", "vlm", "audio", "ssm", "hybrid")


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


def cache_leaves(cache: dict) -> list:
    """[(name, tensor)] of a family's cache: its tensors by key, and each
    field of its recurrent states (``mlstm.C``, ``slstm.m``, ``mamba.h``)."""
    out = []
    for k, v in cache.items():
        if isinstance(v, tuple):
            out += [(f"{k}.{f}", t) for f, t in zip(v._fields, v)]
        else:
            out.append((k, v))
    return out


def check_family(cfg: ModelCfg) -> None:
    """Raise ``ValueError`` for a family the port does not know."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")


def weights_init(cfg: ModelCfg, gen, device=None):
    """The family's weights module from ``gen`` on ``device`` (the rule of
    ``transformer.transformer_init``; the meta device draws nothing)."""
    check_family(cfg)
    init = {"audio": ED.encdec_init, "ssm": R.xlstm_init,
            "hybrid": R.hybrid_init}.get(cfg.family, T.transformer_init)
    return init(gen, cfg, device)


def build_model(cfg: ModelCfg) -> Model:
    check_family(cfg)

    def init(seed: Union[int, torch.Generator] = 0, device=None):
        """The weights on ``device`` from a seed or a ``torch.Generator``
        (on that device): CUDA unless ``device`` (or the generator's
        device) says otherwise."""
        if device is None and isinstance(seed, torch.Generator):
            device = seed.device
        device = resolve_device(device)
        return weights_init(cfg, _generator(seed, device), device)

    if cfg.family == "ssm":        # xLSTM
        def prefill(params, batch, max_len):
            return R.xlstm_prefill(params, cfg, batch["tokens"], max_len)

        def decode_step(params, token, cache, pos, batch=None):
            return R.xlstm_decode_step(params, cfg, token, cache, pos)

        def init_cache(batch_size, max_len, device=None):
            return R.xlstm_init_cache(cfg, batch_size, device)
    elif cfg.family == "hybrid":   # zamba2
        def prefill(params, batch, max_len):
            return R.hybrid_prefill(params, cfg, batch["tokens"], max_len)

        def decode_step(params, token, cache, pos, batch=None):
            return R.hybrid_decode_step(params, cfg, token, cache, pos)

        def init_cache(batch_size, max_len, device=None):
            return R.hybrid_init_cache(cfg, batch_size, max_len, device)
    elif cfg.family == "audio":
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
