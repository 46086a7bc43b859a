"""Architecture registry of the port (``repro.configs.registry``).

``input_specs`` and ``cache_specs`` give a cell's inputs and decode cache
as tensors on the ``meta`` device, the port's ``ShapeDtypeStruct``: shapes
and dtypes that hold no memory (the dry run and the partition specs read
them)."""
from __future__ import annotations

import importlib
from typing import Dict

import torch

from repro_torch.configs.base import (SHAPES, InputShape, ModelCfg,
                                      cell_is_supported)

_MODULES = {
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
    "command-r-35b": "repro_torch.configs.command_r_35b",
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "gemma3-27b": "repro_torch.configs.gemma3_27b",
    "llama-3.2-vision-11b": "repro_torch.configs.llama_3_2_vision_11b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    "whisper-small": "repro_torch.configs.whisper_small",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ModelCfg:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; one of {ARCH_NAMES}")
    return importlib.import_module(_MODULES[name]).CONFIG


def get_smoke_config(name: str) -> ModelCfg:
    return importlib.import_module(_MODULES[name]).SMOKE


def list_configs() -> Dict[str, ModelCfg]:
    return {n: get_config(n) for n in ARCH_NAMES}


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelCfg, shape: InputShape) -> dict:
    """Meta-tensor stand-ins for every model input of this cell.

    train/prefill: the full token batch (+ modality stubs).
    decode: one new token per sequence (the KV cache spec comes from
    ``cache_specs``)."""
    B, S = shape.global_batch, shape.seq_len
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": _sds((B, S), torch.int32)}
        if cfg.family == "audio":
            batch["frames"] = _sds((B, cfg.num_audio_frames, cfg.d_model),
                                   dt)
        if cfg.family == "vlm":
            batch["image_embed"] = _sds((B, cfg.num_image_tokens,
                                         cfg.d_model), dt)
        return batch
    # decode: one token per sequence
    return {"token": _sds((B,), torch.int32)}


def cache_specs(cfg: ModelCfg, shape: InputShape) -> dict:
    """Shape/dtype of the decode cache at context length = shape.seq_len
    (the model's ``init_cache`` on the meta device)."""
    from repro_torch.models.model import build_model
    return build_model(cfg).init_cache(shape.global_batch, shape.seq_len,
                                       device="meta")


def all_cells():
    """Yield (arch_name, shape, supported, reason) for all 40 cells."""
    for name in ARCH_NAMES:
        cfg = get_config(name)
        for shape in SHAPES.values():
            ok, reason = cell_is_supported(cfg, shape)
            yield name, shape, ok, reason
