"""Config schema for every supported architecture + the input-shape suite.

The port's own copy of ``repro.configs.base`` (which imports no JAX): the
port imports nothing of the JAX package, so the dataclasses live here too,
field for field, and ``tests/test_torch_lm_models.py`` holds every registered
config equal to the JAX one.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    num_shared: int = 0          # always-on shared experts (DeepSeek style)
    d_expert: int = 0            # expert FFN hidden size (0 -> d_ff)
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MLACfg:
    kv_lora_rank: int = 512      # compressed KV dim (cached at decode)
    q_lora_rank: int = 0         # 0 -> no query compression (v2-lite)
    rope_head_dim: int = 64      # decoupled RoPE dims appended to the cache
    nope_head_dim: int = 128     # per-head non-rope dims
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMCfg:
    d_state: int = 64
    d_conv: int = 4
    head_dim: int = 64
    expand: int = 2
    chunk: int = 256             # SSD chunk length (training parallel form)


@dataclass(frozen=True)
class ModelCfg:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    act: str = "silu"            # silu (gated) | gelu (non-gated enc-dec)
    gated_mlp: bool = True
    tie_embeddings: bool = False
    # sliding-window pattern: per-layer window sizes, tiled over layers.
    # 0 = global attention. e.g. gemma3: (1024,)*5 + (0,)  (5 local : 1 global)
    window_pattern: Tuple[int, ...] = ()
    # per-layer rope theta override matching window_pattern tiling (gemma3 uses
    # 1M for global layers); 0 entries fall back to rope_theta.
    rope_theta_pattern: Tuple[float, ...] = ()
    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    ssm: Optional[SSMCfg] = None
    # ssm/hybrid/xlstm block pattern, tiled: entries in {"attn","mamba2","mlstm","slstm"}
    block_pattern: Tuple[str, ...] = ()
    # hybrid (zamba2): a single *shared* attention block applied after every
    # `shared_attn_every` ssm blocks (0 = none)
    shared_attn_every: int = 0
    # vlm: insert a cross-attention layer every k self-attn layers (0 = none)
    cross_attn_every: int = 0
    num_image_tokens: int = 1600
    # audio/enc-dec: encoder depth (decoder depth = num_layers)
    encoder_layers: int = 0
    num_audio_frames: int = 1500
    dtype: str = "bfloat16"
    # notes for DESIGN/roofline bookkeeping
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def layer_windows(self, n: Optional[int] = None) -> Tuple[int, ...]:
        n = n or self.num_layers
        if not self.window_pattern:
            return (0,) * n
        p = self.window_pattern
        return tuple(p[i % len(p)] for i in range(n))

    def layer_thetas(self, n: Optional[int] = None) -> Tuple[float, ...]:
        n = n or self.num_layers
        if not self.rope_theta_pattern:
            return (self.rope_theta,) * n
        p = self.rope_theta_pattern
        return tuple((p[i % len(p)] or self.rope_theta) for i in range(n))

    def scaled(self, **kw) -> "ModelCfg":
        """Reduced copy for smoke tests."""
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

# archs that may run the 500k-decode cell (sub-quadratic / windowed / recurrent)
LONG_CONTEXT_OK = {"xlstm-1.3b", "zamba2-2.7b", "gemma3-27b"}


def cell_is_supported(cfg: ModelCfg, shape: InputShape) -> tuple[bool, str]:
    """Whether (arch, shape) is a runnable cell; reason if not."""
    if shape.name == "long_500k" and cfg.name not in LONG_CONTEXT_OK:
        return False, "pure full-attention arch: 500k context skipped per spec"
    return True, ""
