"""llama-3.2-vision-11b — GQA decoder with gated cross-attention image layers
every 5th layer [hf:meta-llama/Llama-3.2-11B-Vision; unverified]. The vision
tower is a STUB per the assignment: input_specs feeds precomputed patch
embeddings (B, num_image_tokens, d_model)."""
from repro_torch.configs.base import ModelCfg

CONFIG = ModelCfg(
    name="llama-3.2-vision-11b", family="vlm",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256, head_dim=128,
    rope_theta=500_000.0, cross_attn_every=5, num_image_tokens=1600,
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)

SMOKE = CONFIG.scaled(num_layers=10, d_model=64, num_heads=4, num_kv_heads=2,
                      d_ff=128, vocab_size=256, head_dim=16,
                      cross_attn_every=5, num_image_tokens=16)
