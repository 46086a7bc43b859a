"""gemma3-27b — dense GQA, 5:1 local(1024):global attention, 128k context
[hf:google/gemma-3-*-pt; unverified]. Local layers use rope theta 10k,
global layers 1M (the pattern rides through the layer scan as data)."""
from repro_torch.configs.base import ModelCfg

CONFIG = ModelCfg(
    name="gemma3-27b", family="dense",
    num_layers=62, d_model=5376, num_heads=32, num_kv_heads=16,
    d_ff=21504, vocab_size=262144, head_dim=128,
    rope_theta=10_000.0, tie_embeddings=True,
    window_pattern=(1024, 1024, 1024, 1024, 1024, 0),
    rope_theta_pattern=(10_000.0,) * 5 + (1_000_000.0,),
    source="hf:google/gemma-3-1b-pt; unverified",
)

# 62 = 10 * 6 + 2: the pattern tiling handles the remainder layers.
SMOKE = CONFIG.scaled(num_layers=8, d_model=64, num_heads=4, num_kv_heads=2,
                      d_ff=128, vocab_size=256, head_dim=16,
                      window_pattern=(8, 8, 8, 8, 8, 0))
