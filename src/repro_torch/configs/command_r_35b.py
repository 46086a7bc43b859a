"""command-r-35b — dense GQA, no biases [hf:CohereForAI/c4ai-command-r-v01]."""
from repro_torch.configs.base import ModelCfg

CONFIG = ModelCfg(
    name="command-r-35b", family="dense",
    num_layers=40, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22528, vocab_size=256000, head_dim=128,
    rope_theta=8_000_000.0, qkv_bias=False, tie_embeddings=True,
    source="hf:CohereForAI/c4ai-command-r-v01; unverified",
)

SMOKE = CONFIG.scaled(num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
                      d_ff=160, vocab_size=256, head_dim=8)
