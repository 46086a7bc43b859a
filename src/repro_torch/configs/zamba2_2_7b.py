"""zamba2-2.7b — Mamba2 backbone + ONE shared full-attention block applied
after every 6 Mamba blocks (Zamba weight-sharing) [arXiv:2411.15242; hf].
ssm_state=64 per the assignment spec."""
from repro_torch.configs.base import ModelCfg, SSMCfg

CONFIG = ModelCfg(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000, head_dim=80,
    ssm=SSMCfg(d_state=64, d_conv=4, head_dim=64, expand=2, chunk=256),
    shared_attn_every=6, tie_embeddings=True,
    source="arXiv:2411.15242; hf",
)

SMOKE = CONFIG.scaled(num_layers=6, d_model=64, num_heads=4, num_kv_heads=4,
                      d_ff=128, vocab_size=256, head_dim=16,
                      ssm=SSMCfg(d_state=16, head_dim=16, chunk=16),
                      shared_attn_every=3)
