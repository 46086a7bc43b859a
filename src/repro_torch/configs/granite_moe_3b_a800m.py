"""granite-moe-3b-a800m — MoE, 40 experts top-8, d_expert=512
[hf:ibm-granite/granite-3.0; hf]."""
from repro_torch.configs.base import ModelCfg, MoECfg

CONFIG = ModelCfg(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
    d_ff=512, vocab_size=49155, head_dim=64,
    rope_theta=10_000.0, tie_embeddings=True,
    moe=MoECfg(num_experts=40, top_k=8, d_expert=512),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)

SMOKE = CONFIG.scaled(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                      d_ff=64, vocab_size=256, head_dim=16,
                      moe=MoECfg(num_experts=8, top_k=2, d_expert=64))
