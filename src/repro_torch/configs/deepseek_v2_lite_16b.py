"""deepseek-v2-lite-16b — MLA (kv_lora=512) + MoE 64 routed top-6 + 2 shared
experts [arXiv:2405.04434; hf]. Decode uses the absorbed MLA formulation with
the compressed (512+64)-per-token cache."""
from repro_torch.configs.base import MLACfg, ModelCfg, MoECfg

CONFIG = ModelCfg(
    name="deepseek-v2-lite-16b", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=102400,
    rope_theta=10_000.0,
    moe=MoECfg(num_experts=64, top_k=6, num_shared=2, d_expert=1408),
    mla=MLACfg(kv_lora_rank=512, q_lora_rank=0, rope_head_dim=64,
               nope_head_dim=128, v_head_dim=128),
    source="arXiv:2405.04434; hf",
)

SMOKE = CONFIG.scaled(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                      d_ff=96, vocab_size=256,
                      moe=MoECfg(num_experts=8, top_k=2, num_shared=1, d_expert=96),
                      mla=MLACfg(kv_lora_rank=32, rope_head_dim=8,
                                 nope_head_dim=16, v_head_dim=16))
