"""internlm2-1.8b — dense GQA decoder [arXiv:2403.17297; hf]."""
from repro_torch.configs.base import ModelCfg

CONFIG = ModelCfg(
    name="internlm2-1.8b", family="dense",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
    d_ff=8192, vocab_size=92544, head_dim=128,
    rope_theta=1_000_000.0, tie_embeddings=False,
    source="arXiv:2403.17297; hf",
)

SMOKE = CONFIG.scaled(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                      d_ff=128, vocab_size=256, head_dim=16)
