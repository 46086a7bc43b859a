"""xlstm-1.3b — sLSTM + mLSTM blocks, 7:1 ratio [arXiv:2405.04517; unverified].
48 layers = 6 super-blocks of (7 mLSTM + 1 sLSTM)."""
from repro_torch.configs.base import ModelCfg

CONFIG = ModelCfg(
    name="xlstm-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    tie_embeddings=True,
    source="arXiv:2405.04517; unverified",
)

SMOKE = CONFIG.scaled(num_layers=8, d_model=64, num_heads=4, num_kv_heads=4,
                      vocab_size=256, block_pattern=("mlstm",) * 3 + ("slstm",))
