"""whisper-small — encoder-decoder audio backbone [arXiv:2212.04356;
unverified]. Conv frontend stubbed: input_specs feeds (B, 1500, 768) frame
embeddings per the assignment."""
from repro_torch.configs.base import ModelCfg

CONFIG = ModelCfg(
    name="whisper-small", family="audio",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=51865, head_dim=64,
    encoder_layers=12, num_audio_frames=1500,
    act="gelu", gated_mlp=False, tie_embeddings=True,
    source="arXiv:2212.04356; unverified",
)

SMOKE = CONFIG.scaled(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                      d_ff=128, vocab_size=256, head_dim=16,
                      encoder_layers=2, num_audio_frames=24)
