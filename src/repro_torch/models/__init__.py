"""The LM scaffold's models: the dense, MoE / MLA, VLM, enc-dec, xLSTM and
Mamba2-hybrid families (``models/model.py``), served and trained."""
from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]
