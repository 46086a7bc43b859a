"""The LM scaffold's models: the dense, MoE / MLA, VLM and enc-dec
families (see ``models/model.py`` for the families still to come)."""
from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]
