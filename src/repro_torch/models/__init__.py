from repro_torch.models.model import LM, PORTED_ARCHS, build_model

__all__ = ["LM", "PORTED_ARCHS", "build_model"]
