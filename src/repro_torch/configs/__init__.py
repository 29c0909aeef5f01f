from repro_torch.configs.base import PORTED, ModelConfig, get_config, resolve_for_tp

__all__ = ["PORTED", "ModelConfig", "get_config", "resolve_for_tp"]
