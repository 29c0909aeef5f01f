from repro_torch.configs.base import PORTED, ModelConfig, get_config

__all__ = ["PORTED", "ModelConfig", "get_config"]
