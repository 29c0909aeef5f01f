from repro_torch.configs.base import (
    ASSIGNED,
    PAPER_OWN,
    PORTED,
    SHAPES,
    ModelConfig,
    ShapeCell,
    all_arch_names,
    cell_applicable,
    get_config,
    resolve_for_tp,
)

__all__ = ["ASSIGNED", "PAPER_OWN", "PORTED", "SHAPES", "ModelConfig", "ShapeCell",
           "all_arch_names", "cell_applicable", "get_config", "resolve_for_tp"]
