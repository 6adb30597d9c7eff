from repro_torch.configs.base import (CarlsConfig, InputShape, INPUT_SHAPES,
                                      ModelConfig)
from repro_torch.configs.registry import (ARCH_IDS, all_configs, get_config,
                                          get_shape)

__all__ = ["CarlsConfig", "InputShape", "INPUT_SHAPES", "ModelConfig",
           "ARCH_IDS", "all_configs", "get_config", "get_shape"]
