from repro_torch.configs.base import (
    ARCH_IDS,
    INPUT_SHAPES,
    InputShape,
    MAvgConfig,
    ModelConfig,
    TrainConfig,
    all_configs,
    get_config,
)
