from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    BlockSpec,
    ModelConfig,
    cell_status,
    get_config,
    list_archs,
    register,
)
