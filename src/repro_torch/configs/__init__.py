from repro_torch.configs.base import (InputShape, LONG_CONTEXT_OK, MLACfg,
                                      ModelCfg, MoECfg, SHAPES, SSMCfg,
                                      cell_is_supported)
from repro_torch.configs.registry import (ARCH_NAMES, all_cells,
                                          cache_specs, get_config,
                                          get_smoke_config, input_specs,
                                          list_configs)
