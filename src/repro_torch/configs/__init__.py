"""Architecture registry (slice 1: the BERT encoders) and recipes."""
from repro_torch.configs import bert_large  # noqa: F401  (registers)
from repro_torch.configs.base import (ArchConfig, InputShape, OptimSpec,
                                      get_config, get_optim_recipe,
                                      list_archs, list_optim_recipes)

__all__ = ["ArchConfig", "InputShape", "OptimSpec", "get_config",
           "get_optim_recipe", "list_archs", "list_optim_recipes"]
