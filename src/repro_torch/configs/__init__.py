"""Architecture registry (the BERT encoders of slice 1, the llama3.2-3b
decoder of slice 2) and recipes."""
from repro_torch.configs import bert_large, llama3_2_3b  # noqa: F401
from repro_torch.configs.base import (ArchConfig, InputShape, OptimSpec,
                                      get_config, get_optim_recipe,
                                      list_archs, list_optim_recipes)

__all__ = ["ArchConfig", "InputShape", "OptimSpec", "get_config",
           "get_optim_recipe", "list_archs", "list_optim_recipes"]
