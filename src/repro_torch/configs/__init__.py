"""Architecture registry (the BERT encoders of slice 1, the llama3.2-3b
decoder of slice 2, the internlm2-1.8b decoder of the benchmarks) and
recipes."""
from repro_torch.configs import (bert_large, internlm2_1_8b,  # noqa: F401
                                 llama3_2_3b)
from repro_torch.configs.base import (ArchConfig, InputShape, OptimSpec,
                                      get_config, get_optim_recipe,
                                      list_archs, list_optim_recipes)

__all__ = ["ArchConfig", "InputShape", "OptimSpec", "get_config",
           "get_optim_recipe", "list_archs", "list_optim_recipes"]
