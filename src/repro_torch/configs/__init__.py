"""Architecture registry (the reference's twelve archs and the port's
own ``moonlight-16b-a3b`` pair) and recipes."""
from repro_torch.configs import (bert_large, deepseek_7b,  # noqa: F401
                                 falcon_mamba_7b, granite_34b,
                                 internlm2_1_8b, internvl2_2b,
                                 jamba_1_5_large, llama3_2_3b, llama4_scout,
                                 mixtral_8x22b, moonlight_16b_a3b,
                                 musicgen_large)
from repro_torch.configs.base import (ArchConfig, InputShape, OptimSpec,
                                      get_config, get_optim_recipe,
                                      list_archs, list_optim_recipes,
                                      register)

__all__ = ["ArchConfig", "InputShape", "OptimSpec", "get_config",
           "get_optim_recipe", "list_archs", "list_optim_recipes",
           "register"]
