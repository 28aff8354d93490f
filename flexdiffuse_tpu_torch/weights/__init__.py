"""Weights of the port: the JAX param tree -> state_dict bridge and the
JAX LoRA factor renaming."""
from flexdiffuse_tpu_torch.weights.bridge import (lora_factors_to_torch,
                                                  params_to_state_dict)

__all__ = ['params_to_state_dict', 'lora_factors_to_torch']
