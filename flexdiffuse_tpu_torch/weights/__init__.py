"""Weights of the port: loading HF snapshots (``load``), the safetensors
and flax msgpack formats without their packages (``safetensors``,
``msgpack``), checkpoint normalisation and the JAX tree rules
(``convert``, and their inverse ``bridge``), LoRA merging (``lora``) and
textual inversion (``textual_inversion``)."""
from flexdiffuse_tpu_torch.weights.bridge import (lora_factors_to_torch,
                                                  params_to_state_dict)

__all__ = ['params_to_state_dict', 'lora_factors_to_torch']
