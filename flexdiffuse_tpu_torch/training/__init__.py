"""Training (port of ``flexdiffuse_tpu/training``): diffusion loss, full,
LoRA and DreamBooth fine-tuning, EMA and checkpoint/resume. Quick use::

    from flexdiffuse_tpu_torch import training

    cfg = training.TrainConfig(learning_rate=1e-4)
    step, opt = training.make_train_step(unet, cfg)          # full model
    loss = step(latents, context, generator=gen)             # in place

    factors = training.init_lora(unet, rank=8)               # LoRA only
    lstep, lopt = training.make_lora_train_step(unet, factors, cfg)
    ...
    training.export_lora_safetensors(factors, 'my_lora.safetensors')

Not ported yet: textual-inversion training, SDXL training
(``encode_dataset_sdxl``) and the data/tensor-parallel mesh (ROADMAP Queue 1
steps 11-13).
"""
from flexdiffuse_tpu_torch.training.checkpoint import TrainCheckpointer
from flexdiffuse_tpu_torch.training.data import (EncodedDataset,
                                                 encode_dataset,
                                                 encode_images, find_items,
                                                 load_pixels)
from flexdiffuse_tpu_torch.training.dreambooth import (generate_class_images,
                                                       train_dreambooth)
from flexdiffuse_tpu_torch.training.loop import train_full, train_lora
from flexdiffuse_tpu_torch.training.train import (TrainConfig, diffusion_loss,
                                                  ema_update,
                                                  export_lora_safetensors,
                                                  init_lora,
                                                  make_lora_train_step,
                                                  make_optimizer,
                                                  make_train_step,
                                                  merge_lora_params)

__all__ = [
    'TrainConfig', 'diffusion_loss', 'make_optimizer', 'make_train_step',
    'init_lora', 'merge_lora_params', 'make_lora_train_step',
    'export_lora_safetensors', 'ema_update',
    'EncodedDataset', 'find_items', 'load_pixels', 'encode_dataset',
    'train_lora', 'train_full', 'encode_images',
    'train_dreambooth', 'generate_class_images',
    'TrainCheckpointer',
]
