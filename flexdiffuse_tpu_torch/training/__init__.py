"""Training (port of ``flexdiffuse_tpu/training``): diffusion loss, full,
LoRA, DreamBooth and textual-inversion fine-tuning, SDXL datasets
(``encode_dataset_sdxl``, whose batches carry ``added_cond`` through the
same steps), EMA and checkpoint/resume. Quick use::

    from flexdiffuse_tpu_torch import training

    cfg = training.TrainConfig(learning_rate=1e-4)
    step, opt = training.make_train_step(unet, cfg)          # full model
    loss = step(latents, context, generator=gen)             # in place

    factors = training.init_lora(unet, rank=8)               # LoRA only
    lstep, lopt = training.make_lora_train_step(unet, factors, cfg)
    ...
    training.export_lora_safetensors(factors, 'my_lora.safetensors')

    rows, losses = training.train_textual_inversion(        # new tokens
        text_model, tokenizer, unet, vae, paths, '<concept>',
        num_vectors=2, save_path='concept.safetensors')

With ``mesh=`` (``parallel.make_mesh``, in every rank of a process group
that ``parallel.launch`` started) the steps and loops train data-parallel:
each rank takes its rows of every batch and the gradients are averaged
over the data axis (``training/train.py``); rank 0 writes checkpoints and
outputs, every rank restores them.
"""
from flexdiffuse_tpu_torch.training.checkpoint import TrainCheckpointer
from flexdiffuse_tpu_torch.training.data import (EncodedDataset,
                                                 encode_dataset,
                                                 encode_dataset_sdxl,
                                                 encode_images, find_items,
                                                 load_pixels)
from flexdiffuse_tpu_torch.training.dreambooth import (generate_class_images,
                                                       train_dreambooth)
from flexdiffuse_tpu_torch.training.loop import train_full, train_lora
from flexdiffuse_tpu_torch.training.textual_inversion import (
    OBJECT_TEMPLATES, STYLE_TEMPLATES, make_ti_train_step,
    train_textual_inversion)
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
    'train_lora', 'train_full', 'encode_images', 'encode_dataset_sdxl',
    'make_ti_train_step', 'train_textual_inversion',
    'OBJECT_TEMPLATES', 'STYLE_TEMPLATES',
    'train_dreambooth', 'generate_class_images',
    'TrainCheckpointer',
]
