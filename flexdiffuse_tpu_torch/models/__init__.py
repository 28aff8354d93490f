"""Model zoo of the port: CLIP text/vision, SD UNet, VAE as ``nn.Module``s,
and the SDXL assembly (``models/sdxl.py``)."""
from flexdiffuse_tpu_torch.models.clip import CLIPTextModel, CLIPVisionModel
from flexdiffuse_tpu_torch.models.configs import (CLIP_VIT_L14_TEXT,
                                                  CLIP_VIT_L14_VISION,
                                                  OPENCLIP_BIGG_TEXT,
                                                  OPENCLIP_H_TEXT,
                                                  SD14_UNET, SD14_VAE,
                                                  SD21_UNET, SD21_VAE,
                                                  SDXL_REFINER_UNET,
                                                  SDXL_UNET, SDXL_VAE,
                                                  TINY_BIGG_TEXT,
                                                  TINY_REFINER_UNET,
                                                  TINY_SDXL_UNET,
                                                  TINY_TEXT, TINY_UNET,
                                                  TINY_VAE, TINY_VISION,
                                                  CLIPTextConfig,
                                                  CLIPVisionConfig,
                                                  UNetConfig, VAEConfig)
from flexdiffuse_tpu_torch.models.sdxl import (SDXL_LATENT_SCALE,
                                               SDXLTextEncoder, load_sdxl,
                                               load_sdxl_refiner,
                                               sdxl_guidance,
                                               sdxl_refiner_guidance)
from flexdiffuse_tpu_torch.models.unet import UNet2DCondition
from flexdiffuse_tpu_torch.models.vae import AutoencoderKL, sample_latents

__all__ = [
    'CLIPTextModel', 'CLIPVisionModel', 'UNet2DCondition', 'AutoencoderKL',
    'sample_latents', 'CLIPTextConfig', 'CLIPVisionConfig', 'UNetConfig',
    'VAEConfig', 'TINY_TEXT', 'TINY_VISION', 'TINY_UNET', 'TINY_VAE',
    'SD14_UNET', 'SD14_VAE', 'CLIP_VIT_L14_TEXT', 'CLIP_VIT_L14_VISION',
    'SD21_UNET', 'SD21_VAE', 'OPENCLIP_H_TEXT', 'SDXL_UNET', 'SDXL_VAE',
    'SDXL_REFINER_UNET', 'OPENCLIP_BIGG_TEXT', 'TINY_SDXL_UNET',
    'TINY_REFINER_UNET', 'TINY_BIGG_TEXT', 'SDXL_LATENT_SCALE',
    'SDXLTextEncoder', 'load_sdxl', 'load_sdxl_refiner', 'sdxl_guidance',
    'sdxl_refiner_guidance'
]
