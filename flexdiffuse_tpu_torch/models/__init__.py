"""Model zoo of the port: CLIP text/vision, SD UNet, VAE as ``nn.Module``s."""
from flexdiffuse_tpu_torch.models.clip import CLIPTextModel, CLIPVisionModel
from flexdiffuse_tpu_torch.models.configs import (CLIP_VIT_L14_TEXT,
                                                  CLIP_VIT_L14_VISION,
                                                  OPENCLIP_H_TEXT,
                                                  SD14_UNET, SD14_VAE,
                                                  SD21_UNET, SD21_VAE,
                                                  TINY_TEXT, TINY_UNET,
                                                  TINY_VAE, TINY_VISION,
                                                  CLIPTextConfig,
                                                  CLIPVisionConfig,
                                                  UNetConfig, VAEConfig)
from flexdiffuse_tpu_torch.models.unet import UNet2DCondition
from flexdiffuse_tpu_torch.models.vae import AutoencoderKL, sample_latents

__all__ = [
    'CLIPTextModel', 'CLIPVisionModel', 'UNet2DCondition', 'AutoencoderKL',
    'sample_latents', 'CLIPTextConfig', 'CLIPVisionConfig', 'UNetConfig',
    'VAEConfig', 'TINY_TEXT', 'TINY_VISION', 'TINY_UNET', 'TINY_VAE',
    'SD14_UNET', 'SD14_VAE', 'CLIP_VIT_L14_TEXT', 'CLIP_VIT_L14_VISION',
    'SD21_UNET', 'SD21_VAE', 'OPENCLIP_H_TEXT'
]
