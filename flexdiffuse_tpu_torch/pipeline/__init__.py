"""Pipeline — the denoising loop and its guidance strategies."""
from flexdiffuse_tpu_torch.pipeline.flex import (FlexPipeline,
                                                 FlexPipelineOutput,
                                                 prepare_latent_mask,
                                                 upscale_latents)
from flexdiffuse_tpu_torch.pipeline.guides import (CompositeGuidance,
                                                   InstructPix2PixGuidance,
                                                   SimpleGuidance,
                                                   entity_masks,
                                                   prompt_guidance,
                                                   rescale_cfg)

__all__ = ['FlexPipeline', 'FlexPipelineOutput', 'prepare_latent_mask',
           'upscale_latents', 'CompositeGuidance', 'InstructPix2PixGuidance',
           'SimpleGuidance', 'entity_masks', 'prompt_guidance',
           'rescale_cfg']
