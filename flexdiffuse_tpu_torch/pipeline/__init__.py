"""Pipeline — the denoising loop and its guidance strategies."""
from flexdiffuse_tpu_torch.pipeline.flex import (FlexPipeline,
                                                 FlexPipelineOutput,
                                                 prepare_latent_mask,
                                                 upscale_latents)
from flexdiffuse_tpu_torch.pipeline.guides import (CompositeGuidance,
                                                   SimpleGuidance,
                                                   entity_masks,
                                                   rescale_cfg)

__all__ = ['FlexPipeline', 'FlexPipelineOutput', 'prepare_latent_mask',
           'upscale_latents', 'CompositeGuidance', 'SimpleGuidance',
           'entity_masks', 'rescale_cfg']
