"""Pipeline — the denoising loop and its guidance strategies."""
from flexdiffuse_tpu_torch.pipeline.flex import (FlexPipeline,
                                                 FlexPipelineOutput,
                                                 prepare_latent_mask)
from flexdiffuse_tpu_torch.pipeline.guides import (CompositeGuidance,
                                                   SimpleGuidance,
                                                   entity_masks)

__all__ = ['FlexPipeline', 'FlexPipelineOutput', 'prepare_latent_mask',
           'CompositeGuidance', 'SimpleGuidance', 'entity_masks']
