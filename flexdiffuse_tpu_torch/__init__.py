"""flexdiffuse_tpu_torch — the PyTorch/CUDA port of ``flexdiffuse_tpu``.

Module paths and public names mirror the JAX package, so each counterpart
is found under the same name. The port imports ``torch`` and never ``jax``,
and nothing from ``flexdiffuse_tpu`` at run time. Its hand-written Hopper
kernels (``csrc/*.cu``: flash attention forward and backward, fused
GroupNorm) are built with ``nvcc`` at first use on a CUDA tensor.
"""
from flexdiffuse_tpu_torch.config import (GUIDE_ORDER_ALIGN,
                                          GUIDE_ORDER_DIRECT,
                                          GUIDE_ORDER_TEXT, GuidanceParams,
                                          RunConfig)
from flexdiffuse_tpu_torch.encode import CLIPEncoder
from flexdiffuse_tpu_torch.guidance import Guide
from flexdiffuse_tpu_torch.pipeline import FlexPipeline, SimpleGuidance
from flexdiffuse_tpu_torch.runner import Runner
from flexdiffuse_tpu_torch.utils.image import image_grid, preprocess

__version__ = '0.1.0'

__all__ = [
    'CLIPEncoder', 'GUIDE_ORDER_TEXT', 'GUIDE_ORDER_ALIGN',
    'GUIDE_ORDER_DIRECT', 'Guide', 'preprocess', 'FlexPipeline',
    'image_grid', 'Runner', 'SimpleGuidance', 'GuidanceParams', 'RunConfig'
]
