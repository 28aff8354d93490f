"""Runner — guided generation and regional composition end to end (port of
``flexdiffuse_tpu/runner.py``: ``Runner.from_models``, ``Runner.gen`` and
``Runner.compose``).

``gen`` takes the reference's Sandbox parameters: the prompt, an optional
guide image or text with the ``guide_*`` tween parameters and mapping
concepts, an optional init image (img2img) with its strength and an
inpainting ``mask``, steps, CFG scale, samples, seed, ``debug`` (every
step's image), negative prompt and saving. The JAX Runner's other keywords
raise ``NotImplementedError`` naming the ROADMAP step that ports them.
``compose`` is the reference's second UI tab: a background prompt and
rectangular entities, each with its prompt and blend.

Seeds are clamped as in the JAX Runner and seed a ``torch.Generator`` on the
UNet's device; it draws every batch's noise in turn. A torch generator and a
JAX key give different numbers, so seeded outputs of the two packages
differ (the tests hand both the same noise instead).
"""
from __future__ import annotations

import logging
import os
import time
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from PIL import Image

from flexdiffuse_tpu_torch.composition import (EntitySchema, Schema,
                                               encode_schema)
from flexdiffuse_tpu_torch.config import (MAX_SEED, GuidanceParams,
                                          RunConfig, clamp_seed)
from flexdiffuse_tpu_torch.encode import CLIPEncoder
from flexdiffuse_tpu_torch.guidance import Guide
from flexdiffuse_tpu_torch.pipeline import FlexPipeline, SimpleGuidance
from flexdiffuse_tpu_torch.schedulers import SchedulerConfig
from flexdiffuse_tpu_torch.utils.image import image_grid

log = logging.getLogger(__name__)

# JAX Runner.gen keywords the port does not take yet → the ROADMAP Queue 1
# step that ports them.
_NOT_PORTED = {
    'long_prompt': 2, 'weighted': 2,
    'hires_scale': 9, 'hires_strength': 9, 'hires_steps': 9,
    'cfg_interval': 9, 'guidance_rescale': 9, 'pag_scale': 9,
    'control_image': 10, 'controlnet_scale': 10,
    'ip_embed': 10, 'ip_image': 10, 'ip_scale': 10,
}


def _i100(f: float) -> int:
    return int(f * 100)


class Runner:
    """End-to-end generation runner. Loading from HF snapshots waits for
    the checkpoints; construct with :meth:`from_models`."""

    def __init__(self, *args, **kwargs) -> None:
        raise NotImplementedError(
            'loading SD-1.4/CLIP snapshots into the port is not ported yet '
            '(ROADMAP Queue 1 step 8, weights/load.py); use '
            'Runner.from_models(...)')

    @classmethod
    def from_models(cls, text_model, vision_model, unet, vae, tokenizer,
                    scheduler: str = 'pndm',
                    config: RunConfig = RunConfig(),
                    scheduler_config: Optional[SchedulerConfig] = None
                    ) -> 'Runner':
        """Build from modules that already hold their weights (on the
        device, in the dtype they should run in). ``scheduler``: 'pndm',
        'ddim' or 'lms'; ``scheduler_config`` sets DDIM's and PNDM's
        switches (the PRK warm-up is ``skip_prk_steps=False``)."""
        self = cls.__new__(cls)
        self.config = config
        self.encoder = CLIPEncoder(text_model, vision_model, tokenizer)
        self.guide = Guide(self.encoder)
        self.pipe = FlexPipeline(unet, vae, scheduler=scheduler,
                                 scheduler_config=scheduler_config)
        self.eta = 0.0  # DDIM η, read by every generation
        self.output_dir = config.output_dir
        self.grid_dir = os.path.join(self.output_dir, 'grids')
        self._generator = torch.Generator(self.pipe.device)
        return self

    def _set_seed(self, seed: Optional[int]) -> int:
        seed = clamp_seed(seed)
        if seed is None:
            seed = int(np.random.default_rng().integers(0, MAX_SEED))
        self._generator.manual_seed(seed)
        return seed

    def _run(self, batches: int, guidance, init_image, init_size,
             strength: float, steps: int, debug: bool, fp: str, save: bool,
             mask=None) -> Tuple[List[Image.Image], Image.Image]:
        """Multi-batch sweep (reference ``_run`` utils.py:85-112); in debug
        mode each batch gives one image per recorded step."""
        all_images: List[Image.Image] = []
        if save:
            os.makedirs(self.grid_dir, exist_ok=True)
        for b in range(batches):
            stime = time.time()
            ms_time = int(stime * 1000)
            images = self.pipe(guidance, steps=steps, init_image=init_image,
                               init_size=init_size, strength=strength,
                               eta=self.eta, generator=self._generator,
                               debug=debug, mask=mask).images
            log.info('batch %d/%d: %d image(s) in %.2fs', b + 1, batches,
                     len(images), time.time() - stime)
            if save:
                for i, img in enumerate(images):
                    img.save(f'{self.output_dir}/{ms_time:>013d}_{i:>02d}_'
                             f'{fp}.png', format='png')
            all_images.extend(images)
        grid = image_grid(all_images)
        if save:
            ms_time = int(time.time() * 1000)
            grid.save(f'{self.grid_dir}/{ms_time:>013d}_{fp}.png',
                      format='png')
        return all_images, grid

    def gen(self,
            prompt: Union[str, List[str]] = '',
            init_image: Optional[Image.Image] = None,
            guide: Union[Image.Image, str, None] = None,
            init_size: Tuple[int, int] = (512, 512),
            mapping_concepts: str = '',
            guide_threshold_mult: float = 0.5,
            guide_threshold_floor: float = 0.5,
            guide_clustered: float = 0.5,
            guide_linear: Tuple[float, float] = (0.0, 0.5),
            guide_max_guidance: float = 0.5,
            guide_header_max: float = 0.15,
            guide_mode: int = 0,
            guide_reuse: bool = True,
            strength: float = 0.6,
            steps: int = 10,
            guidance_scale: float = 8,
            samples: int = 1,
            seed: Optional[int] = None,
            debug: bool = False,
            save: bool = True,
            negative_prompt: str = '',
            mask: Optional[Image.Image] = None,
            **not_ported) -> Tuple[List[Image.Image], Image.Image]:
        """Guided generation (reference ``Runner.gen`` utils.py:114-166);
        returns ``(images, grid)``. ``mask`` (with ``init_image``): 1 =
        regenerate, 0 = keep."""
        for name in not_ported:
            if name not in _NOT_PORTED:
                raise TypeError(f'gen() got an unexpected keyword argument '
                                f'{name!r}')
            raise NotImplementedError(
                f'gen({name}=...) is not ported yet (ROADMAP Queue 1 step '
                f'{_NOT_PORTED[name]})')
        if mask is not None and init_image is not None:
            fp = f'inp_ds{int(strength * 100)}'
        elif init_image is not None:
            fp = f'i2i_ds{int(strength * 100)}'
        else:
            fp = 't2i'
        if guide is not None and not (isinstance(guide, str) and not guide):
            fp += (f'_itm{_i100(guide_threshold_mult)}'
                   f'_itf{_i100(guide_threshold_floor)}'
                   f'_ic{_i100(guide_clustered)}'
                   f'_il{_i100(guide_linear[0])}'
                   f'-{_i100(guide_linear[1])}'
                   f'_mg{_i100(guide_max_guidance)}'
                   f'_hm{_i100(guide_header_max)}'
                   f'_im{guide_mode:d}')
        fp += f'_st{steps}_gs{int(guidance_scale)}'
        if seed:
            fp += f'_se{seed}'

        self._set_seed(seed)
        params = GuidanceParams(threshold_mult=guide_threshold_mult,
                                threshold_floor=guide_threshold_floor,
                                clustered=guide_clustered,
                                linear=tuple(guide_linear),
                                max_guidance=guide_max_guidance,
                                header_max=guide_header_max, mode=guide_mode,
                                reuse=guide_reuse)
        embeds = self.guide.embeds(prompt=prompt, guide=guide,
                                   mapping_concepts=mapping_concepts,
                                   params=params)
        uncond = self.encoder.prompt(negative_prompt or '')
        guidance = SimpleGuidance(embeddings=embeds, uncond=uncond,
                                  guidance_scale=float(guidance_scale),
                                  cfg=guidance_scale > 1.0)
        return self._run(samples, guidance, init_image, init_size, strength,
                         steps, debug, fp, save, mask=mask)

    def compose(self,
                bg_prompt: str = '',
                entities_df: Sequence[Sequence[Any]] = (),
                start_style: str = '',
                end_style: str = '',
                style_blend: Tuple[float, float] = (0.0, 1.0),
                init_image: Optional[Image.Image] = None,
                batches: int = 4,
                strength: float = 0.7,
                steps: int = 30,
                guidance_scale: float = 8.0,
                init_size: Tuple[int, int] = (512, 512),
                seed: Optional[int] = None,
                debug: bool = False,
                style_strength: float = 0.0,
                save: bool = True) -> Tuple[List[Image.Image], Image.Image]:
        """Regional composition (reference ``Runner.compose`` utils.py:
        168-207). ``entities_df`` rows are ``(prompt, left, top, width,
        height, blend)`` in pixels (a pandas DataFrame works too); rows that
        do not parse, or have an empty prompt, are skipped. Returns
        ``(images, grid)``."""
        fp = f'ci2i_ds{int(strength * 100)}' if init_image is not None \
            else 'ct2i'
        fp += f'_st{steps}_gs{int(guidance_scale)}'
        if seed:
            fp += f'_se{seed}'
        self._set_seed(seed)

        def _row_to_ent(row: Sequence[Any]) -> Optional[EntitySchema]:
            try:
                return EntitySchema(
                    str(row[0]).strip(), (int(row[1]), int(row[2])),
                    (int(row[3]), int(row[4])), float(row[5]))
            except (IndexError, TypeError, ValueError) as ex:
                log.warning('Failed to build EntitySchema: %s', ex)
                return None

        if hasattr(entities_df, '_values'):
            entities_df = entities_df._values  # pandas DataFrame support
        rows = [_row_to_ent(r) for r in entities_df]
        schema = Schema(bg_prompt, start_style, end_style, tuple(style_blend),
                        [r for r in rows if r and r.prompt])
        f = self.pipe.vae_scale
        guidance = encode_schema(schema, self.encoder,
                                 (init_size[0] // f, init_size[1] // f),
                                 guidance_scale, cfg=guidance_scale > 1.0,
                                 style_strength=style_strength, scale=f)
        return self._run(batches, guidance, init_image, init_size, strength,
                         steps, debug, fp, save)
