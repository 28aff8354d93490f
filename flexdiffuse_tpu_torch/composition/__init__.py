"""Composition — regional multi-prompt generation (schema → masked
blending); port of ``flexdiffuse_tpu/composition``."""
from flexdiffuse_tpu_torch.composition.embeds import encode_schema, px_to_block
from flexdiffuse_tpu_torch.composition.schema import EntitySchema, Schema

__all__ = ['EntitySchema', 'Schema', 'encode_schema', 'px_to_block']
