"""Composition schemas (reference composition/schema.py:1-26); the port's
own copy of ``flexdiffuse_tpu/composition/schema.py``."""
from __future__ import annotations

import dataclasses
import json
from typing import List, Tuple


@dataclasses.dataclass
class EntitySchema:
    """One composed entity: prompt + pixel-space rect + blend strength."""
    prompt: str
    offset: Tuple[int, int]  # (left, top) px
    size: Tuple[int, int]    # (width, height) px
    blend: float = 0.8


@dataclasses.dataclass
class Schema:
    """A full composition: background, style interpolation, entities."""
    background_prompt: str
    style_start_prompt: str
    style_end_prompt: str
    style_blend: Tuple[float, float]
    entities: List[EntitySchema]

    def json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(data: str) -> 'Schema':
        d = json.loads(data)
        ents = [
            EntitySchema(e['prompt'], tuple(e['offset']), tuple(e['size']),
                         e.get('blend', 0.8)) for e in d.pop('entities', [])
        ]
        return Schema(d['background_prompt'], d['style_start_prompt'],
                      d['style_end_prompt'], tuple(d['style_blend']), ents)
