"""Serving: JSON API + dynamic micro-batching (port of
``flexdiffuse_tpu/serving``).

``python -m flexdiffuse_tpu_torch.cli serve-api`` (cli.py) or::

    from flexdiffuse_tpu_torch.serving import launch
    launch(lambda: Runner(model_root='./models'), port=8000).serve_forever()

See serving/api.py for the endpoint contract and serving/batcher.py for
the batching discipline.
"""
from flexdiffuse_tpu_torch.serving.api import (GenerationService, launch,
                                               row_noise)
from flexdiffuse_tpu_torch.serving.batcher import MicroBatcher, pad_rows

__all__ = ['GenerationService', 'launch', 'MicroBatcher', 'pad_rows',
           'row_noise']
