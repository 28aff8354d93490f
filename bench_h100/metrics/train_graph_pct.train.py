"""Percent of the train steps in the train hull (``spans.py``) that
replayed a CUDA graph: the ``fd.train_replay`` spans
(``flexdiffuse_tpu_torch/training/step_graph.py``) over the
``fd.train_step`` spans (every LoRA or full step). A program without the
step's graphs has no ``fd.train_replay`` span and reads 0."""
from bench_h100 import spans


def read(ctx):
    s = spans.from_ctx(ctx, spans.TRAIN)
    steps = None if s is None else len(s.spans.get('fd.train_step', []))
    if not steps:
        return None
    return 100.0 * len(s.spans.get('fd.train_replay', [])) / steps
