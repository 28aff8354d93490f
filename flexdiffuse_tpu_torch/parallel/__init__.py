"""Parallelism over ``torch.distributed``: meshes, data- and
tensor-parallel layouts, sequence-parallel pipelines, sweeps, and the
launcher that starts the ranks (port of ``flexdiffuse_tpu/parallel``)."""
from flexdiffuse_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                                 batch_sharding, make_mesh,
                                                 param_shardings, replicated,
                                                 seed_sweep_keys, shard_batch,
                                                 shard_params)
from flexdiffuse_tpu_torch.parallel.sp import (SEQ_AXIS, make_sp_mesh,
                                               sp_pipeline)
from flexdiffuse_tpu_torch.parallel.sweep import (compose_sweep,
                                                  guidance_param_sweep, sweep)

__all__ = [
    'DATA_AXIS', 'MODEL_AXIS', 'SEQ_AXIS', 'make_mesh', 'make_sp_mesh',
    'sp_pipeline', 'shard_params', 'param_shardings', 'shard_batch',
    'batch_sharding',
    'replicated', 'seed_sweep_keys', 'sweep', 'guidance_param_sweep',
    'compose_sweep'
]
