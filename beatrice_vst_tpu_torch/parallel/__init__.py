"""Mesh construction, sharding rules, distributed bring-up and the
collectives of tensor and data parallelism (port of
`beatrice_vst_tpu/parallel/`)."""

from .collectives import (  # noqa: F401
    copy_to_model,
    gather_from_model,
    reduce_from_model,
)
from .mesh import (  # noqa: F401
    MODEL_PARALLEL_RULES,
    P,
    distributed_init,
    gather_tree,
    make_mesh,
    params_sharding,
    replicated,
    shard_tree,
    spawn_cpu_ranks,
    state_sharding,
)
