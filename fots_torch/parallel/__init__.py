"""The device mesh (port of ``fots/parallel``): data parallel over
``torch.distributed``, the vocabulary heads sharded over 'model'."""

from fots_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    batch_sharding,
    init_from_env,
    make_mesh,
    param_shardings,
    replicate,
    shard_init,
)
