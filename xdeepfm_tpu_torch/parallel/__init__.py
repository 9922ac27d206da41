"""Multi-device training and scoring (port of ``xdeepfm_tpu/parallel/``):
the (data, embed) rank grid (``mesh``), row-sharded embedding lookups and
the shard-local lazy update (``sharded_embedding``), the process bootstrap
(``distributed``)."""

from .mesh import (
    make_mesh,
    param_sharding_rule,
    shard_batch,
    shard_params,
    shard_model_state,
)
