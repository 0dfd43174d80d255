"""Sharding on a ``torch.distributed`` DeviceMesh, counterpart of
``repro/distributed/``: the logical-axis context (``ctx``), partition
rules and their resolution (``rules``, ``partition``), the ``jax.lax``
collectives (``collectives``) and the GPipe pipeline (``pipeline``)."""
from repro_torch.distributed.ctx import (  # noqa: F401
    NamedSharding, PartitionSpec, ShardingCtx, current_ctx, shard,
    use_sharding)
from repro_torch.distributed.partition import (  # noqa: F401
    DEFAULT_RULES, gather_tree, make_ctx, match_partition_rules,
    named_shardings, resolve_param_spec, shard_tree)
