"""Logical-axis partitioning rules of the port, on DTensor (the reference's
``repro.sharding``)."""
from .partitioning import (
    ShardingRules,
    activation_rules,
    make_rules,
    param_rules,
    shard,
    shard_map,
    set_mesh,
    get_mesh,
)

__all__ = [
    "ShardingRules",
    "activation_rules",
    "make_rules",
    "param_rules",
    "shard",
    "shard_map",
    "set_mesh",
    "get_mesh",
]
