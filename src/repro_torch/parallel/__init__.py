"""Distribution layer: mesh axes, sharding rules, collectives."""

from .sharding import ShardingRules

__all__ = ["ShardingRules"]
