"""Mesh/sharding layer: batched QP solves over several devices."""
from .mesh import BatchStats, Mesh, make_mesh, shard_batch, solve_sharded

__all__ = ["BatchStats", "Mesh", "make_mesh", "shard_batch", "solve_sharded"]
