"""Distribution layer: mesh context, activation sharding helpers, parameter
sharding rules with divisibility-aware fallbacks, their DTensor layouts, and
tensor parallelism over 'model' (``tp``)."""

from .context import P, PartitionSpec, axis_size, get_mesh, pspec, shard, use_mesh
from .sharding import Sharding, distribute, param_shardings, placements, zero_extend

__all__ = ["use_mesh", "get_mesh", "shard", "pspec", "axis_size", "P",
           "PartitionSpec", "Sharding", "param_shardings", "zero_extend",
           "placements", "distribute"]
