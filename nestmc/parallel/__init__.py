"""Parallelism layer (L6): device mesh + sharding rules.

There is no user-level communication library anywhere in nestmc — the
replacement for a hand-written NCCL backend is the XLA compiler inserting
collectives from ``jit`` + ``NamedSharding`` over the ('chains', 'groups')
mesh. The only hot-loop collective this induces is the psum-over-groups in
population-block conditionals when the groups axis is sharded.
"""

from nestmc.parallel.sharding import (
    data_shardings,
    make_mesh,
    shard_inputs,
    state_shardings,
)

__all__ = [
    "data_shardings",
    "make_mesh",
    "shard_inputs",
    "state_shardings",
]
