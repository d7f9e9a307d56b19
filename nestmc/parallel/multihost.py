"""Multi-host support.

The normal layout is ONE process per host driving all of that host's
cards: ``make_mesh`` builds the mesh over ``jax.devices()``, which spans
every process once :func:`initialize` has run. Several processes on one
host must each be given their own cards (``local_device_ids``); otherwise
every process would open every card of the host.

The multi-process path is exercised without a cluster:
tests/test_multihost.py::test_two_process_distributed_sample runs 2
`jax.distributed.initialize`'d processes x 4 forced CPU devices each and
samples over the process-spanning 2x4 mesh. The design keeps the
chains-axis sharding cheap across hosts:

- call :func:`initialize` once per process before any jax call;
- keep the 'chains' axis outermost across hosts: chain parallelism has no
  hot-loop collectives, so the network between hosts only carries the
  end-of-run diagnostics reductions; the per-sweep psum of the group axis
  stays within a host as long as 'groups' shards only over one host's
  cards.

Checkpointing in multi-host runs: each process saves only
``jax.process_index() == 0`` (the carry is replicated per-chain-shard;
addressable shards suffice to rebuild on resume with the same topology).
"""

from __future__ import annotations

import os

import jax


def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def _env_ids(name: str) -> list[int] | None:
    v = os.environ.get(name)
    if v in (None, ""):
        return None
    return [int(t) for t in v.split(",") if t.strip()]


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: list[int] | None = None,
) -> None:
    """Thin wrapper over jax.distributed.initialize with env fallbacks.

    Explicit arguments win; otherwise NESTMC_COORDINATOR_ADDRESS /
    NESTMC_NUM_PROCESSES / NESTMC_PROCESS_ID / NESTMC_LOCAL_DEVICE_IDS
    (comma-separated card indices) are read. With no coordinator and no
    process count configured this is a no-op, so the same entrypoint works
    on one host. ``local_device_ids`` is forwarded only when given: one
    process per host (the normal layout) leaves it unset and drives all
    of the host's cards.
    """
    if coordinator_address is None:
        coordinator_address = os.environ.get(
            "NESTMC_COORDINATOR_ADDRESS"
        ) or None
    if num_processes is None:
        num_processes = _env_int("NESTMC_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("NESTMC_PROCESS_ID")
    if local_device_ids is None:
        local_device_ids = _env_ids("NESTMC_LOCAL_DEVICE_IDS")
    if coordinator_address is None and num_processes is None:
        return  # single-host
    kw = {}
    if local_device_ids is not None:
        kw["local_device_ids"] = list(local_device_ids)
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kw,
    )


def is_primary() -> bool:
    return jax.process_index() == 0
