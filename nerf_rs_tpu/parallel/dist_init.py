"""Multi-host initialization.

The reference is one process on one GPU (SURVEY §2.12-bis). Across
hosts the standard JAX recipe applies: every host process calls
jax.distributed.initialize, after which jax.devices() spans every
host's devices and the same Mesh/shard_map code runs unchanged.
Failure recovery is
restart-and-resume: re-init, reload the latest checkpoint
(train/checkpoint.latest_checkpoint) — no in-band elasticity is needed
at this model scale (SURVEY §5.3).
"""

from __future__ import annotations

import os
from typing import Optional

import jax


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize jax.distributed when running multi-process.

    No-ops (returns False) in single-process runs so the same entry
    point works on one device, one host, or several hosts. Arguments
    default to the NERF_COORDINATOR / NERF_NUM_PROCESSES /
    NERF_PROCESS_ID env vars.
    """
    num_processes = num_processes or int(os.environ.get("NERF_NUM_PROCESSES", "1"))
    if num_processes <= 1 and coordinator_address is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address
        or os.environ.get("NERF_COORDINATOR", None),
        num_processes=num_processes,
        process_id=process_id
        if process_id is not None
        else int(os.environ.get("NERF_PROCESS_ID", "0")),
    )
    return True


def is_primary() -> bool:
    """True on the process that should write checkpoints/logs."""
    return jax.process_index() == 0
