"""Multi-host orchestration (SURVEY.md §2.3 equivalent).

The reference's only cross-worker communication is pickled result lists
through a process pool (engine.py:415-419). The multi-host equivalent:

* ``initialize()`` — wrap ``jax.distributed.initialize`` for multi-host
  runs (no-op when single-host or already initialized).
* a global 1-D mesh over every device of every process; each record's scan
  positions are partitioned across the global device order, the compiled
  STS table is replicated, and the per-shard hit buffers are merged with
  the ``all_gather`` already inside ``sharded_scan_record`` — every host
  ends up with the full hit set, and ``is_output_host()`` gates emission
  so exactly one host writes.

Determinism: hits carry (pos1, shard, tile, pair, rank) keys, so the merged
order is independent of arrival/host order — the single-device output is
reproduced exactly.
"""

from __future__ import annotations

import logging
from typing import Optional

import jax

logger = logging.getLogger(__name__)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed for a multi-host run.

    On GPU hosts JAX can only auto-detect the cluster under a scheduler
    it knows (SLURM, Open MPI); elsewhere pass ``coordinator_address``
    (``host:port`` of process 0), ``num_processes`` and ``process_id``
    explicitly. Without either, ``jax.distributed.initialize`` raises and
    this stays a logged single-process no-op — as it is when already
    initialized.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        logger.info(
            "jax.distributed initialized: process %d/%d, %d local / %d global devices",
            jax.process_index(), jax.process_count(),
            jax.local_device_count(), jax.device_count(),
        )
    except (RuntimeError, ValueError) as e:
        logger.debug("jax.distributed.initialize skipped: %s", e)


def global_mesh(axis: str = "shard"):
    """1-D mesh over all devices of all processes."""
    from .sharded import make_mesh

    return make_mesh(jax.devices(), axis)


def is_output_host() -> bool:
    """True on the process that should write results (host 0)."""
    return jax.process_index() == 0
