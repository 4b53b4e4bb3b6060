"""Multi-host scan coordination.

The reference has no multi-node story (its "communication backend" is POSIX
pipes, SURVEY.md §2.3).  Here the design is:

- ``jax.distributed.initialize()`` connects the hosts; the (data, site) mesh
  spans all devices of all hosts; XLA's collectives (NCCL on GPUs) ride
  the host's interconnect within a host and the network across hosts.
- Windows are embarrassingly parallel, so the *host-side* work (extraction,
  tile building) is partitioned by :func:`host_window_range` — each host
  loads only its contiguous slice of the window list, builds its local shard
  of the global batch, and per-window results need no cross-host reduction
  (only the output gather, or per-host output files merged afterwards).
- Global statistics that do reduce across windows (e.g. a genome-wide AFS)
  merge with ``psum`` over the ``data`` axis inside the jitted step.

Single-host behaviour is the identity partition, so the same CLI flags work
everywhere: run the scan under e.g.

    JAX_COORDINATOR=host0:1234 JAX_NUM_PROCESSES=4 JAX_PROCESS_ID=k \\
        impop-tpu scan ... --distributed
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

__all__ = ["maybe_initialize", "host_window_range", "is_coordinator"]


def maybe_initialize(enabled: bool) -> Tuple[int, int]:
    """Initialise jax.distributed from the environment when enabled.

    Returns (process_index, process_count).  Reads the standard JAX
    coordination variables (or the explicit JAX_COORDINATOR /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID trio).
    """
    import jax

    if enabled:
        kwargs = {}
        if os.environ.get("JAX_COORDINATOR"):
            kwargs = dict(
                coordinator_address=os.environ["JAX_COORDINATOR"],
                num_processes=int(os.environ.get("JAX_NUM_PROCESSES", "1")),
                process_id=int(os.environ.get("JAX_PROCESS_ID", "0")),
            )
        jax.distributed.initialize(**kwargs)
    return jax.process_index(), jax.process_count()


def host_window_range(
    n_windows: int, process_index: int, process_count: int
) -> Tuple[int, int]:
    """Contiguous [lo, hi) slice of the window list owned by this host."""
    per_host = (n_windows + process_count - 1) // process_count
    lo = min(process_index * per_host, n_windows)
    hi = min(lo + per_host, n_windows)
    return lo, hi


def is_coordinator() -> bool:
    import jax

    return jax.process_index() == 0
