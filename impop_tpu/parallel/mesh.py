"""Device-mesh construction.

The parallel structure (SURVEY.md §2.3): windows are embarrassingly parallel
(the reference iterates them sequentially in bash, run_pica2_impg.sh:126), so
the primary mesh axis ``data`` shards the window-batch dimension; the
secondary axis ``site`` shards the site/streaming dimension of allele
matrices for windows too long for one chip's HBM slice (a capability the
reference lacks — it caps windows at 10 kb, doc/how_pi.md:40).

Collectives: contractions over the sharded site axis psum over ``site``;
per-window results gather over ``data``.  Both are inserted by GSPMD from
NamedSharding annotations — the idiomatic JAX path (no hand-written NCCL
analogue; the reference's "backend" is POSIX pipes, run_pica2_odgi.sh:83).
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "window_sharding", "site_sharding", "replicated"]


def make_mesh(
    data: Optional[int] = None,
    site: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a (data, site) mesh over the available devices.

    ``data`` defaults to len(devices) // site.  Works identically for one
    GPU, the GPUs of a host, or the 8-virtual-device CPU test mesh.
    """
    devs = list(devices if devices is not None else jax.devices())
    if data is None:
        data = max(1, len(devs) // site)
    need = data * site
    if need > len(devs):
        raise ValueError(f"mesh {data}x{site} needs {need} devices, have {len(devs)}")
    grid = np.asarray(devs[:need]).reshape(data, site)
    return Mesh(grid, axis_names=("data", "site"))


def window_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Shard the leading (window-batch) axis over ``data``; replicate rest."""
    return NamedSharding(mesh, P("data", *([None] * (ndim - 1))))


def site_sharding(mesh: Mesh, ndim: int, site_axis: int) -> NamedSharding:
    """Shard the window axis over ``data`` and ``site_axis`` over ``site``."""
    spec = [None] * ndim
    spec[0] = "data"
    spec[site_axis] = "site"
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
