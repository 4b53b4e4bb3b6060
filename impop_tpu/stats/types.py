"""Device-side tile types for window statistics.

Every estimator in :mod:`impop_tpu.stats` consumes a :class:`SimTile`: a
padded, fixed-shape [N, N] similarity matrix with masks.  Fixed shapes are
what make the estimators jit/vmap-able and matmul-friendly — ragged per-window
haplotype sets (the reference's dict-of-pairs, pica2.py:29) become masked
rectangles.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import jax.numpy as jnp
import numpy as np

__all__ = ["SimTile", "sim_tile_from_matrix", "pad_tile"]


class SimTile(NamedTuple):
    """One window's pairwise-identity data, padded to a static size N.

    sim:     [N, N] float32 — symmetric similarity, diag 1.0, 0 where absent
    present: [N, N] bool    — True where the pair has data (diag True)
    member:  [N]    bool    — True for real rows (False = padding)
    """

    sim: jnp.ndarray
    present: jnp.ndarray
    member: jnp.ndarray

    @property
    def capacity(self) -> int:
        return self.member.shape[-1]


def pad_tile(
    sim: np.ndarray,
    present: np.ndarray,
    capacity: int,
    member: Optional[np.ndarray] = None,
) -> SimTile:
    """Pad host-side [n, n] arrays out to capacity N and wrap as a SimTile."""
    n = sim.shape[0]
    if n > capacity:
        raise ValueError(f"window has {n} haplotypes > tile capacity {capacity}")
    sim_p = np.zeros((capacity, capacity), dtype=np.float32)
    pres_p = np.zeros((capacity, capacity), dtype=bool)
    memb_p = np.zeros(capacity, dtype=bool)
    sim_p[:n, :n] = sim
    pres_p[:n, :n] = present
    memb_p[:n] = True if member is None else member
    return SimTile(
        sim=jnp.asarray(sim_p),
        present=jnp.asarray(pres_p),
        member=jnp.asarray(memb_p),
    )


def sim_tile_from_matrix(mat, capacity: Optional[int] = None) -> SimTile:
    """Build a SimTile from an io.SimilarityMatrix (host-side).

    Rounding (if any) must already have been applied on the host in float64
    (SimilarityMatrix.rounded) so the device f32 copy carries the reference's
    decimal-rounded values.
    """
    cap = capacity if capacity is not None else mat.n
    return pad_tile(mat.sim.astype(np.float32), mat.present, cap)


def mask_from_names(mat, names: Sequence[str], capacity: int) -> jnp.ndarray:
    """Panel membership mask padded to tile capacity."""
    mask = np.zeros(capacity, dtype=bool)
    idx = mat.index()
    for name in names:
        i = idx.get(name)
        if i is not None:
            mask[i] = True
    return jnp.asarray(mask)
