"""Direct (ungrouped) mean pairwise diversity.

The reference's ``calculate_diversity`` (h-fst.py:130-171, identical copy at
hud.py:130-171) averages (1 - similarity) over all available pairs — within
one set, or across two sets — counting pairs with no data as "missing" and
excluding them from the denominator.

O(n²) dict loops in the reference become two masked quadratic forms
(value sum and pair count) that XLA fuses into matmuls, batched over windows
via vmap.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

__all__ = ["DiversityResult", "direct_diversity"]


class DiversityResult(NamedTuple):
    mean: jnp.ndarray     # scalar f32 — average (1 - sim); 0.0 if no pairs
    count: jnp.ndarray    # scalar i32 — pairs with data
    missing: jnp.ndarray  # scalar i32 — pairs lacking data


def direct_diversity(
    sim: jnp.ndarray,
    present: jnp.ndarray,
    mask_a: jnp.ndarray,
    mask_b: Optional[jnp.ndarray] = None,
) -> DiversityResult:
    """Mean pairwise (1 - sim) within mask_a, or between mask_a and mask_b.

    Matches h-fst.py:130-171: the within case averages over unordered pairs
    i < j of mask_a; the between case over the full cross product (the
    reference strips the overlap first, h-fst.py:181-185, so caller masks
    must be disjoint for exact between-set parity).
    """
    a = mask_a.astype(jnp.float32)
    n_cap = sim.shape[0]
    offdiag = ~jnp.eye(n_cap, dtype=bool)
    pair_present = present & offdiag
    div = jnp.where(pair_present, 1.0 - sim, 0.0)
    presf = pair_present.astype(jnp.float32)

    # HIGHEST precision throughout: div carries real f32 values
    # ((1-sim) ~1e-3) and the intermediate count/sum vectors exceed a
    # bf16 or TF32 mantissa — a DEFAULT f32 dot that rounds its operands
    # gave ~1e-3 relative error in pi/Fst against a host f64 oracle
    hi = jax.lax.Precision.HIGHEST
    if mask_b is None:
        total = jnp.dot(a, jnp.dot(div, a, preferred_element_type=jnp.float32,
                                   precision=hi), precision=hi) * 0.5
        count = jnp.dot(a, jnp.dot(presf, a, preferred_element_type=jnp.float32,
                                   precision=hi), precision=hi) * 0.5
        n_a = jnp.sum(a)
        all_pairs = n_a * (n_a - 1.0) * 0.5
    else:
        b = mask_b.astype(jnp.float32)
        total = jnp.dot(a, jnp.dot(div, b, preferred_element_type=jnp.float32,
                                   precision=hi), precision=hi)
        count = jnp.dot(a, jnp.dot(presf, b, preferred_element_type=jnp.float32,
                                   precision=hi), precision=hi)
        all_pairs = jnp.sum(a) * jnp.sum(b)

    count_i = jnp.round(count).astype(jnp.int32)
    missing = jnp.round(all_pairs - count).astype(jnp.int32)
    mean = jnp.where(count > 0, total / jnp.maximum(count, 1.0), 0.0)
    return DiversityResult(mean, count_i, missing)
