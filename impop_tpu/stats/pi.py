"""Nucleotide diversity (π) estimators.

π from a pairwise-identity matrix via allele-class grouping, matching the two
grouped semantics in the reference:

- :func:`pi_grouped`      — pica2 semantics (pica2.py:94-169): greedy one-hop
  groups, seed-vs-seed representative similarity, Bessel factor n/(n-1).
  This is the estimator wired into every reference driver
  (run_pica2_impg.sh:175, run_fst_impg.sh:73, run_tajd.sh:166).
- :func:`grouped_diversity` with ``rep='first_pair'`` — hud.py grouped
  semantics (hud.py:100-128): same groups, but the group-pair similarity is
  the first *present* element pair scanning sorted members.

Both reduce to the quadratic form wᵀ((1-sim)⊙mask)w over representative
weights, which XLA maps onto matmuls; grouping itself is a fori_loop of
vectorised row updates (see stats/grouping.py).
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

import jax

from impop_tpu.stats.grouping import (
    first_pair_winner,
    greedy_group,
    greedy_group_panels,
    group_sizes,
    rep_weights,
)

__all__ = ["PiResult", "pi_grouped", "pi_grouped_panels", "grouped_diversity"]


class PiResult(NamedTuple):
    pi: jnp.ndarray          # scalar f32 — the π statistic (not per-site)
    n: jnp.ndarray           # scalar f32 — number of member haplotypes
    num_groups: jnp.ndarray  # scalar i32 — number of allele classes
    pairs_used: jnp.ndarray  # scalar i32 — group pairs with similarity data
    pairs_missing: jnp.ndarray  # scalar i32 — group pairs skipped (no data)

    def per_site(self, length) -> jnp.ndarray:
        return self.pi / length


def pi_grouped(sim, present, member, threshold) -> PiResult:
    """π with pica2 semantics over a SimTile's arrays.

    pi = (n / (n-1)) * Σ_{group pairs a<b with data} 2 (1-s_ab) f_a f_b
    where s_ab = sim(seed_a, seed_b)  (pica2.py:128-139, 154).

    Returns 0 when n <= 1 or no group pair has data (pica2.py:122-124,
    150-152).
    """
    gid = greedy_group(sim, present, member, threshold)
    w, n = rep_weights(gid, member)
    is_rep = w > 0

    offdiag = ~jnp.eye(member.shape[0], dtype=bool)
    pair_mask = present & offdiag
    contrib = jnp.where(pair_mask, 1.0 - sim, 0.0)
    # Σ_{a≠b} (1-s) w_a w_b  ==  Σ_{a<b} 2 (1-s) w_a w_b   (symmetry)
    # HIGHEST: contrib carries (1-sim) values; a DEFAULT f32 dot may
    # round its operands to TF32 (~1e-3 relative pi error)
    quad = jnp.dot(w, jnp.dot(contrib, w, preferred_element_type=jnp.float32,
                              precision=jax.lax.Precision.HIGHEST),
                   precision=jax.lax.Precision.HIGHEST)

    num_groups = jnp.sum(is_rep.astype(jnp.int32))
    rep_pair = is_rep[:, None] & is_rep[None, :] & offdiag
    pairs_used = jnp.sum((rep_pair & present).astype(jnp.int32)) // 2
    pairs_total = (num_groups * (num_groups - 1)) // 2
    pairs_missing = pairs_total - pairs_used

    pi = jnp.where(
        (n > 1) & (pairs_used > 0), n / jnp.maximum(n - 1.0, 1.0) * quad, 0.0
    )
    return PiResult(pi, n, num_groups, pairs_used, pairs_missing)


def pi_grouped_panels(sim, present, member, pmasks, threshold) -> PiResult:
    """:func:`pi_grouped` for P panels of one window in a single pass.

    Grouping shares the window's [N, N] link structure across panels
    (greedy_group_panels) and the P quadratic forms become one
    [P, N] @ [N, N] matmul plus a row-wise dot — every [N, N] operand is
    read once per window instead of once per panel.  Returns PiResult with
    [P]-shaped fields.
    """
    n_cap = member.shape[0]
    gid = greedy_group_panels(sim, present, member, pmasks, threshold)  # [P,N]
    pm = pmasks & member[None, :]
    n = jnp.sum(pm.astype(jnp.float32), axis=1)                         # [P]

    sizes = jax.vmap(group_sizes)(gid, pm)                              # [P,N]
    is_rep = sizes > 0
    w = jnp.where(
        is_rep, sizes.astype(jnp.float32) / jnp.maximum(n, 1.0)[:, None], 0.0
    )                                                                   # [P,N]

    offdiag = ~jnp.eye(n_cap, dtype=bool)
    pair_mask = present & offdiag
    contrib = jnp.where(pair_mask, 1.0 - sim, 0.0)
    y = jax.lax.dot_general(
        w, contrib, dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,  # value-carrying operands
    )                                                                   # [P,N]
    quad = jnp.sum(y * w, axis=1)                                       # [P]

    num_groups = jnp.sum(is_rep.astype(jnp.int32), axis=1)
    # group pairs with data: rep-pair presence via one matmul on the shared
    # presence matrix
    rep_f = is_rep.astype(jnp.float32)
    pres_f = pair_mask.astype(jnp.float32)
    pairs_used = jnp.round(
        jnp.sum(
            jax.lax.dot_general(
                rep_f, pres_f, dimension_numbers=(((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            ) * is_rep.astype(jnp.float32),
            axis=1,
        ) / 2.0
    ).astype(jnp.int32)
    pairs_total = (num_groups * (num_groups - 1)) // 2
    pairs_missing = pairs_total - pairs_used

    pi = jnp.where(
        (n > 1) & (pairs_used > 0), n / jnp.maximum(n - 1.0, 1.0) * quad, 0.0
    )
    return PiResult(pi, n, num_groups, pairs_used, pairs_missing)


def grouped_diversity(sim, present, member, threshold) -> PiResult:
    """Within-set diversity with hud.py grouped semantics (hud.py:100-128).

    Identical structure to :func:`pi_grouped` except the group-pair
    similarity is taken from the first present element pair between the two
    groups (hud.py:88-98) instead of seed-vs-seed, and n <= 1 returns 0
    early (hud.py:105-106).
    """
    gid = greedy_group(sim, present, member, threshold)
    sizes = group_sizes(gid, member)
    n = jnp.sum(member.astype(jnp.float32))
    is_rep = sizes > 0
    num_groups = jnp.sum(is_rep.astype(jnp.int32))

    winner = first_pair_winner(present, member, gid, gid, ordered=False)
    size_of = sizes[jnp.clip(gid, 0, member.shape[0] - 1)].astype(jnp.float32)
    freq = size_of / jnp.maximum(n, 1.0)
    # each winner (i, j) carries its unordered group pair's full term
    terms = jnp.where(winner, 2.0 * freq[:, None] * freq[None, :] * (1.0 - sim), 0.0)
    diversity_sum = jnp.sum(terms)

    pairs_used = jnp.sum(winner.astype(jnp.int32))
    pairs_total = (num_groups * (num_groups - 1)) // 2
    pairs_missing = pairs_total - pairs_used

    diversity = jnp.where(
        n > 1, diversity_sum * n / jnp.maximum(n - 1.0, 1.0), 0.0
    )
    return PiResult(diversity, n, num_groups, pairs_used, pairs_missing)
