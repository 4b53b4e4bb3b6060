"""Hudson's Fst — all three estimators the reference exposes.

1. :func:`hudson_fst_direct` — Fst = (Dxy - πxy)/Dxy with direct pairwise
   means (h-fst.py:173-249 and hud.py ``-m direct``), πxy = ½(πA + πB).
2. :func:`hudson_fst_grouped` — hud.py ``-m grouped`` (hud.py:204-263):
   within-pop diversities via grouped frequency sums, Dxy via cross-population
   group weights |gA|·|gB| / (nA·nB) with first-found representative pairs.
3. :func:`fst_3pi` — the "3-π" union estimator of run_fst_impg.sh:199-218:
   Fst = (πC - ½(πA+πB)) / πC over three pica2-grouped π values, NaN when
   πC == 0 (the driver prints NA).

All are pure functions of SimTile arrays + population masks; batch over
windows with vmap.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from impop_tpu.stats.diversity import DiversityResult, direct_diversity
from impop_tpu.stats.grouping import (
    first_pair_winner,
    greedy_group,
    greedy_group_panels,
    group_sizes,
)
from impop_tpu.stats.pi import grouped_diversity

__all__ = [
    "FstResult",
    "hudson_fst_direct",
    "hudson_fst_direct_pairs",
    "hudson_fst_grouped",
    "hudson_fst_grouped_pairs",
    "fst_3pi",
]


class FstResult(NamedTuple):
    """The reference's six-column Fst output (h-fst.py:338-339).

    All diversity fields are raw sums (not per-site); divide by window length
    for the per-site table values (h-fst.py:233-240).
    """

    fst: jnp.ndarray
    pi_a: jnp.ndarray
    pi_b: jnp.ndarray
    pi_xy: jnp.ndarray
    dxy: jnp.ndarray
    da: jnp.ndarray

    def per_site(self, length) -> "FstResult":
        inv = 1.0 / length
        return FstResult(
            self.fst, self.pi_a * inv, self.pi_b * inv,
            self.pi_xy * inv, self.dxy * inv, self.da * inv,
        )


def _assemble(pi_a, pi_b, dxy) -> FstResult:
    pi_xy = 0.5 * (pi_a + pi_b)
    fst = jnp.where(dxy > 0, (dxy - pi_xy) / jnp.where(dxy > 0, dxy, 1.0), 0.0)
    return FstResult(fst, pi_a, pi_b, pi_xy, dxy, dxy - pi_xy)


def hudson_fst_direct(sim, present, mask_a, mask_b) -> FstResult:
    """Hudson Fst, direct method.  mask_a/mask_b must be disjoint (the
    reference strips overlap before computing, h-fst.py:181-185)."""
    pi_a = direct_diversity(sim, present, mask_a).mean
    pi_b = direct_diversity(sim, present, mask_b).mean
    dxy = direct_diversity(sim, present, mask_a, mask_b).mean
    return _assemble(pi_a, pi_b, dxy)


def hudson_fst_direct_pairs(sim, present, masks_a, masks_b) -> FstResult:
    """:func:`hudson_fst_direct` for Q (already overlap-stripped) pair masks
    of one window at once: the 6 masked reductions per pair collapse into 4
    stacked [Q, N] @ [N, N] matmuls, so the window's similarity matrix is
    read once for all pairs (the reference forks one h-fst.py process per
    pair per window, run_h_fst_panels.sh).  Fields are [Q]-shaped.
    """
    n_cap = sim.shape[0]
    offdiag = ~jnp.eye(n_cap, dtype=bool)
    pair_present = present & offdiag
    div = jnp.where(pair_present, 1.0 - sim, 0.0)
    presf = pair_present.astype(jnp.float32)

    a = masks_a.astype(jnp.float32)
    b = masks_b.astype(jnp.float32)

    def mm(x, m):
        # HIGHEST: div carries (1-sim) values — a DEFAULT f32 dot may
        # round its operands to TF32 (~1e-3 relative error)
        return jax.lax.dot_general(
            x, m, dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )

    yd_a, yp_a = mm(a, div), mm(a, presf)
    yd_b, yp_b = mm(b, div), mm(b, presf)

    def rowdot(x, y):
        return jnp.sum(x * y, axis=1)

    sum_aa, cnt_aa = rowdot(yd_a, a) * 0.5, rowdot(yp_a, a) * 0.5
    sum_bb, cnt_bb = rowdot(yd_b, b) * 0.5, rowdot(yp_b, b) * 0.5
    sum_ab, cnt_ab = rowdot(yd_a, b), rowdot(yp_a, b)

    pi_a = jnp.where(cnt_aa > 0, sum_aa / jnp.maximum(cnt_aa, 1.0), 0.0)
    pi_b = jnp.where(cnt_bb > 0, sum_bb / jnp.maximum(cnt_bb, 1.0), 0.0)
    dxy = jnp.where(cnt_ab > 0, sum_ab / jnp.maximum(cnt_ab, 1.0), 0.0)
    return _assemble(pi_a, pi_b, dxy)


def hudson_fst_grouped(sim, present, mask_a, mask_b, threshold) -> FstResult:
    """Hudson Fst, hud.py grouped method (hud.py:204-263).

    πA, πB: grouped_diversity within each population (first-pair reps,
    Bessel n/(n-1)).  Dxy: group populations separately, then
    Σ over cross group pairs (|gA|·|gB| / (nA·nB)) · (1 - s_first_pair)
    — no Bessel factor (hud.py:244-262).
    """
    pi_a = grouped_diversity(sim, present, mask_a, threshold).pi
    pi_b = grouped_diversity(sim, present, mask_b, threshold).pi

    gid_a = greedy_group(sim, present, mask_a, threshold)
    gid_b = greedy_group(sim, present, mask_b, threshold)
    sizes_a = group_sizes(gid_a, mask_a)
    sizes_b = group_sizes(gid_b, mask_b)
    n_a = jnp.sum(mask_a.astype(jnp.float32))
    n_b = jnp.sum(mask_b.astype(jnp.float32))

    winner = first_pair_winner(
        present, mask_a, gid_a, gid_b, member_col=mask_b, ordered=True
    )
    n_cap = mask_a.shape[0]
    size_of_a = sizes_a[jnp.clip(gid_a, 0, n_cap - 1)].astype(jnp.float32)
    size_of_b = sizes_b[jnp.clip(gid_b, 0, n_cap - 1)].astype(jnp.float32)
    weight = size_of_a[:, None] * size_of_b[None, :] / jnp.maximum(n_a * n_b, 1.0)
    dxy = jnp.sum(jnp.where(winner, weight * (1.0 - sim), 0.0))
    return _assemble(pi_a, pi_b, dxy)


def hudson_fst_grouped_pairs(sim, present, masks_a, masks_b, threshold
                             ) -> FstResult:
    """:func:`hudson_fst_grouped` for Q (already overlap-stripped) pair
    masks of one window at once, with the grouping SHARED across pairs:
    all 2Q population masks go through one ``greedy_group_panels`` call
    (one link-structure build + one seed-peel for the whole pair batch,
    the same sharing ``fused_panel_stats`` uses for π), instead of 2Q
    independent ``greedy_group`` invocations.  Fields are [Q]-shaped.

    Semantics are identical to vmapping :func:`hudson_fst_grouped` over
    pairs (asserted by tests/test_fst.py).
    """
    q = masks_a.shape[0]
    n_cap = masks_a.shape[1]
    all_masks = jnp.concatenate([masks_a, masks_b], axis=0)   # [2Q, N]
    member = jnp.any(all_masks, axis=0)
    gid = greedy_group_panels(sim, present, member, all_masks, threshold)
    sizes = jax.vmap(group_sizes)(gid, all_masks)             # [2Q, N]
    n = jnp.sum(all_masks.astype(jnp.float32), axis=1)        # [2Q]

    def within(gid1, pm1, sizes1, n1):
        # hud.py grouped within-set diversity (hud.py:100-128), post-grouping
        winner = first_pair_winner(present, pm1, gid1, gid1, ordered=False)
        size_of = sizes1[jnp.clip(gid1, 0, n_cap - 1)].astype(jnp.float32)
        freq = size_of / jnp.maximum(n1, 1.0)
        terms = jnp.where(
            winner, 2.0 * freq[:, None] * freq[None, :] * (1.0 - sim), 0.0
        )
        total = jnp.sum(terms)
        return jnp.where(n1 > 1, total * n1 / jnp.maximum(n1 - 1.0, 1.0),
                         0.0)

    divs = jax.vmap(within)(gid, all_masks, sizes, n)         # [2Q]
    pi_a, pi_b = divs[:q], divs[q:]

    def cross(gid_a, gid_b, ma, mb, sa, sb, na, nb):
        # grouped Dxy (hud.py:235-263): cross-population group weights,
        # first-found representative pairs, no Bessel factor
        winner = first_pair_winner(present, ma, gid_a, gid_b,
                                   member_col=mb, ordered=True)
        size_of_a = sa[jnp.clip(gid_a, 0, n_cap - 1)].astype(jnp.float32)
        size_of_b = sb[jnp.clip(gid_b, 0, n_cap - 1)].astype(jnp.float32)
        weight = (size_of_a[:, None] * size_of_b[None, :]
                  / jnp.maximum(na * nb, 1.0))
        return jnp.sum(jnp.where(winner, weight * (1.0 - sim), 0.0))

    dxy = jax.vmap(cross)(
        gid[:q], gid[q:], masks_a, masks_b, sizes[:q], sizes[q:],
        n[:q], n[q:],
    )
    return _assemble(pi_a, pi_b, dxy)


def fst_3pi(pi_a, pi_b, pi_c):
    """3-π Fst (run_fst_impg.sh:207-218): (πC - ½(πA+πB)) / πC; NaN if πC==0.

    Inputs may be raw or per-site π as long as all three share the scale —
    the reference feeds per-site values (pica2 stdout first token).
    """
    pi_ab = 0.5 * (pi_a + pi_b)
    return jnp.where(pi_c != 0, (pi_c - pi_ab) / jnp.where(pi_c != 0, pi_c, 1.0),
                     jnp.nan)
