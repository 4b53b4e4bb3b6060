"""Fused per-window panel statistics — the engine's single device pass.

One window's similarity matrix serves every estimator of the fused scan
(cli scan / bench.py): pica2-grouped π for each panel AND each pair-union
(the 3-π Fst numerators, run_fst_impg.sh:184-205), Hudson direct Fst for
each panel pair (h-fst.py semantics), and the group-pair bookkeeping π
logging needs.  All masked reductions collapse into two stacked matmuls
(ops/panelquad.py) after a single shared grouping pass
(stats/grouping.greedy_group_panels).

Semantics are identical to composing stats.pi.pi_grouped_panels +
stats.fst.hudson_fst_direct_pairs — asserted by tests/test_panelstats.py.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import jax
import jax.numpy as jnp

from impop_tpu.ops.panelquad import masked_pair_sums_xla
from impop_tpu.stats.fst import FstResult, _assemble
from impop_tpu.stats.grouping import greedy_group_panels, group_sizes

__all__ = ["PanelStats", "fused_panel_stats", "fused_window_stats",
           "panel_mask_stack"]

# Debug guard for the seed-representative grouped-Hudson invariant (set
# IMPOP_TPU_DEBUG_INVARIANTS=1, or flip the module flag in tests): verifies
# on device that every group-seed pair the fused reduction relies on
# actually has data, warning when a source violates it (allele-derived
# matrices guarantee it; a future sparse source might not — hud.py:88-98
# would then scan past the seed pair while we would contribute zero).
DEBUG_SEED_INVARIANT = os.environ.get("IMPOP_TPU_DEBUG_INVARIANTS") == "1"


def _warn_missing_seed_pairs(missing) -> None:
    import warnings

    n_bad = int(missing)
    if n_bad > 0:
        warnings.warn(
            f"fused grouped-Hudson: {n_bad} group-seed pair(s) lack data; "
            "seed-representative FSTG deviates from hud.py -m grouped here "
            "— use the exact stats/fst.hudson_fst_grouped_pairs path for "
            "this source",
            RuntimeWarning,
            stacklevel=2,
        )


def _seed_pair_guard(rep_a, rep_b, present) -> None:
    """Count (within-A, within-B, cross) seed pairs without data."""
    p_f = present.astype(jnp.float32)
    have_ab = jnp.einsum("qn,nm,qm->q", rep_a, p_f, rep_b)
    have_aa = jnp.einsum("qn,nm,qm->q", rep_a, p_f, rep_a)
    have_bb = jnp.einsum("qn,nm,qm->q", rep_b, p_f, rep_b)
    g_a = jnp.sum(rep_a, axis=1)
    g_b = jnp.sum(rep_b, axis=1)
    missing = (jnp.sum(g_a * g_b - have_ab)
               + jnp.sum(g_a * g_a - have_aa)
               + jnp.sum(g_b * g_b - have_bb))
    jax.debug.callback(_warn_missing_seed_pairs, missing)


class PanelStats(NamedTuple):
    pi: jnp.ndarray             # [P+Q] raw π per panel then per pair-union
    n: jnp.ndarray              # [P+Q] member counts
    num_groups: jnp.ndarray     # [P+Q]
    pairs_used: jnp.ndarray     # [P+Q]
    pairs_missing: jnp.ndarray  # [P+Q]
    hudson: FstResult           # [Q]-shaped direct-method fields
    hudson_grouped: FstResult   # [Q]-shaped grouped-method fields (seed
                                # representatives; == hud.py -m grouped
                                # whenever every group-seed pair has data —
                                # see fused_panel_stats docstring)
    seed_risk: jnp.ndarray      # bool scalar: some pair of group seeds
                                # lacks data, so hudson_grouped MAY deviate
                                # from hud.py's first-found-pair scan —
                                # conservative (seed-union) flag; consumers
                                # re-run the exact path when set (cli scan)


def panel_mask_stack(pmasks, member, pair_a, pair_b, pairs_disjoint):
    """The mask stack one window's shared grouping pass runs over:
    panels, pair unions and (when overlap stripping can change them) both
    stripped Hudson sides.  Returns (all_masks [R, N], mask_a [Q, N],
    mask_b [Q, N])."""
    mask_a = pmasks[pair_a] & member[None, :]
    mask_b = pmasks[pair_b] & member[None, :]
    if not pairs_disjoint:
        ov = mask_a & mask_b
        mask_a = mask_a & ~ov
        mask_b = mask_b & ~ov
    unions = pmasks[pair_a] | pmasks[pair_b]
    if pairs_disjoint:
        all_masks = jnp.concatenate([pmasks, unions], axis=0)
    else:
        all_masks = jnp.concatenate([pmasks, unions, mask_a, mask_b],
                                    axis=0)
    return all_masks, mask_a, mask_b


def fused_panel_stats(
    sim: jnp.ndarray,
    present: jnp.ndarray,
    member: jnp.ndarray,
    pmasks: jnp.ndarray,
    pair_a: jnp.ndarray,
    pair_b: jnp.ndarray,
    threshold,
    pairs_disjoint: bool = False,
    gid: jnp.ndarray | None = None,
) -> PanelStats:
    """All panel/pair statistics of one window in one fused pass.

    Grouped-method Hudson (hud.py ``-m grouped``) is computed with SEED
    representatives: within-population diversity and cross-population Dxy
    are (bi)linear forms of group-frequency weight vectors concentrated on
    group seeds — two extra rows in the same stacked reduction, instead of
    per-pair winner searches (3 [N, N] matmuls per pair side).  hud.py's
    representative pair for groups (a, b) is the FIRST present pair
    scanning sorted members (hud.py:88-98), whose first candidate is
    exactly (seed_a, seed_b) — so this is bit-identical to hud.py whenever
    every group-seed pair has data, which allele-derived identity matrices
    guarantee for coverage-overlapping pairs.  The exact any-missing-pair fallback lives
    in stats/fst.hudson_fst_grouped_pairs (the ``hud`` CLI / TSV path).

    Args:
      sim:     [N, N] f32 similarities
      present: [N, N] bool
      member:  [N] bool
      pmasks:  [P, N] bool panel masks
      pair_a/pair_b: [Q] int32 panel indices of the pair batch
      threshold: grouping threshold scalar
      pairs_disjoint: static promise that no haplotype belongs to both
        panels of any pair — then the overlap strip is the identity and
        the stripped sides reuse the PANEL groupings/weights, avoiding 2Q
        extra masks in the grouping pass.  Callers verify host-side
        (the built panel masks are host data).
      gid: optional precomputed [R, N] group ids over panel_mask_stack's
        mask order — skips the grouping pass here.
    """
    n_cap = member.shape[0]
    p_count = pmasks.shape[0]
    q_count = pair_a.shape[0]

    # Hudson pair masks, overlap-stripped (h-fst.py:181-185), plus the
    # shared grouping mask stack
    all_masks, mask_a, mask_b = panel_mask_stack(
        pmasks, member, pair_a, pair_b, pairs_disjoint)
    a_f = mask_a.astype(jnp.float32)
    b_f = mask_b.astype(jnp.float32)
    pq = p_count + q_count

    if gid is None:
        with jax.named_scope("grouping"):
            gid = greedy_group_panels(sim, present, member, all_masks,
                                      threshold)
    pm = all_masks & member[None, :]
    n_all = jnp.sum(pm.astype(jnp.float32), axis=1)
    sizes = jax.vmap(group_sizes)(gid, pm)
    is_rep_all = sizes > 0
    w_all = jnp.where(
        is_rep_all,
        sizes.astype(jnp.float32) / jnp.maximum(n_all, 1.0)[:, None],
        0.0,
    )
    n = n_all[:pq]
    w = w_all[:pq]
    is_rep = is_rep_all[:pq]
    rep_f = is_rep.astype(jnp.float32)
    # grouped-Hudson weight vectors (stripped-side groupings; with
    # disjoint pairs the stripped side IS the panel, so reuse its rows)
    if pairs_disjoint:
        wga = w[pair_a]
        wgb = w[pair_b]
        n_a = n[pair_a]
        n_b = n[pair_b]
    else:
        wga = w_all[pq:pq + q_count]                           # [Q, N]
        wgb = w_all[pq + q_count:]
        n_a = n_all[pq:pq + q_count]
        n_b = n_all[pq + q_count:]

    if DEBUG_SEED_INVARIANT and q_count > 0:
        if pairs_disjoint:
            _seed_pair_guard(rep_f[pair_a], rep_f[pair_b], present)
        else:
            rep_all_f = is_rep_all.astype(jnp.float32)
            _seed_pair_guard(rep_all_f[pq:pq + q_count],
                             rep_all_f[pq + q_count:], present)

    # The reduction is LINEAR in the weight rows, so with disjoint pairs
    # (wga == w[pair_a]) the grouped-Hudson rows are exact copies of panel
    # rows already in the stack — recover them by row-take after the matmul
    # instead of recomputing (20 of 55 rows dropped at 5 panels).
    if pairs_disjoint:
        wd = jnp.concatenate([w, a_f, b_f], axis=0)            # [P+3Q, N]
        wp = jnp.concatenate([rep_f, a_f, b_f], axis=0)
    else:
        wd = jnp.concatenate([w, a_f, b_f, wga, wgb], axis=0)  # [P+5Q, N]
        wp = jnp.concatenate([rep_f, a_f, b_f, wga, wgb], axis=0)

    with jax.named_scope("panel_reduce"):
        yd, yp = masked_pair_sums_xla(sim, present, wd, wp)

    def rowdot(x, y):
        return jnp.sum(x * y, axis=1)

    # π quadratic forms + group-pair presence (pi_grouped_panels semantics)
    quad = rowdot(yd[:pq], w)
    pairs_used = jnp.round(rowdot(yp[:pq], rep_f) / 2.0).astype(jnp.int32)
    num_groups = jnp.sum(is_rep.astype(jnp.int32), axis=1)
    pairs_total = (num_groups * (num_groups - 1)) // 2
    pi = jnp.where(
        (n > 1) & (pairs_used > 0), n / jnp.maximum(n - 1.0, 1.0) * quad, 0.0
    )

    # Hudson direct (hudson_fst_direct_pairs semantics)
    yd_a = yd[pq:pq + q_count]
    yd_b = yd[pq + q_count:pq + 2 * q_count]
    yp_a = yp[pq:pq + q_count]
    yp_b = yp[pq + q_count:pq + 2 * q_count]
    sum_aa, cnt_aa = rowdot(yd_a, a_f) * 0.5, rowdot(yp_a, a_f) * 0.5
    sum_bb, cnt_bb = rowdot(yd_b, b_f) * 0.5, rowdot(yp_b, b_f) * 0.5
    sum_ab, cnt_ab = rowdot(yd_a, b_f), rowdot(yp_a, b_f)
    pi_a = jnp.where(cnt_aa > 0, sum_aa / jnp.maximum(cnt_aa, 1.0), 0.0)
    pi_b = jnp.where(cnt_bb > 0, sum_bb / jnp.maximum(cnt_bb, 1.0), 0.0)
    dxy = jnp.where(cnt_ab > 0, sum_ab / jnp.maximum(cnt_ab, 1.0), 0.0)

    # Hudson grouped, seed representatives (hud.py:100-128, 235-263):
    # within = Bessel * quadratic form of the side's group weights; Dxy =
    # bilinear form between the two sides' weights (no Bessel) — reusing
    # the yd rows already computed by the fused reduction.
    if pairs_disjoint:
        yd_ga = jnp.take(yd[:pq], pair_a, axis=0)
        yd_gb = jnp.take(yd[:pq], pair_b, axis=0)
    else:
        yd_ga = yd[pq + 2 * q_count:pq + 3 * q_count]
        yd_gb = yd[pq + 3 * q_count:]
    bessel_a = jnp.where(n_a > 1, n_a / jnp.maximum(n_a - 1.0, 1.0), 0.0)
    bessel_b = jnp.where(n_b > 1, n_b / jnp.maximum(n_b - 1.0, 1.0), 0.0)
    gpi_a = rowdot(yd_ga, wga) * bessel_a
    gpi_b = rowdot(yd_gb, wgb) * bessel_b
    gdxy = rowdot(yd_ga, wgb)

    # Conservative seed-pair-coverage flag: hud.py's representative for a
    # group pair is the FIRST present member pair (hud.py:88-98), whose
    # first candidate is the seed pair; the fused reduction contributes 0
    # where that seed pair lacks data.  Flag the window when ANY two group
    # seeds (union over every grouping in the stack — a superset of the
    # pairs actually consumed) have no data, so callers can re-run the
    # exact first-found-pair path (stats/fst.hudson_fst_grouped_pairs).
    # One [N, N] masked reduction; never fires on coverage-overlapping
    # allele-derived windows.
    if q_count > 0:
        seeds_any = jnp.any(is_rep_all, axis=0)
        seed_risk = jnp.any(
            seeds_any[:, None] & seeds_any[None, :] & ~present
            & ~jnp.eye(n_cap, dtype=bool)
        )
    else:
        seed_risk = jnp.zeros((), bool)

    return PanelStats(
        pi, n, num_groups, pairs_used, pairs_total - pairs_used,
        _assemble(pi_a, pi_b, dxy),
        _assemble(gpi_a, gpi_b, gdxy),
        seed_risk,
    )


def fused_window_stats(
    geno: jnp.ndarray,
    member: jnp.ndarray,
    site_mask: jnp.ndarray,
    length,
    pmasks: jnp.ndarray,
    pair_a: jnp.ndarray,
    pair_b: jnp.ndarray,
    threshold,
    pairs_disjoint: bool = False,
    return_matrices: bool = True,
) -> tuple:
    """One window, allele tile in, every panel statistic out.

    Composes identity_from_alleles + greedy_group_panels (inside
    fused_panel_stats) + segregating_sites.  XLA fuses the elementwise
    work around the [N, N] matmuls; nothing here is backend-specific.
    ``return_matrices=False`` (the scan/bench hot path) returns None for
    sim/present so that no caller comes to depend on them.

    Returns (sim, present, s_count f32, PanelStats).
    """
    from impop_tpu.stats.allele import (identity_from_alleles,
                                        segregating_sites)

    with jax.named_scope("identity"):
        sim, present = identity_from_alleles(geno, member, site_mask, length)
        s_count = segregating_sites(geno, member,
                                    site_mask).astype(jnp.float32)
    res = fused_panel_stats(sim, present, member, pmasks, pair_a, pair_b,
                            threshold, pairs_disjoint=pairs_disjoint)
    if not return_matrices:
        return None, None, s_count, res
    return sim, present, s_count, res
