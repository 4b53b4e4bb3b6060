"""Cross-chip sharding of the haplotype pair space.

SURVEY §2.3 row 3: the reference's O(n²) Python pair loops
(h-fst.py:141-151) become, at HPRC scale (N≈466), a single-chip [N, N]
matmul — but the pair space grows quadratically, and past N ≈ a few
thousand one chip can neither hold nor want the full [N, N] identity
matrix.  This module shards the PAIR SPACE by row blocks over a mesh axis:

- geno rows are sharded [N/D, S] per device (the RHS operand is the full
  [N, S] tile, replicated — it is the small operand; the [N, N] product
  is the big one);
- each device computes only its [N/D, N] block of pairwise differences
  and immediately reduces it into the masked sums every direct-method
  statistic needs (π within, Dxy across, pair counts);
- partial sums merge with ``psum`` over the axis — the full [N, N] matrix
  NEVER exists anywhere.

Scope: the direct-method statistics (h-fst.py semantics) and S.  The
grouped/pica2 estimators need the global grouping recurrence over [N, N]
and stay on the replicated path — at the N where grouping matters
(hundreds of haplotypes) the matrix fits comfortably; the pair-space
shard is for the regime where N itself is the scaling axis.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["pair_sharded_direct_stats"]


def pair_sharded_direct_stats(mesh, axis: str = "data"):
    """Build a jitted row-block-sharded direct-stats function.

    Returns ``fn(geno, member, site_mask, masks_a, masks_b, length)`` with

      geno:      [N, S] int8 (N divisible by the axis size)
      member:    [N] bool
      site_mask: [S] bool
      masks_a:   [Q, N] bool — within/cross population masks (disjoint
                 from masks_b per pair, h-fst.py:181-185)
      masks_b:   [Q, N] bool
      length:    scalar f32

    returning (pi_a, pi_b, dxy, fst, s_count) with [Q]-shaped pair fields —
    the direct Hudson quantities of hudson_fst_direct_pairs, computed
    without materialising [N, N].
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    n_dev = mesh.shape[axis]

    def block_fn(geno_blk, geno_full, member, site_mask, masks_a, masks_b,
                 length):
        # local pairwise diff block [Nb, N]: rows = this device's shard
        nb = geno_blk.shape[0]
        n = geno_full.shape[0]
        idx = jax.lax.axis_index(axis)
        row0 = idx * nb

        vb = ((geno_blk >= 0) & site_mask[None, :]).astype(jnp.float32)
        vf = ((geno_full >= 0) & site_mask[None, :]).astype(jnp.float32)
        xb = jnp.where(geno_blk >= 0, geno_blk, 0).astype(jnp.float32) * vb
        xf = jnp.where(geno_full >= 0, geno_full, 0).astype(jnp.float32) * vf
        diff = (
            jnp.dot(xb, (vf - xf).T, preferred_element_type=jnp.float32)
            + jnp.dot(vb - xb, xf.T, preferred_element_type=jnp.float32)
        )                                               # [Nb, N]
        compared = jnp.dot(vb, vf.T, preferred_element_type=jnp.float32)

        rows = jnp.arange(nb, dtype=jnp.int32) + row0   # global row ids
        cols = jnp.arange(n, dtype=jnp.int32)
        offdiag = rows[:, None] != cols[None, :]
        mrow = member[rows]
        pair_ok = (compared > 0) & offdiag & mrow[:, None] & member[None, :]
        div = jnp.where(pair_ok, diff / jnp.maximum(length, 1.0), 0.0)
        okf = pair_ok.astype(jnp.float32)

        # masked sums for all Q pairs at once: [Q, Nb] @ [Nb, N] then a
        # row-dot against the column masks (hudson_fst_direct_pairs shape)
        a_rows = (masks_a[:, rows] & mrow[None, :]).astype(jnp.float32)
        b_rows = (masks_b[:, rows] & mrow[None, :]).astype(jnp.float32)
        a_cols = masks_a.astype(jnp.float32)
        b_cols = masks_b.astype(jnp.float32)

        def mm(w, m, hi=False):
            # hi: div carries per-site f32 values — a DEFAULT f32 dot
            # may round them to TF32 (~1e-3 rel error); the 0/1 count
            # mms stay DEFAULT (exact)
            return jax.lax.dot_general(
                w, m, dimension_numbers=(((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
                precision=(jax.lax.Precision.HIGHEST if hi else None),
            )

        yd_a, yp_a = mm(a_rows, div, hi=True), mm(a_rows, okf)   # [Q, N]
        yd_b, yp_b = mm(b_rows, div, hi=True), mm(b_rows, okf)

        def rowdot(x, m):
            return jnp.sum(x * m, axis=1)

        part = jnp.stack([
            rowdot(yd_a, a_cols), rowdot(yp_a, a_cols),   # within A (x2)
            rowdot(yd_b, b_cols), rowdot(yp_b, b_cols),   # within B (x2)
            rowdot(yd_a, b_cols), rowdot(yp_a, b_cols),   # cross (x1)
        ])                                                # [6, Q]
        part = jax.lax.psum(part, axis)

        # segregating sites: per-column min/max over the row shard, merged
        big = jnp.iinfo(jnp.int32).max
        g32 = geno_blk.astype(jnp.int32)
        valid_b = (geno_blk >= 0) & site_mask[None, :] & mrow[:, None]
        cmin = jax.lax.pmin(
            jnp.min(jnp.where(valid_b, g32, big), axis=0), axis)
        cmax = jax.lax.pmax(
            jnp.max(jnp.where(valid_b, g32, -1), axis=0), axis)
        s_count = jnp.sum(((cmax > cmin) & (cmax >= 0)).astype(jnp.int32))
        return part, s_count

    spec_rows = P(axis)
    rep = P()
    sharded = shard_map(
        block_fn, mesh=mesh,
        in_specs=(spec_rows, rep, rep, rep, rep, rep, rep),
        out_specs=(rep, rep),
        check_vma=False,
    )

    @jax.jit
    def fn(geno, member, site_mask, masks_a, masks_b, length):
        part, s_count = sharded(
            geno, geno, member, site_mask, masks_a, masks_b,
            jnp.asarray(length, jnp.float32),
        )
        sum_aa, cnt_aa = part[0] * 0.5, part[1] * 0.5
        sum_bb, cnt_bb = part[2] * 0.5, part[3] * 0.5
        sum_ab, cnt_ab = part[4], part[5]
        pi_a = jnp.where(cnt_aa > 0, sum_aa / jnp.maximum(cnt_aa, 1.0), 0.0)
        pi_b = jnp.where(cnt_bb > 0, sum_bb / jnp.maximum(cnt_bb, 1.0), 0.0)
        dxy = jnp.where(cnt_ab > 0, sum_ab / jnp.maximum(cnt_ab, 1.0), 0.0)
        pi_xy = 0.5 * (pi_a + pi_b)
        fst = jnp.where(dxy > 0, (dxy - pi_xy) / jnp.where(dxy > 0, dxy, 1.0),
                        0.0)
        return pi_a, pi_b, dxy, fst, s_count

    return fn
