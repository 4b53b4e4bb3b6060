"""Fused masked panel reductions over one window matrix.

Every per-panel/per-pair statistic in the fused scan is a row of one of two
stacked matmuls against elementwise transforms of the window's similarity
matrix (SURVEY.md §3.5's (1-s)·f_i·f_j terms and h-fst.py:130-171's masked
means):

    Yd = Wd @ ((1 - sim) ⊙ mask)      "difference" sums
    Yp = Wp @ mask                    pair counts / presence sums
    mask = present ∧ offdiagonal

π quadratic forms, group-pair presence counts, and all Hudson Fst
within/cross sums are rows of Wd/Wp — one call serves every panel and panel
pair of a window.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["masked_pair_sums_xla"]


def masked_pair_sums_xla(sim, present, wd, wp):
    """(Yd, Yp) = (wd @ ((1-sim)⊙mask), wp @ mask), mask = present ∧ offdiag.

    Args:
      sim:     [N, N] f32
      present: [N, N] bool
      wd, wp:  [R, N] f32 stacked row weights
    Returns:
      (yd [R, N] f32, yp [R, N] f32)
    """
    n_cap = sim.shape[0]
    mask = present & ~jnp.eye(n_cap, dtype=bool)
    div = jnp.where(mask, 1.0 - sim, 0.0)
    maskf = mask.astype(jnp.float32)

    def mm(x, m):
        # HIGHEST: the operands carry real f32 values ((1-sim) ~1e-3,
        # frequency weights); a DEFAULT f32 dot may run as TF32 on the GPU
        # (or single-pass bf16 elsewhere), ~1e-3 relative error in π/Fst
        return jax.lax.dot_general(
            x, m, dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )

    return mm(wd, div), mm(wp, maskf)
