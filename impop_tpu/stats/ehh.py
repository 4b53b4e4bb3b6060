"""Extended Haplotype Homozygosity (EHH).

The reference prototypes (wip/ehh2.py:72-86, wip/ehhgfa.py:6-21) compute
EHH(i) = (# haplotype pairs identical on sites 0..i) / C(n, 2) with a triple
Python loop re-comparing whole prefixes at every site — O(S²·n²).

Device formulation, two tiers:

- CURVES (ehh_forward): one lax.scan over the site axis carrying the
  [N, N] boolean "still identical" pair matrix; per step an elementwise
  AND with the current site's equality matrix and a masked pair-count
  reduction — O(S·n²) fused vector work, no prefix recomparison.
- AREAS (ehh_pair_death / ehh_area_batch): no scan at all.  The area
  under the decay curve is Σ_i EHH(i) = Σ_pairs death(pair)/C(n,2),
  where death = the first disagreeing active site — and death comes
  straight from matmuls: per 16-site block, the bit-weighted XOR sum
  D = (x·W)(1−x)ᵀ + ((1−x)·W)xᵀ is an exact integer < 2¹⁶ whose f32
  EXPONENT field reads back the first set bit (the same trick as
  stats/grouping's argmin).  Instead of S sequential scan steps this is
  a handful of small Grams plus [N, N] elementwise mins.  The operands
  are 0/1 indicators and powers of two <= 2^15 with f32 accumulation, so
  the sums stay exact when a DEFAULT-precision f32 dot runs as TF32.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "ehh_forward",
    "ehh_bidirectional",
    "ehh_decay_from_focal",
    "ehh_pair_death",
    "ehh_area_batch",
    "ehh_area_dynamic",
    "EhhResult",
]


def _pair_mask(member: jnp.ndarray) -> jnp.ndarray:
    n_cap = member.shape[0]
    upper = jnp.triu(jnp.ones((n_cap, n_cap), dtype=bool), k=1)
    return upper & member[:, None] & member[None, :]


def ehh_forward(
    geno: jnp.ndarray, member: jnp.ndarray, site_mask: jnp.ndarray
) -> jnp.ndarray:
    """EHH over growing prefixes [0..i] for each site i.

    Matches wip/ehh2.py:72-86: pairs must agree on *every* site of the
    prefix; the result at site i is the agreeing-pair fraction.  Sites with
    site_mask False are ignored (treated as agreeing).  Returns [S] f32.
    """
    pairs = _pair_mask(member)
    n = jnp.sum(member.astype(jnp.float32))
    denom = jnp.maximum(n * (n - 1.0) * 0.5, 1.0)

    def step(alive, inputs):
        col, active = inputs
        eq = col[:, None] == col[None, :]
        alive = alive & (eq | ~active)
        frac = jnp.sum((alive & pairs).astype(jnp.float32)) / denom
        return alive, frac

    alive0 = jnp.ones_like(pairs)
    _, fracs = jax.lax.scan(step, alive0, (geno.T, site_mask))
    return fracs


def ehh_bidirectional(
    geno: jnp.ndarray, member: jnp.ndarray, site_mask: jnp.ndarray
) -> jnp.ndarray:
    """[reversed EHH of the flipped matrix, forward EHH] — the concatenation
    the reference prints (wip/ehh2.py:93-95).  Returns [2S] f32."""
    fwd = ehh_forward(geno, member, site_mask)
    rev = ehh_forward(geno[:, ::-1], member, site_mask[::-1])
    return jnp.concatenate([rev[::-1], fwd])


def ehh_pair_death(geno: jnp.ndarray, site_mask: jnp.ndarray) -> jnp.ndarray:
    """First active disagreeing site per haplotype pair; S if they agree
    on every active site.  Returns [N, N] int32.

    ``geno`` must be BINARISED 0/1 (the ehh_area_batch contract, matching
    the reference's binarisation — ehhgfa.py:12-14); masked sites agree.
    Per 16-site block the bit-weighted XOR sum is exact in f32 even when
    a DEFAULT-precision dot rounds its operands to TF32 or bf16 (operands
    are powers of two and 0/1 indicators), and its exponent field IS the
    first disagreeing position.
    """
    n, s = geno.shape
    if s == 0:
        return jnp.zeros((n, n), jnp.int32)
    kb = 16
    s_pad = ((s + kb - 1) // kb) * kb
    x = jnp.where(site_mask, geno, 0).astype(jnp.float32)
    x = jnp.pad(x, ((0, 0), (0, s_pad - s)))
    # exact powers of two (host-side: jnp.exp2 is approximate)
    w16 = jnp.asarray(np.exp2(np.arange(kb - 1, -1, -1, dtype=np.float64)),
                      jnp.float32)[None, :]
    death = jnp.full((n, n), s, jnp.int32)
    for b in range(s_pad // kb):
        xb = x[:, b * kb:(b + 1) * kb]
        cb = 1.0 - xb
        d_bits = (
            jnp.dot(xb * w16, cb.T, preferred_element_type=jnp.float32)
            + jnp.dot(cb * w16, xb.T, preferred_element_type=jnp.float32)
        )
        expo = (jax.lax.bitcast_convert_type(d_bits, jnp.int32) >> 23) - 127
        fd = jnp.where(d_bits > 0, (kb - 1) - expo + b * kb, s)
        death = jnp.minimum(death, fd)
    return death


def ehh_area_dynamic(
    geno: jnp.ndarray,
    member: jnp.ndarray,
    site_mask: jnp.ndarray,
    focal_idx: jnp.ndarray,
    alleles=(0, 1),
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Bidirectional EHH decay areas with a TRACED focal column index —
    the fused-scan formulation (one compiled shape for every window even
    though each window's focal site differs).

    Semantics are ``ehh_area_batch(..., rank(focal), alleles)`` run on the
    window with its masked columns DROPPED (asserted by tests/test_ehh.py):
    ``geno`` is binarised 0/1, areas count ACTIVE site steps, carriers of
    allele ``a`` are members whose binarised call at the (raw) focal
    column is ``a``.  Counting only active steps makes the result
    independent of the tile's padding capacity — required by the fused
    scan, where the same window may be padded to different caps in
    different batches.  ``focal_idx`` must point at an ACTIVE column
    (the scan picks focals among real variant columns).

    Instead of slicing at the focal site (impossible with a traced
    index), the active columns are first COMPACTED to the left with one
    exact 0/1 permutation matmul (P[j, rank_j] = active_j), then the
    per-16-site-block bit-weighted XOR Grams run over the full compacted
    axis with the focal split applied as elementwise masks:

    - right: descending block weights; the f32 exponent field of the
      block sum reads back the FIRST disagreeing rank > rank(focal)
      (min over blocks); pair area = death − rank(focal) − 1.
    - left: ascending block weights; the exponent reads back the LAST
      disagreeing rank < rank(focal) (max over blocks) — which is the
      first site of the REVERSED prefix; pair area = rank(focal) − 1 −
      death.

    Returns (area [A] f32, carriers [A] int32) for one window; vmap for
    batches.
    """
    with jax.named_scope("ehh"):
        n, s = geno.shape
        kb = 16
        s_pad = ((s + kb - 1) // kb) * kb if s else kb
        iota_s = jnp.arange(s_pad, dtype=jnp.int32)
        fi_raw = jnp.asarray(focal_idx, jnp.int32)
        act_row = jnp.pad(site_mask, (0, s_pad - s)).astype(jnp.float32)
        # rank-compact the active columns (exact 0/1 matmul — no gathers)
        rank = (jnp.cumsum(act_row) - act_row).astype(jnp.int32)     # [S]
        n_act = jnp.sum(act_row).astype(jnp.int32)
        perm = jnp.where(
            (rank[:, None] == iota_s[None, :]) & (act_row[:, None] > 0),
            1.0, 0.0)                                                # [S, S]
        x_raw = jnp.where(site_mask, geno, 0).astype(jnp.float32)
        x_raw = jnp.pad(x_raw, ((0, 0), (0, s_pad - s)))
        xb = jnp.dot(x_raw, perm, preferred_element_type=jnp.float32)
        fi = jnp.sum(act_row * (iota_s < fi_raw).astype(jnp.float32)
                     ).astype(jnp.int32)                # focal in rank units
        active = (iota_s < n_act).astype(jnp.float32)[None, :]

        w_desc = jnp.asarray(
            np.exp2(np.arange(kb - 1, -1, -1, dtype=np.float64)),
            jnp.float32)[None, :]
        w_asc = jnp.asarray(np.exp2(np.arange(kb, dtype=np.float64)),
                            jnp.float32)[None, :]

        def deaths(dir_mask, weights, pick_first):
            """[N, N] absolute site index of the first (pick_first) or last
            active disagreeing site under dir_mask; sentinel s (first) /
            -1 (last)."""
            x = xb * dir_mask
            c = (1.0 - xb) * active * dir_mask
            best = jnp.full((n, n), s if pick_first else -1, jnp.int32)
            for b in range(s_pad // kb):
                sl = slice(b * kb, (b + 1) * kb)
                d_bits = (
                    jnp.dot(x[:, sl] * weights, c[:, sl].T,
                            preferred_element_type=jnp.float32)
                    + jnp.dot(c[:, sl] * weights, x[:, sl].T,
                              preferred_element_type=jnp.float32)
                )
                expo = (jax.lax.bitcast_convert_type(d_bits, jnp.int32)
                        >> 23) - 127
                if pick_first:
                    cand = jnp.where(d_bits > 0, (kb - 1) - expo + b * kb, s)
                    best = jnp.minimum(best, cand)
                else:
                    cand = jnp.where(d_bits > 0, expo + b * kb, -1)
                    best = jnp.maximum(best, cand)
            return best

        # carriers read the RAW focal column — ehh_area_batch applies no site
        # mask to the carrier selection (only the decay Grams mask sites)
        focal_oh = (jnp.arange(s, dtype=jnp.int32) == fi_raw
                    ).astype(jnp.float32)
        call = jnp.dot(geno.astype(jnp.float32), focal_oh,
                       preferred_element_type=jnp.float32)
        carriers = [member & (call == float(al)) for al in alleles]
        n_cs = [jnp.sum(c.astype(jnp.float32)) for c in carriers]
        denoms = [jnp.maximum(nc * (nc - 1.0) * 0.5, 1.0) for nc in n_cs]
        carr = jnp.stack([jnp.sum(c.astype(jnp.int32)) for c in carriers])

        right_mask = (iota_s > fi).astype(jnp.float32)[None, :]
        left_mask = (iota_s < fi).astype(jnp.float32)[None, :]
        death_r = deaths(right_mask, w_desc, True)       # first disagree > fi
        death_l = deaths(left_mask, w_asc, False)        # last disagree < fi

        # per-pair step counts (clamped at 0 so fi at the window edge and the
        # agree-all sentinels behave like ehh_area_batch's empty-suffix cases;
        # the right sentinel clamps to the ACTIVE count, not the padded cap)
        steps_r = jnp.maximum(
            jnp.minimum(death_r, n_act).astype(jnp.float32) - fi - 1.0, 0.0)
        steps_l = jnp.maximum(fi - 1.0 - death_l.astype(jnp.float32), 0.0)
        steps = steps_r + steps_l

        areas = []
        upper = jnp.triu(jnp.ones((n, n), dtype=bool), k=1)
        for ai, al in enumerate(alleles):
            pairs = upper & carriers[ai][:, None] & carriers[ai][None, :]
            rows = jnp.sum(jnp.where(pairs, steps, 0.0), axis=1)
            areas.append(jnp.sum(rows) / denoms[ai])
        return jnp.stack(areas), carr


class EhhResult(NamedTuple):
    ehh: jnp.ndarray   # [2*(S-1)] decay curve (left reversed ++ right)
    area: jnp.ndarray  # scalar — cumulative sum of the curve (ehhgfa.py:64)
    carriers: jnp.ndarray  # scalar — number of haplotypes carrying the allele


def ehh_decay_from_focal(
    geno: jnp.ndarray,
    member: jnp.ndarray,
    site_mask: jnp.ndarray,
    focal: int,
    allele: jnp.ndarray,
) -> EhhResult:
    """EHH decay away from a focal site for carriers of ``allele``.

    Reproduces wip/ehhgfa.py:47-69: restrict to haplotypes whose call at
    ``focal`` equals ``allele``, split the window at the focal site
    (exclusive), compute EHH right-ward on the suffix and left-ward on the
    reversed prefix, concatenate, and integrate via cumulative sum.

    ``focal`` is a static python int (site index in the window).
    """
    carriers = member & (geno[:, focal] == allele)
    s_total = geno.shape[1]
    left = geno[:, :focal][:, ::-1]
    left_mask = site_mask[:focal][::-1]
    right = geno[:, focal + 1:]
    right_mask = site_mask[focal + 1:]

    left_ehh = (
        ehh_forward(left, carriers, left_mask)
        if focal > 0
        else jnp.zeros((0,), dtype=jnp.float32)
    )
    right_ehh = (
        ehh_forward(right, carriers, right_mask)
        if focal + 1 < s_total
        else jnp.zeros((0,), dtype=jnp.float32)
    )
    curve = jnp.concatenate([left_ehh[::-1], right_ehh])
    area = jnp.sum(curve)
    return EhhResult(curve, area, jnp.sum(carriers.astype(jnp.int32)))


from functools import partial as _partial


@_partial(jax.jit, static_argnames=("focal", "compat_right_for_left"))
def ehh_area_batch(
    geno: jnp.ndarray,
    member: jnp.ndarray,
    site_mask: jnp.ndarray,
    focal: int,
    alleles: jnp.ndarray,
    compat_right_for_left: bool = False,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """EHH decay areas for every (window, focal allele) in ONE program.

    The windowed-scan driver of wip/ehhgfa.py:47-69, batched: carriers are
    selected with a boolean MASK (never a row slice), so every window and
    allele shares a single compiled shape — the per-(carriers, suffix)
    recompilation of a naive port is structurally impossible here.

    Args:
      geno:      [W, N, S] int8 binarised haplotype windows (pad cols with
                 anything and mask them off)
      member:    [W, N] bool (pad rows False)
      site_mask: [W, S] bool
      focal:     static focal site index within each window
      alleles:   [A] allele codes to evaluate at the focal site
      compat_right_for_left: reproduce the reference's use of the right
                 suffix for BOTH decay directions (ehhgfa.py:58-62)
    Returns:
      (area [W, A] f32, carriers [W, A] int32)
    """

    def one_window(g, m, sm):
        def per_allele(al):
            carriers = m & (g[:, focal] == al)
            n_c = jnp.sum(carriers.astype(jnp.float32))
            denom = jnp.maximum(n_c * (n_c - 1.0) * 0.5, 1.0)
            pairs = _pair_mask(carriers)

            def dir_area(sub_g, sub_sm):
                # area = Σ_i EHH(i) = Σ_pairs death(pair)/denom — the
                # death-site formulation replaces the per-site scan
                # (ehh_pair_death).  Per-ROW sums stay int32 (exact:
                # row sum ≤ N·S < 2³¹ for any realistic window); the
                # cross-row accumulation runs in f32 because the full
                # C(N,2)·S bound is user-controlled (--window) and wrapped
                # the old all-int32 sum at e.g. N=1024, S≳4100 (r4
                # advisor finding).
                death = ehh_pair_death(sub_g, sub_sm)
                rows = jnp.sum(jnp.where(pairs, death, 0), axis=1)
                total = jnp.sum(rows.astype(jnp.float32))
                return total / denom

            right_area = dir_area(g[:, focal + 1:], sm[focal + 1:])
            if compat_right_for_left:
                # the reference feeds the REVERSED right suffix to the left
                # branch (ehhgfa.py:58-62: `left = right` before the flip)
                left_area = dir_area(g[:, focal + 1:][:, ::-1],
                                     sm[focal + 1:][::-1])
            elif focal > 0:
                left_area = dir_area(g[:, :focal][:, ::-1],
                                     sm[:focal][::-1])
            else:
                left_area = jnp.float32(0.0)
            area = left_area + right_area
            return area, jnp.sum(carriers.astype(jnp.int32))

        return jax.vmap(per_allele)(alleles)

    return jax.vmap(one_window)(geno, member, site_mask)
