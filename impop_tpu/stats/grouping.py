"""Allele-class grouping kernels.

The reference carries three distinct clustering semantics (SURVEY.md §3.5):

1. **Greedy single-link, one hop** (pica2.py:98-110): pop a seed, absorb all
   *remaining* elements whose similarity to the seed exceeds the threshold,
   repeat.  Seed order in the reference is Python-set pop order — not
   reproducible.  Our documented spec fixes the deterministic order to the
   sorted-identifier row order (rows of a SimTile are sorted by name), which
   makes the seed the lexicographic minimum of its group, and therefore equal
   to the group's representative (``groups[i][0]`` at pica2.py:128).

2. The same greedy grouping, but with a **first-found representative pair**
   between groups (hud.py:88-98) rather than seed-vs-seed similarity.
   Implemented in :func:`first_pair_winner`.

3. **Transitive union-find closure** (af.py:21-44), linking every pair with
   similarity >= threshold.  On the device this becomes log-depth
   reachability via boolean matrix squaring (:func:`label_components`) —
   connected components as O(log N) matmuls instead of a pointer-chasing
   loop.

All functions are single-window, fixed-shape, jit/vmap friendly.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "greedy_group",
    "group_sizes",
    "rep_weights",
    "first_pair_winner",
    "label_components",
]


def greedy_group(
    sim: jnp.ndarray,
    present: jnp.ndarray,
    member: jnp.ndarray,
    threshold: float | jnp.ndarray,
) -> jnp.ndarray:
    """Greedy one-hop grouping (pica2 semantics, deterministic seed order).

    Semantics (pica2.py:98-110 with sorted seed order): process rows in
    ascending index; an unabsorbed row becomes a seed and absorbs every
    still-unabsorbed later row whose similarity to it exceeds the threshold
    (strict >, pica2.py:106).  Equivalently:

      seed(i)  ⟺  no seed j < i with link(j, i)
      gid(i)   =   i if seed(i) else min{ seed j < i : link(j, i) }

    The seed set is the order-first covering set — inherently sequential in
    the worst case, but computable by *frontier peeling*: each round decides
    every row whose earlier linked neighbours are all decided (the smallest
    undecided row always qualifies, so progress is guaranteed).  Rounds =
    link-graph dependency depth, which for identity matrices thresholded
    near 1.0 is the cluster-chain length (2-4 in practice, N worst case) —
    replacing an N-step sequential loop with a handful of [N, N] vector
    rounds; the final gid is a closed-form masked argmin.

    Args:
      sim:     [N, N] f32 symmetric similarities (already decimal-rounded)
      present: [N, N] bool pair-has-data mask
      member:  [N] bool row validity
      threshold: scalar

    Returns:
      gid [N] int32 — for members, the row index of the group's seed
      (== lexicographic min member == the reference's representative,
      pica2.py:128); N (an out-of-range sentinel) for padding rows.
    """
    n_cap = member.shape[0]
    link = (sim > threshold) & present & member[None, :] & member[:, None]
    order = jnp.arange(n_cap, dtype=jnp.int32)
    # elink[j, i]: j < i and linked — the "earlier neighbour" relation
    elink = link & (order[:, None] < order[None, :])

    # the peeling rounds only need "∃ earlier neighbour j with flag[j]",
    # which is a mask-vector product — express it as a matvec instead
    # of an [N, N] elementwise AND + reduction per round
    elink_f = elink.astype(jnp.float32)

    def any_earlier(flag):
        hits = jax.lax.dot_general(
            flag.astype(jnp.float32), elink_f,
            dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        return hits > 0.5

    def cond(state):
        decided, _ = state
        return jnp.any(member & ~decided)

    def body(state):
        decided, seed = state
        blocked = any_earlier(~decided)
        frontier = member & ~decided & ~blocked
        absorbed = any_earlier(decided & seed)
        new_seed = frontier & ~absorbed
        # rows absorbed by a known seed are decided immediately — a clique
        # resolves in 2 rounds instead of |clique| rounds
        return decided | frontier | (member & absorbed), seed | new_seed

    decided0 = ~member
    seed0 = jnp.zeros(n_cap, dtype=bool)
    _, seed = jax.lax.while_loop(cond, body, (decided0, seed0))

    # gid(i) = min seed j < i with link(j, i); i itself if seed; N if padding
    cand = elink & seed[:, None]  # [j, i] — earlier linked seeds
    min_seed = jnp.min(
        jnp.where(cand, order[:, None], n_cap), axis=0
    ).astype(jnp.int32)
    gid = jnp.where(seed, order, min_seed)
    return jnp.where(member, gid, n_cap)


def greedy_group_panels(
    sim: jnp.ndarray,
    present: jnp.ndarray,
    member: jnp.ndarray,
    pmasks: jnp.ndarray,
    threshold: float | jnp.ndarray,
    block: int = 64,
) -> jnp.ndarray:
    """:func:`greedy_group` for P panel masks sharing one window's matrix.

    Identical semantics per panel to ``greedy_group(sim, present,
    member & pmasks[p], threshold)``, but the [N, N] link structure is built
    ONCE and shared: panel masking happens in the [P, N] flag space, so the
    peeling rounds are [P, N] @ [N, N] matmuls and the final seed argmin uses
    a two-level block decomposition — nothing of shape [P, N, N] is ever
    materialised.  This is the HBM-bandwidth-critical path of the whole
    engine (every π/Fst estimator groups 5-15 panels per window).

    Args:
      pmasks: [P, N] bool panel masks (ANDed with member)
    Returns:
      gid [P, N] int32 (seed row per member, N sentinel elsewhere)
    """
    n_cap = member.shape[0]
    p_count = pmasks.shape[0]
    order = jnp.arange(n_cap, dtype=jnp.int32)
    link = (sim > threshold) & present & member[None, :] & member[:, None]
    elink = link & (order[:, None] < order[None, :])   # [j, i], j earlier
    elink_f = elink.astype(jnp.float32)

    pm = pmasks & member[None, :]                      # [P, N]

    # --- seed determination: chunked scan over row order ------------------
    # The seed recurrence s_i = ¬∃ seed j<i with link(j,i) has sequential
    # depth up to the link-graph chain length (can be ~N on real data, so a
    # global converge-until-done peel is unbounded over expensive [P,N]@[N,N]
    # rounds).  Instead: fixed N/K chunks in row order; absorption *from
    # earlier chunks* is one [P,N]·[N,K] matvec against the seeds found so
    # far (elink is strictly lower-triangular, so not-yet-decided later rows
    # contribute nothing), and the K in-chunk dependencies resolve by
    # frontier peeling on [P,K] flags with [K,K] operands: each round
    # decides every row whose earlier in-chunk neighbours are all decided.
    # Rounds = in-chunk dependency depth (2-4 on identity data, K worst
    # case), and each round costs two tiny [P,K]@[K,K] matmuls — replacing a
    # statically-unrolled K-step scalar micro-loop that was latency-bound.
    if n_cap % block != 0:
        # small/odd capacities (tests, dryruns) fall back to the largest
        # common divisor — correctness is block-size independent
        import math

        block = math.gcd(n_cap, block)
    n_chunks = n_cap // block

    def chunk_body(c, seeds):
        seeds_f = (seeds & pm).astype(jnp.float32)
        cols = jax.lax.dynamic_slice(
            elink_f, (0, c * block), (n_cap, block)
        )  # [N, K] — earlier-row links into this chunk
        absorbed_ext = jax.lax.dot_general(
            seeds_f, cols, dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        ) > 0.5                                        # [P, K]
        in_chunk_f = jax.lax.dynamic_slice(
            elink_f, (c * block, c * block), (block, block)
        )                                              # [K, K] f32, r < r'
        pm_c = jax.lax.dynamic_slice(pm, (0, c * block), (p_count, block))

        def any_in_chunk(flag):  # [P,K] bool -> [P,K]: ∃ earlier j, flag[j]
            return jax.lax.dot_general(
                flag.astype(jnp.float32), in_chunk_f,
                dimension_numbers=(((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            ) > 0.5

        def peel_cond(state):
            decided, _ = state
            return jnp.any(pm_c & ~decided)

        def peel_body(state):
            decided, seed_c = state
            blocked = any_in_chunk(pm_c & ~decided)
            frontier = pm_c & ~decided & ~blocked
            absorbed = absorbed_ext | any_in_chunk(seed_c)
            new_seed = frontier & ~absorbed
            # rows absorbed by a known seed decide immediately (clique ->
            # 2 rounds, not |clique|)
            return decided | frontier | (pm_c & absorbed), seed_c | new_seed

        _, seed_c = jax.lax.while_loop(
            peel_cond, peel_body,
            (~pm_c, jnp.zeros_like(pm_c)),
        )
        return jax.lax.dynamic_update_slice(seeds, seed_c, (0, c * block))

    seed = jax.lax.fori_loop(
        0, n_chunks, chunk_body, jnp.zeros_like(pm)
    )
    return _gid_from_seeds(seed, elink_f, pm, order, n_cap)


def _gid_from_seeds(seed, elink_f, pm, order, n_cap):
    """gid[p, i] = min{ seed j < i : elink[j, i] }; i if seed; N sentinel.

    Argmin of {j < i : seed_p[j] & elink[j, i]} without [P, N, N]:
    bit-weight trick — split rows into blocks of Kb=16 and give in-block
    position k the weight 2^(Kb-1-k).  One einsum then yields
    s[p,b,i] = sum_k seed*elink*2^(Kb-1-k); the smallest candidate k in the
    block is Kb-1-floor(log2 s), and floor(log2 s) is EXACT — s is an
    integer < 2^16 < 2^24, so it's the f32 exponent field, read with a
    bitcast.  No [P,N,K] gathers: elementwise work + one matmul.  The
    einsum's operands are 0/1 links and powers of two <= 2^15 with f32
    accumulation, so it stays exact under TF32 or bf16 operand rounding.
    """
    p_count = pm.shape[0]
    kb = 16
    nb = n_cap // kb
    # host-side exact powers of two (jnp.exp2 is approximate — 2^15 came
    # out 32767.984, breaking the exponent-field readback)
    weights = jnp.asarray(
        np.exp2(np.arange(kb - 1, -1, -1, dtype=np.float64)), jnp.float32
    )                                                    # [Kb] 2^(Kb-1-k)
    dtype = elink_f.dtype
    wseed = (
        seed.reshape(p_count, nb, kb).astype(dtype)
        * weights[None, None, :].astype(dtype)
    )                                                    # [P, B, Kb]
    eb = elink_f.reshape(nb, kb, n_cap)                  # [B, Kb, N]
    s_bits = jnp.einsum(
        "pbk,bkn->pbn", wseed, eb, preferred_element_type=jnp.float32,
    )                                                    # [P, B, N]
    expo = (
        jax.lax.bitcast_convert_type(s_bits, jnp.int32) >> 23
    ) - 127                                              # floor(log2 s), exact
    block_ids = jnp.arange(nb, dtype=jnp.int32)
    cand_gid = jnp.where(
        s_bits > 0,
        block_ids[None, :, None] * kb + (kb - 1 - expo),
        n_cap,
    )                                                    # [P, B, N]
    min_seed = jnp.min(cand_gid, axis=1).astype(jnp.int32)  # [P, N]

    gid = jnp.where(seed, order[None, :], min_seed)
    return jnp.where(pm, gid, n_cap)


def group_sizes(gid: jnp.ndarray, member: jnp.ndarray) -> jnp.ndarray:
    """sizes[s] = number of members whose group seed is row s (0 elsewhere).

    Scatter-free histogram: factor the bucket id as s = b·Kb + k and count
    with one [Nb, N] @ [N, Kb] matmul of the two one-hot factors instead
    of a serialising ``.at[gid].add`` scatter.
    The n_cap sentinel used for padding rows lands in bucket n_cap, which
    the final slice drops (and members always carry in-range gids).
    """
    n_cap = gid.shape[0]
    kb = 16
    nb = -(-(n_cap + 1) // kb)  # cover the n_cap sentinel bucket
    gb = gid // kb                                       # [N]
    gk = gid % kb
    ohb = (
        (gb[:, None] == jnp.arange(nb, dtype=gid.dtype)[None, :]) & member[:, None]
    ).astype(jnp.float32)                                # [N, Nb]
    ohk = (
        gk[:, None] == jnp.arange(kb, dtype=gid.dtype)[None, :]
    ).astype(jnp.float32)                                # [N, Kb]
    sizes_bk = jax.lax.dot_general(
        ohb, ohk, dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )                                                    # [Nb, Kb]
    return sizes_bk.reshape(nb * kb)[:n_cap].astype(jnp.int32)


def rep_weights(gid: jnp.ndarray, member: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-row group-frequency weights concentrated on representatives.

    Returns (w [N] f32, n scalar f32) where w[s] = |group(s)| / n for each
    seed row s and 0 elsewhere.  The frequency-weighted pairwise sum
    Σ_{a<b} 2 (1-sim_ab) f_a f_b over group representatives then becomes the
    quadratic form wᵀ((1-sim)⊙mask)w — the matmul formulation of pica2.py:125-145.
    """
    sizes = group_sizes(gid, member)
    n = jnp.sum(member.astype(jnp.float32))
    is_rep = sizes > 0
    w = jnp.where(is_rep, sizes.astype(jnp.float32) / jnp.maximum(n, 1.0), 0.0)
    return w, n


def first_pair_winner(
    present: jnp.ndarray,
    member_row: jnp.ndarray,
    gid_row: jnp.ndarray,
    gid_col: jnp.ndarray,
    member_col: jnp.ndarray | None = None,
    ordered: bool = False,
) -> jnp.ndarray:
    """Select hud.py's "first found" representative element pair per group pair.

    get_group_similarity (hud.py:88-98) scans group1's sorted members, then
    group2's, and takes the first pair present in the similarity dict.  With
    rows in sorted-name order that winner is the element pair (i, j)
    minimising (rank of i in its group, rank of j in its group)
    lexicographically among present pairs.

    Args:
      present: [N, N] pair-has-data mask
      member_row: [N] bool — row-side validity (e.g. population A members)
      gid_row: [N] group ids for the row side
      gid_col: [N] group ids for the column side (same array for within-set
               use; population-B groups for the cross-population Dxy case)
      member_col: [N] bool — column-side validity (defaults to member_row)
      ordered: if False, restrict to gid_row < gid_col (unordered group pairs
               in group-sorted order, matching ``groups[i], groups[j], i<j``);
               if True, keep all ordered pairs with gid_row != gid_col
               (cross-population case where the two group labelings are
               disjoint row-index sets).

    Returns:
      winner [N, N] bool — True at exactly one (i, j) per group pair that has
      any present pair.
    """
    if member_col is None:
        member_col = member_row
    n_cap = member_row.shape[0]
    order = jnp.arange(n_cap, dtype=jnp.int32)

    valid = present & member_row[:, None] & member_col[None, :]
    if ordered:
        valid = valid & (gid_row[:, None] != gid_col[None, :])
    else:
        valid = valid & (gid_row[:, None] < gid_col[None, :])

    # hud.py scans group members in sorted-name (== row-index) order, so the
    # winner is: the first row i in its group with ANY valid column in the
    # target column-group, paired with that row's first valid column j in
    # the group.  Both "first" predicates are "no earlier same-group element
    # with the property" counts — three [N, N] matmuls (the
    # previous formulation scatter-minned an (N+1)²-bucket segment table,
    # 2.6M serialised bucket updates per window at N=512).
    validf = valid.astype(jnp.float32)
    # any_valid[i, g]: row i has a valid partner in column-group g
    oh_col = (
        (gid_col[:, None] == order[None, :]) & member_col[:, None]
    ).astype(jnp.float32)                                    # [j, g]
    any_valid = jax.lax.dot_general(
        validf, oh_col, dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    ) > 0.5                                                  # [i, g]
    # blocked_row[i, g]: an earlier same-row-group row also reaches g
    earlier = order[:, None] < order[None, :]                # [i', i]
    er_f = (
        (gid_row[:, None] == gid_row[None, :]) & earlier
        & member_row[:, None] & member_row[None, :]
    ).astype(jnp.float32)                                    # [i', i]
    blocked_row = jax.lax.dot_general(
        er_f, any_valid.astype(jnp.float32),
        dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    ) > 0.5                                                  # [i, g]
    row_first = any_valid & ~blocked_row                     # [i, g]
    # col_first[i, j]: no earlier same-column-group j' valid for row i
    ec_f = (
        (gid_col[:, None] == gid_col[None, :]) & earlier
        & member_col[:, None] & member_col[None, :]
    ).astype(jnp.float32)                                    # [j', j]
    col_counts = jax.lax.dot_general(
        validf, ec_f, dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )                                                        # [i, j]
    col_first = valid & (col_counts < 0.5)
    # expand row_first to [i, j] through each column's group id
    row_first_ij = jnp.take(
        row_first, jnp.clip(gid_col, 0, n_cap - 1), axis=1
    )
    return col_first & row_first_ij


@partial(jax.jit, static_argnames=("num_iters",))
def label_components(
    adjacency: jnp.ndarray, member: jnp.ndarray, num_iters: int | None = None
) -> jnp.ndarray:
    """Connected-component labels via boolean matrix squaring.

    Matmul replacement for af.py's union-find (af.py:21-33): reachability
    R = (A | I)^(2^k) computed with ⌈log2 N⌉ f32 matmuls, then each
    node's label is the smallest reachable row index.  Exactly the transitive
    closure the reference's union-find produces.

    Args:
      adjacency: [N, N] bool, symmetric link matrix (e.g. sim >= threshold)
      member:    [N] bool row validity
    Returns:
      label [N] int32 — min reachable member index; N for padding rows.
    """
    n_cap = member.shape[0]
    if num_iters is None:
        num_iters = max(1, (n_cap - 1).bit_length())
    eye = jnp.eye(n_cap, dtype=bool)
    reach = (adjacency | eye) & member[:, None] & member[None, :]

    def body(_, r):
        rf = r.astype(jnp.float32)
        r2 = jnp.dot(rf, rf, preferred_element_type=jnp.float32) > 0.5
        return r2 | r

    reach = jax.lax.fori_loop(0, num_iters, body, reach)
    order = jnp.arange(n_cap, dtype=jnp.int32)
    label = jnp.min(jnp.where(reach, order[None, :], n_cap), axis=1)
    return jnp.where(member, label, n_cap)
