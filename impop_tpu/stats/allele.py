"""Statistics straight from haplotype-by-site allele matrices.

This is the device data path that subsumes the reference's external
native tools (SURVEY.md §2.2): where the reference shells out per window to

- ``impg similarity``  for an identity matrix (run_pica2_impg.sh:162-168),
- ``impg query | odgi | povu gfa2vcf | wc -l`` for the segregating-site
  count S (run_tajd.sh:126-148),

here a window is a dense [N, S] int matrix of allele codes (rows =
haplotypes, columns = variant sites; -1 = missing/pad) and everything
derives from it on-device:

- pairwise difference counts D[i,j] (→ identity matrix: 1 - D/L), as
  one-hot matmuls rather than pairwise sequence alignment;
- S as a fused column reduction (count of polymorphic sites);
- the allele-frequency spectrum as a bincount over per-site minor/derived
  allele counts (the capability of wip/op-afs.py, without its
  first-allele-only quirk — op-afs.py:40-44).

Biallelic (0/1) windows take a fast path: D = r_i + r_j - 2·X Xᵀ, a single
f32 matmul.  Multiallelic codes use Σ_a X_a X_aᵀ over one-hot slices.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = [
    "pairwise_diff",
    "pairwise_diff_biallelic",
    "identity_from_alleles",
    "identity_route",
    "pairwise_identity_f32",
    "pairwise_identity_int8",
    "segregating_sites",
    "allele_frequency_spectrum",
    "panel_afs",
    "AlleleWindowStats",
    "allele_window_stats",
]


def _site_valid(geno: jnp.ndarray, member: jnp.ndarray, site_mask: jnp.ndarray):
    """Validity of each (haplotype, site) cell: member row, active site,
    non-missing call (>= 0)."""
    return (geno >= 0) & member[:, None] & site_mask[None, :]


def pairwise_diff_biallelic(
    geno: jnp.ndarray,
    member: jnp.ndarray,
    site_mask: jnp.ndarray,
    site_weights: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Pairwise difference counts for 0/1 allele codes.

    Returns (diff [N, N] f32, compared [N, N] f32) where ``compared`` counts
    sites at which both haplotypes have valid calls — the denominator for
    identity.  d_ij over valid sites = Σ_s (x_is - x_js)² = r_i + r_j - 2XXᵀ
    restricted to mutually-valid sites, i.e.
    d = (X·VᵀX?)  computed as  XVᵀ·(V - X) + (V - X)·(XV)ᵀ with
    X = geno·valid (zeros at invalid), V = valid:
    diff = X(V-X)ᵀ + (V-X)Xᵀ  — two f32 matmuls.

    ``site_weights`` ([S] f32, optional) scales each site's contribution to
    ``diff`` — the column-mode identity contract (doc/how_stats.md): an
    indel of k bases carries weight k so differences count alignment
    COLUMNS rather than variant EVENTS.  ``compared`` stays unweighted (it
    is only a has-data mask denominator).  Counts stay exact in f32 as long
    as Σ weights < 2²⁴ per pair.
    """
    valid = _site_valid(geno, member, site_mask)
    v = valid.astype(jnp.float32)
    x = jnp.where(valid, geno, 0).astype(jnp.float32)
    xc = v - x  # complement within valid sites
    xw, xcw = x, xc
    if site_weights is not None:
        w = site_weights.astype(jnp.float32)[None, :]
        xw = x * w
        xcw = xc * w
    # HIGHEST on every dot: weighted operands carry indel base lengths
    # (not TF32- or bf16-exact), and on the GPU a DEFAULT (TF32) f32 dot
    # at long K aborts XLA's Triton GEMM emitter ("LLVM ERROR: Dimensions
    # must match", [64 x 512, 8192] windows on an H100).  This is the
    # reference route; the fast unit-weight route is the int8 z-Gram.
    prec = jax.lax.Precision.HIGHEST
    diff = (
        jnp.dot(xw, xc.T, preferred_element_type=jnp.float32,
                precision=prec)
        + jnp.dot(xcw, x.T, preferred_element_type=jnp.float32,
                  precision=prec)
    )
    compared = jnp.dot(v, v.T, preferred_element_type=jnp.float32,
                       precision=prec)
    return diff, compared


def pairwise_diff(
    geno: jnp.ndarray,
    member: jnp.ndarray,
    site_mask: jnp.ndarray,
    num_alleles: int = 2,
    site_weights: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Pairwise difference counts for general allele codes 0..num_alleles-1.

    match_ij = Σ_a (X==a)(X==a)ᵀ over valid sites; diff = compared - match.
    num_alleles is static (one matmul per allele value).  ``site_weights``
    as in :func:`pairwise_diff_biallelic`.
    """
    if num_alleles == 2:
        return pairwise_diff_biallelic(geno, member, site_mask, site_weights)
    valid = _site_valid(geno, member, site_mask)
    v = valid.astype(jnp.float32)
    # HIGHEST on every dot, as in pairwise_diff_biallelic
    prec = jax.lax.Precision.HIGHEST
    compared = jnp.dot(v, v.T, preferred_element_type=jnp.float32,
                       precision=prec)
    w = (site_weights.astype(jnp.float32)[None, :]
         if site_weights is not None else None)
    vw = v if w is None else v * w
    compared_w = (compared if w is None
                  else jnp.dot(vw, v.T, preferred_element_type=jnp.float32,
                               precision=prec))
    match = jnp.zeros_like(compared)
    for a in range(num_alleles):
        xa = (jnp.where(valid, geno, -1) == a).astype(jnp.float32)
        xaw = xa if w is None else xa * w
        match = match + jnp.dot(xaw, xa.T,
                                preferred_element_type=jnp.float32,
                                precision=prec)
    return compared_w - match, compared


def identity_route(platform: str, has_weights: bool) -> str:
    """Which formulation :func:`identity_from_alleles` runs for a
    biallelic tile on ``platform`` (``jax.default_backend()``).

    - ``"f32"``: :func:`pairwise_identity_f32` — the reference
      formulation, the only one for site weights (indel base lengths need
      f32 HIGHEST) and the one the CPU runs (XLA:CPU has no fast int8
      GEMM).
    - ``"int8"``: :func:`pairwise_identity_int8`, the z-Gram in int8 with
      int32 accumulation.

    Both give bit-identical sim/present (integer counts, exact in both).
    On an H100 the int8 z-Gram beat the f32 route 3x at the scan's
    [512, 128] x 320 windows and 19x at the long window's [512, 8192] x 64,
    and tied (short) or beat 2x (long) the same z-Gram in bf16, which was
    removed (PERF.md).
    """
    if has_weights or platform != "gpu":
        return "f32"
    return "int8"


def pairwise_identity_int8(geno, member, site_mask, length):
    """Identity from two int8 Grams of the z/v codes of a biallelic tile:
    z = +1 alt / -1 ref / 0 invalid, v = |z|, diff = (v·vᵀ − z·zᵀ)/2.

    The operands hold ±1/0 exactly and int32 accumulation is exact, so the
    result equals :func:`pairwise_identity_f32` bit for bit.
    """
    g2 = jnp.where(site_mask[None, :] & member[:, None], geno, jnp.int8(-1))
    v = (g2 >= 0).astype(jnp.int8)
    a = jnp.maximum(g2, 0).astype(jnp.int8)
    z = a + a - v
    dims = (((1,), (1,)), ((), ()))
    zz = jax.lax.dot_general(z, z, dims, preferred_element_type=jnp.int32)
    vv = jax.lax.dot_general(v, v, dims, preferred_element_type=jnp.int32)
    diff = (vv - zz).astype(jnp.float32) * 0.5
    present = (vv > 0) & member[:, None] & member[None, :]
    sim = jnp.where(present, 1.0 - diff / jnp.maximum(length, 1.0), 0.0)
    diag = jnp.eye(member.shape[0], dtype=bool) & member[:, None]
    return jnp.where(diag, 1.0, sim), present | diag


def pairwise_identity_f32(
    geno: jnp.ndarray,
    member: jnp.ndarray,
    site_mask: jnp.ndarray,
    length: jnp.ndarray,
    num_alleles: int = 2,
    site_weights: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Identity from the f32 :func:`pairwise_diff` counts — the reference
    formulation, and the only one for multiallelic codes and site
    weights."""
    diff, compared = pairwise_diff(geno, member, site_mask, num_alleles,
                                   site_weights)
    present = (compared > 0) & member[:, None] & member[None, :]
    sim = jnp.where(present, 1.0 - diff / jnp.maximum(length, 1.0), 0.0)
    diag = jnp.eye(member.shape[0], dtype=bool) & member[:, None]
    # present includes the member diagonal (a member row with ZERO valid
    # calls still presents its self-pair) so every route agrees bit for
    # bit on the degenerate zero-coverage-member case
    return jnp.where(diag, 1.0, sim), present | diag


def identity_from_alleles(
    geno: jnp.ndarray,
    member: jnp.ndarray,
    site_mask: jnp.ndarray,
    length: jnp.ndarray,
    num_alleles: int = 2,
    site_weights: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Estimated identity matrix 1 - diff/length + presence mask.

    ``length`` is the window length in bp (monomorphic sites carry no
    difference, so dividing the variant-site difference count by the full
    window length reproduces the identity scale of ``impg similarity``).
    Pairs with zero mutually-valid sites are marked absent.
    ``site_weights`` selects column-mode identity (doc/how_stats.md:
    "Identity definition and impg parity").  The formulation follows
    :func:`identity_route`.
    """
    if num_alleles == 2 and identity_route(
            jax.default_backend(), site_weights is not None) == "int8":
        return pairwise_identity_int8(geno, member, site_mask, length)
    return pairwise_identity_f32(geno, member, site_mask, length,
                                 num_alleles, site_weights)


def segregating_sites(
    geno: jnp.ndarray, member: jnp.ndarray, site_mask: jnp.ndarray
) -> jnp.ndarray:
    """S = number of polymorphic columns (>= 2 distinct valid alleles).

    The fused-reduction replacement for the reference's
    ``povu gfa2vcf | grep -v '^#' | wc -l`` pipeline (run_tajd.sh:148): a
    site segregates iff max valid allele != min valid allele.
    """
    valid = _site_valid(geno, member, site_mask)
    big = jnp.iinfo(jnp.int32).max
    g = geno.astype(jnp.int32)
    col_min = jnp.min(jnp.where(valid, g, big), axis=0)
    col_max = jnp.max(jnp.where(valid, g, -1), axis=0)
    any_valid = jnp.any(valid, axis=0)
    poly = any_valid & (col_max > col_min)
    return jnp.sum(poly.astype(jnp.int32))


def allele_frequency_spectrum(
    geno: jnp.ndarray,
    member: jnp.ndarray,
    site_mask: jnp.ndarray,
    max_n: int,
    folded: bool = True,
) -> jnp.ndarray:
    """Site-frequency spectrum over polymorphic sites.

    Returns counts[k] = number of polymorphic sites whose non-reference
    (or minor, if folded) allele count equals k, for k in [0, max_n].
    Biallelic semantics: allele 1 is the derived/alternate state.
    """
    valid = _site_valid(geno, member, site_mask)
    ones = jnp.sum(jnp.where(valid, geno, 0).astype(jnp.int32), axis=0)
    total = jnp.sum(valid.astype(jnp.int32), axis=0)
    poly = (ones > 0) & (ones < total)
    count = ones
    if folded:
        count = jnp.minimum(ones, total - ones)
    count = jnp.where(poly, count, 0)
    hist = (
        jnp.zeros(max_n + 1, dtype=jnp.int32)
        .at[jnp.clip(count, 0, max_n)]
        .add(poly.astype(jnp.int32))
    )
    return hist


def panel_afs(
    geno: jnp.ndarray,
    member: jnp.ndarray,
    site_mask: jnp.ndarray,
    panels: jnp.ndarray,
    max_n: int,
    folded: bool = True,
) -> jnp.ndarray:
    """Per-panel SFS for one window: [P, max_n + 1] histograms.

    The tile-native genome-wide spectrum the reference cannot produce
    (wip/op-afs.py:26-45 reads text tables per window); panel masks are
    ANDed with ``member``.  Merge across windows/shards with a plain sum
    (counts are additive) or ``psum`` over a mesh axis.
    """
    return jax.vmap(
        lambda p: allele_frequency_spectrum(
            geno, member & p, site_mask, max_n, folded
        )
    )(panels)


class AlleleWindowStats(NamedTuple):
    """The fused per-window bundle the scan runtime emits."""

    pi_direct: jnp.ndarray  # mean pairwise difference count (π, absolute)
    s: jnp.ndarray          # segregating sites
    n: jnp.ndarray          # valid haplotypes
    afs: jnp.ndarray        # folded SFS histogram


def allele_window_stats(
    geno: jnp.ndarray,
    member: jnp.ndarray,
    site_mask: jnp.ndarray,
    max_n: int,
    num_alleles: int = 2,
) -> AlleleWindowStats:
    """π (direct mean pairwise difference), S and the SFS in one fused pass."""
    diff, compared = pairwise_diff(geno, member, site_mask, num_alleles)
    n_cap = member.shape[0]
    offdiag = ~jnp.eye(n_cap, dtype=bool)
    pair_ok = (compared > 0) & offdiag
    total = jnp.sum(jnp.where(pair_ok, diff, 0.0)) * 0.5
    pairs = jnp.sum(pair_ok.astype(jnp.float32)) * 0.5
    pi = jnp.where(pairs > 0, total / jnp.maximum(pairs, 1.0), 0.0)
    s = segregating_sites(geno, member, site_mask)
    n = jnp.sum(member.astype(jnp.int32))
    afs = allele_frequency_spectrum(geno, member, site_mask, max_n)
    return AlleleWindowStats(pi, s, n, afs)
