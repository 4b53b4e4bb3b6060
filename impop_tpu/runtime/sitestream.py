"""Host-side site-tile streaming: windows larger than device memory.

The device-side long-window path (parallel/longwindow.py) shards one
window's site axis over the mesh ``site`` axis, so a window can span the
whole slice's HBM.  This module removes the remaining ceiling: the site
axis is streamed through the device in fixed-size chunks fed from the
host, with the running state — pairwise difference/comparison counts
[N, N], the segregating-site count, and the allele-frequency spectrum —
accumulated in donated device buffers.  Per-chunk cost is O(N·Sc + N²)
device memory regardless of the window's total length, so a single
"window" can be an entire chromosome (the reference caps windows at
~10 kb, doc/how_pi.md:40; SURVEY.md §5 "long-context" names blockwise
accumulation over site tiles as the device equivalent).

Every accumulated quantity is an exact integer sum over disjoint site
chunks, so the result matches the one-shot computation on the concatenated
matrix exactly up to XLA's constant-division rewrite (1 ulp in the final
identity values; counts are bit-identical — tests/test_sitestream.py):

- diff/compared: per-site outer-product sums (stats/allele.pairwise_diff);
- S: each polymorphic column lives in exactly one chunk;
- AFS: each column contributes one histogram increment in its chunk.

Usage::

    acc = SiteStreamAccumulator(member, afs_max_n=n)
    for chunk in chunks:            # [N, Sc] int8 tiles, -1 = missing/pad
        acc.update(chunk)
    stats = acc.finalize(length, threshold)   # pi, S, D, sim, present, afs
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["SiteStreamAccumulator", "StreamedWindowStats"]


class StreamedWindowStats(NamedTuple):
    pi: jnp.ndarray        # pica2-grouped π (absolute, not per-site)
    pi_site: jnp.ndarray   # π / length
    s: jnp.ndarray         # segregating sites
    d: jnp.ndarray         # Tajima's D
    n: jnp.ndarray         # member count
    sim: jnp.ndarray       # [N, N] identity matrix
    present: jnp.ndarray   # [N, N] pair-has-data mask
    afs: jnp.ndarray       # [afs_max_n + 1] folded/unfolded histogram


@functools.partial(jax.jit, donate_argnums=(0,),
                   static_argnames=("num_alleles", "folded", "afs_max_n"))
def _step(state, geno, member, site_mask, site_weights,
          num_alleles: int, folded: bool, afs_max_n: int):
    from impop_tpu.stats.allele import (
        allele_frequency_spectrum,
        pairwise_diff,
        segregating_sites,
    )

    diff, comp, s_tot, afs = state
    d_c, c_c = pairwise_diff(geno, member, site_mask, num_alleles,
                             site_weights)
    s_c = segregating_sites(geno, member, site_mask)
    if afs_max_n > 0:
        afs = afs + allele_frequency_spectrum(geno, member, site_mask,
                                              afs_max_n, folded)
    # per-chunk matmul results are exact in f32 (values <= chunk_s * w_max);
    # the running totals accumulate in the state dtype — int32 for unit
    # weights so chromosome-scale sums stay exact past 2^24 (f32 would
    # silently round there), f32 when arbitrary site weights are in play
    return (diff + d_c.astype(diff.dtype), comp + c_c.astype(comp.dtype),
            s_tot + s_c, afs)


class SiteStreamAccumulator:
    """Streaming accumulator for one window's site axis.

    Args:
      member: [N] bool host array (fixed across chunks).
      chunk_s: device chunk width; incoming tiles are padded to a multiple
        of this so the update step compiles once (ragged tails are masked).
      num_alleles: allele-code alphabet size (2 = biallelic fast path).
      afs_max_n: spectrum histogram size (0 disables AFS accumulation).
      folded: minor-allele (True) vs derived-allele (False) spectrum.
      weighted: True if updates will carry per-site weights (column-mode
        identity).  Unweighted accumulators keep diff/compared in int32, so
        counts stay exact past the f32 2^24 ceiling (a whole-chromosome
        site axis can exceed 16.7M mutually-valid sites per pair); weighted
        ones accumulate f32 and are exact while Σ weights < 2^24 per pair.
    """

    def __init__(self, member: np.ndarray, chunk_s: int = 4096,
                 num_alleles: int = 2, afs_max_n: int = 0,
                 folded: bool = True, weighted: bool = False):
        member = np.asarray(member, bool)
        self.n_cap = member.shape[0]
        self.chunk_s = int(chunk_s)
        self.num_alleles = int(num_alleles)
        self.afs_max_n = int(afs_max_n)
        self.folded = bool(folded)
        self.weighted = bool(weighted)
        self._member = jax.device_put(member)
        acc_dtype = jnp.float32 if self.weighted else jnp.int32
        self._state = (
            jnp.zeros((self.n_cap, self.n_cap), acc_dtype),
            jnp.zeros((self.n_cap, self.n_cap), acc_dtype),
            jnp.zeros((), jnp.int32),
            jnp.zeros((max(self.afs_max_n, 0) + 1,), jnp.int32),
        )
        self._finalized = False

    def update(self, geno_chunk: np.ndarray,
               site_weights: Optional[np.ndarray] = None) -> None:
        """Fold one [N, Sc] int8 site chunk into the running state.

        ``Sc`` may be any length; the chunk is zero-padded (allele -1,
        masked) up to the next multiple of ``chunk_s`` so every update
        reuses one compiled program.
        """
        if self._finalized:
            raise RuntimeError("accumulator already finalized")
        if site_weights is not None and not self.weighted:
            raise ValueError(
                "site_weights passed to an unweighted accumulator; "
                "construct with weighted=True")
        g = np.asarray(geno_chunk, np.int8)
        if g.ndim != 2 or g.shape[0] != self.n_cap:
            raise ValueError(
                f"chunk must be [{self.n_cap}, Sc]; got {g.shape}")
        s = g.shape[1]
        cap = max(self.chunk_s,
                  ((s + self.chunk_s - 1) // self.chunk_s) * self.chunk_s)
        pad = np.full((self.n_cap, cap), -1, np.int8)
        pad[:, :s] = g
        smask = np.zeros(cap, bool)
        smask[:s] = True
        w = None
        if site_weights is not None:
            w = np.zeros(cap, np.float32)
            w[:s] = np.asarray(site_weights, np.float32)
        self._state = _step(
            self._state, jax.device_put(pad), self._member,
            jax.device_put(smask),
            None if w is None else jax.device_put(w),
            num_alleles=self.num_alleles, folded=self.folded,
            afs_max_n=self.afs_max_n,
        )

    def finalize(self, length: float, threshold: float,
                 pi_member: Optional[np.ndarray] = None
                 ) -> StreamedWindowStats:
        """Close the stream: identity matrix, grouped π, S, Tajima's D, AFS.

        Matches the one-shot pipeline (identity_from_alleles →
        pi_grouped → tajimas_d) bit-for-bit on the same data.

        ``pi_member`` (optional [N] bool) restricts the grouped-π membership
        (and hence n and Tajima's D) to a sample subset WITHOUT narrowing S
        or the accumulated counts — the reference's subset contract: S is
        counted over the whole window graph (run_tajd.sh:148) while the
        subset list only feeds impg similarity / pica2 (run_tajd.sh:160).
        """
        from impop_tpu.stats.pi import pi_grouped
        from impop_tpu.stats.tajima import tajimas_d

        self._finalized = True
        diff, comp, s_tot, afs = self._state
        member = self._member
        pim = (member if pi_member is None
               else jax.device_put(np.asarray(pi_member, bool)) & member)

        @jax.jit
        def _fin(diff, comp, s_tot, member, pim):
            diff = diff.astype(jnp.float32)
            comp = comp.astype(jnp.float32)
            present = (comp > 0) & member[:, None] & member[None, :]
            ln = jnp.float32(max(length, 1.0))
            sim = jnp.where(present, 1.0 - diff / ln, 0.0)
            eye = jnp.eye(member.shape[0], dtype=bool)
            sim = jnp.where(eye & member[:, None], 1.0, sim)
            present = present | (eye & member[:, None])
            res = pi_grouped(sim, present, pim, jnp.float32(threshold))
            pi_site = res.pi / ln
            d = tajimas_d(res.n, s_tot.astype(jnp.float32), pi_site)
            return res.pi, pi_site, d, res.n, sim, present

        pi, pi_site, d, n, sim, present = _fin(diff, comp, s_tot, member, pim)
        return StreamedWindowStats(pi, pi_site, s_tot, d, n, sim, present,
                                   afs)
