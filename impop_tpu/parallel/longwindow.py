"""Site-sharded statistics for long windows — explicit-collective path.

The reference cannot process windows longer than ~10 kb (impg similarity
constraint, doc/how_pi.md:40); chromosome scale means thousands of small
windows.  Here the site axis of an allele tile is itself sharded over the
mesh ``site`` axis: each device computes partial pairwise-difference matrices
/ segregating-site counts / AFS bins over its site slice and the partials
merge with ``psum`` over the interconnect — so a single window can span
the memory of the whole mesh.  This is the blockwise-accumulation design from SURVEY.md §5
(long-context equivalent).

Implemented with shard_map so the collective structure is explicit and
testable; the GSPMD path in parallel/scan.py covers the window-parallel case.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from impop_tpu.stats.allele import pairwise_diff_biallelic, segregating_sites
from impop_tpu.stats.pi import pi_grouped
from impop_tpu.stats.tajima import tajimas_d

__all__ = ["site_sharded_window_stats"]


def site_sharded_window_stats(mesh: Mesh, max_n: int):
    """Build a jitted [W, N, S] → per-window (π_grouped, S, D) function with
    W sharded over ``data`` and S sharded over ``site``.

    Returns a function f(geno, member, site_mask, lengths, threshold) whose
    collective pattern is: two matmul partials + psum('site') for the
    pairwise difference/comparison counts, a fused local reduction +
    psum('site') for S, then replicated per-shard grouping/π/D (cheap O(N²)).
    """

    def local_stats(geno, member, site_mask, lengths, threshold):
        # geno: [W/data, N, S/site]; member: [W/data, N]; site_mask: [W/data, S/site]
        def one(g, m, s, length):
            diff, comp = pairwise_diff_biallelic(g, m, s)
            s_local = segregating_sites(g, m, s)
            return diff, comp, s_local

        diff, comp, s_local = jax.vmap(one, in_axes=(0, 0, 0, 0))(
            geno, member, site_mask, lengths
        )
        diff = jax.lax.psum(diff, "site")
        comp = jax.lax.psum(comp, "site")
        s_count = jax.lax.psum(s_local, "site")

        def finish(diff1, comp1, m, length, s1):
            present = (comp1 > 0) & m[:, None] & m[None, :]
            sim = jnp.where(present, 1.0 - diff1 / jnp.maximum(length, 1.0), 0.0)
            eye = jnp.eye(m.shape[0], dtype=bool)
            sim = jnp.where(eye & m[:, None], 1.0, sim)
            res = pi_grouped(sim, present, m, threshold)
            pi_site = res.pi / jnp.maximum(length, 1.0)
            d = tajimas_d(res.n, s1.astype(jnp.float32), pi_site)
            return pi_site, d

        pi_site, d = jax.vmap(finish)(diff, comp, member, lengths, s_count)
        return pi_site, s_count, d

    mapped = shard_map(
        local_stats,
        mesh=mesh,
        in_specs=(
            P("data", None, "site"),
            P("data", None),
            P("data", "site"),
            P("data"),
            P(),
        ),
        out_specs=(P("data"), P("data"), P("data")),
        check_vma=False,
    )
    return jax.jit(mapped)
