"""Clustering kernels: union-find replacement + panel expansion."""
import jax
import jax.numpy as jnp
import numpy as np

import oracle
from helpers import random_sim_case, tile_of

from impop_tpu.io.panels import canonicalize_identifier, expand_population
from impop_tpu.stats.grouping import label_components

CAP = 128

label_components_jit = jax.jit(
    lambda adj, member: label_components(adj, member)
)


def test_label_components_matches_union_find(rng):
    for trial in range(4):
        n = int(rng.integers(5, 100))
        sim_dict, sm = random_sim_case(rng, n, missing_frac=0.5, round_digits=3,
                                       low=0.990, high=1.0)
        threshold = 0.995
        rows = [(a, b, v) for (a, b), v in sim_dict.items()]
        want_clusters = oracle.union_find_clusters(rows, sm.names, threshold)
        want_label = {}
        for c in want_clusters:
            seed = min(c)
            for m in c:
                want_label[m] = seed

        tile = tile_of(sm, capacity=CAP)
        # af.py links pairs with value >= threshold (af.py:38)
        adj = (tile.sim >= threshold) & tile.present
        got = np.asarray(label_components_jit(adj, tile.member))
        for i, name in enumerate(sm.names):
            assert sm.names[got[i]] == want_label[name], (trial, name)


def test_canonicalize_identifier():
    # semantics of h-fst.py:18-61
    assert canonicalize_identifier("HG00097_hap1_hprc_r2_v1.0.1") == "HG00097#1#"
    assert canonicalize_identifier("HG00097_hap2_hprc_r2_v1.0.1") == "HG00097#2#"
    assert canonicalize_identifier("HG01891_mat_hprc_r2_v1.0.1") == "HG01891#1#"
    assert canonicalize_identifier("HG01891_pat_hprc_r2_v1.0.1") == "HG01891#2#"
    assert canonicalize_identifier("HG00097") == "HG00097#"
    assert canonicalize_identifier("HG00097#1#") == "HG00097#1#"
    assert canonicalize_identifier("HG00097#1") == "HG00097#1#"
    assert canonicalize_identifier("") == ""
    assert canonicalize_identifier("# comment") == ""


def test_expand_population():
    seqs = [
        "HG00097#1#CM094061.1:100-200",
        "HG00097#2#CM094062.1:100-200",
        "HG00171#1#CM094063.1:100-200",
        "CHM13#0#chr1:100-200",
    ]
    matched, missing = expand_population(
        ["HG00097_hap1_hprc_r2_v1.0.1", "HG00171", "NA12878_hap1_hprc_r2_v1.0.1"],
        seqs,
    )
    assert matched == {"HG00097#1#CM094061.1:100-200",
                       "HG00171#1#CM094063.1:100-200"}
    assert missing == ["NA12878_hap1_hprc_r2_v1.0.1"]


def test_greedy_group_panels_at_production_cap_matches_oracle(rng):
    """greedy_group_panels at the scan's cap of 512 rows (466 haplotypes,
    5 HPRC-sized panels, t = 0.999) assigns every member its oracle
    group's seed row; padding rows and non-panel rows get the N sentinel."""
    from impop_tpu.stats.grouping import greedy_group_panels

    cap, n, s, length, t = 512, 466, 120, 5000.0, 0.999
    classes = rng.integers(0, 2, size=(9, s)).astype(np.int8)
    geno = classes[rng.integers(0, 9, size=n)]
    geno = np.where(rng.random((n, s)) < 0.002, 1 - geno, geno)
    diff = (geno[:, None, :] != geno[None, :, :]).sum(-1)
    sim = np.ones((cap, cap), np.float32)
    sim[:n, :n] = (np.float32(1.0) - diff.astype(np.float32)
                   / np.float32(length))
    present = np.zeros((cap, cap), bool)
    present[:n, :n] = True
    member = np.zeros(cap, bool)
    member[:n] = True
    sizes = (140, 88, 100, 60, 72)
    pmasks = np.zeros((len(sizes), cap), bool)
    edges = np.cumsum((0,) + sizes)
    for p in range(len(sizes)):
        pmasks[p, edges[p]:edges[p + 1]] = True

    gid = np.asarray(jax.jit(greedy_group_panels)(
        jnp.asarray(sim), jnp.asarray(present), jnp.asarray(member),
        jnp.asarray(pmasks), jnp.float32(t)))

    names = [f"h{i:04d}" for i in range(n)]
    sd = {(names[i], names[j]): float(sim[i, j])
          for i in range(n) for j in range(i + 1, n)}
    for p in range(len(sizes)):
        rows = list(range(edges[p], edges[p + 1]))
        want = np.full(cap, cap)
        for group in oracle.greedy_groups(sd, [names[i] for i in rows], t):
            for nm in group:
                want[names.index(nm)] = names.index(group[0])
        np.testing.assert_array_equal(gid[p], want, err_msg=f"panel {p}")
