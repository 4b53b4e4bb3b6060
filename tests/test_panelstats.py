"""fused_panel_stats == pi_grouped_panels + hudson_fst_direct_pairs."""
import jax.numpy as jnp
import numpy as np

from impop_tpu.stats.fst import hudson_fst_direct_pairs
from impop_tpu.stats.panelstats import fused_panel_stats
from impop_tpu.stats.pi import pi_grouped_panels


def _window(rng, n=192, p=4):
    cls = rng.integers(0, 6, size=n)
    base = 0.99 + 0.01 * (cls[:, None] == cls[None, :])
    noise = rng.normal(0, 0.004, size=(n, n))
    sim = np.clip(base + (noise + noise.T) / 2, 0, 1).astype(np.float32)
    np.fill_diagonal(sim, 1.0)
    present = rng.random((n, n)) < 0.9
    present = present & present.T
    np.fill_diagonal(present, True)
    member = rng.random(n) < 0.9
    pmasks = rng.random((p, n)) < 0.6
    return (jnp.asarray(sim), jnp.asarray(present), jnp.asarray(member),
            jnp.asarray(pmasks))


def test_fused_matches_composed(rng):
    sim, present, member, pmasks = _window(rng)
    pair_a = jnp.asarray([0, 0, 1, 2], jnp.int32)
    pair_b = jnp.asarray([1, 2, 3, 3], jnp.int32)
    t = 0.995

    got = fused_panel_stats(sim, present, member, pmasks, pair_a, pair_b, t)

    unions = pmasks[pair_a] | pmasks[pair_b]
    all_masks = jnp.concatenate([pmasks, unions], axis=0)
    want_pi = pi_grouped_panels(sim, present, member, all_masks, t)
    np.testing.assert_allclose(np.asarray(got.pi), np.asarray(want_pi.pi),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(np.asarray(got.n), np.asarray(want_pi.n))
    np.testing.assert_array_equal(np.asarray(got.num_groups),
                                  np.asarray(want_pi.num_groups))
    np.testing.assert_array_equal(np.asarray(got.pairs_used),
                                  np.asarray(want_pi.pairs_used))

    mask_a = pmasks[pair_a] & member[None, :]
    mask_b = pmasks[pair_b] & member[None, :]
    ov = mask_a & mask_b
    want_fst = hudson_fst_direct_pairs(sim, present, mask_a & ~ov,
                                       mask_b & ~ov)
    for f in ("fst", "pi_a", "pi_b", "pi_xy", "dxy", "da"):
        np.testing.assert_allclose(
            np.asarray(getattr(got.hudson, f)),
            np.asarray(getattr(want_fst, f)), rtol=1e-6, atol=1e-9,
        )


def test_fused_grouped_hudson_matches_exact_on_complete_present(rng):
    """The fused seed-representative grouped Hudson == the exact first-pair
    path (stats/fst.hudson_fst_grouped_pairs) whenever every pair has data
    — the allele-derived-identity case the fused scan runs on."""
    import jax

    from impop_tpu.stats.fst import hudson_fst_grouped_pairs

    sim, present, member, pmasks = _window(rng)
    present = jnp.ones_like(present)  # complete pair matrix
    pair_a = jnp.asarray([0, 0, 1, 2], jnp.int32)
    pair_b = jnp.asarray([1, 2, 3, 3], jnp.int32)
    t = 0.995

    got = fused_panel_stats(sim, present, member, pmasks, pair_a, pair_b, t)
    mask_a = pmasks[pair_a] & member[None, :]
    mask_b = pmasks[pair_b] & member[None, :]
    ov = mask_a & mask_b
    want = jax.jit(hudson_fst_grouped_pairs)(
        sim, present, mask_a & ~ov, mask_b & ~ov, jnp.float32(t)
    )
    for f in ("pi_a", "pi_b", "dxy"):
        np.testing.assert_allclose(
            np.asarray(getattr(got.hudson_grouped, f)),
            np.asarray(getattr(want, f)), rtol=1e-5, atol=1e-8, err_msg=f,
        )
    np.testing.assert_allclose(
        np.asarray(got.hudson_grouped.fst), np.asarray(want.fst),
        rtol=2e-3, atol=1e-6,
    )


def test_pairs_disjoint_fast_path_equivalence(rng):
    """pairs_disjoint=True (panel-row reuse) == the general path on
    actually-disjoint panels."""
    sim, present, member, _ = _window(rng)
    n = member.shape[0]
    pmasks = np.zeros((4, n), bool)
    for pi in range(4):
        pmasks[pi, pi::4] = True          # partition: disjoint by design
    pmasks = jnp.asarray(pmasks)
    pair_a = jnp.asarray([0, 0, 1, 2], jnp.int32)
    pair_b = jnp.asarray([1, 2, 3, 3], jnp.int32)
    t = 0.995
    a = fused_panel_stats(sim, present, member, pmasks, pair_a, pair_b, t,
                          pairs_disjoint=False)
    b = fused_panel_stats(sim, present, member, pmasks, pair_a, pair_b, t,
                          pairs_disjoint=True)
    for group in ("hudson", "hudson_grouped"):
        for f in ("fst", "pi_a", "pi_b", "dxy"):
            np.testing.assert_allclose(
                np.asarray(getattr(getattr(a, group), f)),
                np.asarray(getattr(getattr(b, group), f)),
                rtol=1e-6, atol=1e-9, err_msg=f"{group}.{f}",
            )
    np.testing.assert_allclose(np.asarray(a.pi), np.asarray(b.pi),
                               rtol=1e-6, atol=1e-9)


def _allele_window(rng, n=256, s=128, frac_missing=0.05):
    cls = rng.integers(0, 6, size=n)
    base = rng.integers(0, 2, size=(6, s)).astype(np.int8)
    geno = base[cls]
    geno = np.where(rng.random((n, s)) < 0.01, 1 - geno, geno).astype(np.int8)
    geno[rng.random((n, s)) < frac_missing] = -1
    geno[-13:] = -1
    member = np.ones(n, bool)
    member[-13:] = False
    smask = np.ones(s, bool)
    smask[-9:] = False
    return geno, member, smask


def test_fused_window_stats_without_matrices_matches_with(rng):
    """return_matrices=False (the scan/bench hot path) drops sim/present
    and must give the same statistics and S as return_matrices=True."""
    from impop_tpu.stats.panelstats import fused_window_stats

    geno, member, smask = _allele_window(rng)
    pmasks = np.stack([member & (np.arange(256) % 2 == 0),
                       member & (np.arange(256) % 2 == 1)])
    a = fused_window_stats(jnp.asarray(geno), jnp.asarray(member),
                           jnp.asarray(smask), jnp.float32(5000.0),
                           jnp.asarray(pmasks), jnp.asarray((0,)),
                           jnp.asarray((1,)), jnp.float32(0.9995),
                           pairs_disjoint=True, return_matrices=False)
    b = fused_window_stats(jnp.asarray(geno), jnp.asarray(member),
                           jnp.asarray(smask), jnp.float32(5000.0),
                           jnp.asarray(pmasks), jnp.asarray((0,)),
                           jnp.asarray((1,)), jnp.float32(0.9995),
                           pairs_disjoint=True, return_matrices=True)
    assert a[0] is None and a[1] is None
    assert b[0].shape == (256, 256)
    np.testing.assert_allclose(np.asarray(a[3].pi), np.asarray(b[3].pi),
                               rtol=1e-6)
    assert float(a[2]) == float(b[2])


def test_seed_pair_invariant_guard_warns_on_missing_data(monkeypatch):
    """The seed-representative grouped-Hudson path is bit-identical to
    hud.py only while every group-seed pair has data (fused_panel_stats
    docstring).  The debug guard must warn when a source violates that —
    and stay silent when it holds."""
    import pytest

    from impop_tpu.stats import panelstats

    monkeypatch.setattr(panelstats, "DEBUG_SEED_INVARIANT", True)
    n = 16
    member = jnp.zeros(n, bool).at[:4].set(True)
    pmasks = jnp.zeros((2, n), bool).at[0, :2].set(True).at[1, 2:4].set(True)
    pair_a = jnp.asarray([0], jnp.int32)
    pair_b = jnp.asarray([1], jnp.int32)
    # low similarities -> every haplotype is its own group (its own seed)
    sim = jnp.full((n, n), 0.5, jnp.float32)
    sim = sim.at[jnp.arange(n), jnp.arange(n)].set(1.0)
    present_ok = jnp.ones((n, n), bool)

    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")  # silence required: any warning fails
        fused_panel_stats(sim, present_ok, member, pmasks, pair_a, pair_b,
                          jnp.float32(0.999), pairs_disjoint=True)

    # knock out the (seed 0, seed 2) cross pair
    present_bad = present_ok.at[0, 2].set(False).at[2, 0].set(False)
    with pytest.warns(RuntimeWarning, match="group-seed pair"):
        fused_panel_stats(sim, present_bad, member, pmasks, pair_a, pair_b,
                          jnp.float32(0.999), pairs_disjoint=True)
    # the non-disjoint variant must guard the stripped-side groupings too
    with pytest.warns(RuntimeWarning, match="group-seed pair"):
        fused_panel_stats(sim, present_bad, member, pmasks, pair_a, pair_b,
                          jnp.float32(0.999), pairs_disjoint=False)


def test_seed_risk_flag_and_exact_path_on_partial_coverage(rng):
    """Disjoint record coverage can erase the (seed_a, seed_b) pair while
    another cross pair still has data — hud.py's first-found-pair scan
    (hud.py:88-98) then uses the alternate pair, and the fused seed-
    representative FSTG deviates (VERDICT r3 weak #4).  The fused pass
    must raise `seed_risk` on such windows, and the exact path
    (hudson_fst_grouped_pairs) must match the oracle; clean coverage must
    NOT raise the flag."""
    import oracle

    from impop_tpu.stats.fst import hudson_fst_grouped_pairs

    # rows: a0 covers left sites only, a1 all; b0 right only, b1 all
    n = 16
    names = [f"h{i}" for i in range(4)]
    sim_np = np.zeros((n, n), np.float32)
    pres_np = np.zeros((n, n), bool)

    def setp(i, j, s):
        sim_np[i, j] = sim_np[j, i] = s
        pres_np[i, j] = pres_np[j, i] = True

    for i in range(4):
        sim_np[i, i] = 1.0
        pres_np[i, i] = True
    setp(0, 1, 0.9995)   # A group: seed 0 absorbs 1
    setp(2, 3, 0.9995)   # B group: seed 2 absorbs 3
    setp(0, 3, 0.9950)   # hud.py's representative for (gA, gB)
    setp(1, 2, 0.9940)
    setp(1, 3, 0.9930)
    # (0, 2) — the seed pair — has NO data (disjoint coverage)

    member = np.zeros(n, bool)
    member[:4] = True
    pmasks = np.zeros((2, n), bool)
    pmasks[0, :2] = True
    pmasks[1, 2:4] = True
    pair_a = jnp.asarray([0], jnp.int32)
    pair_b = jnp.asarray([1], jnp.int32)
    t = jnp.float32(0.999)

    res = fused_panel_stats(jnp.asarray(sim_np), jnp.asarray(pres_np),
                            jnp.asarray(member), jnp.asarray(pmasks),
                            pair_a, pair_b, t, pairs_disjoint=True)
    assert bool(res.seed_risk), "partial coverage must raise seed_risk"

    # the exact device path must equal the oracle's hud.py semantics
    sims = {}
    for i in range(4):
        for j in range(i + 1, 4):
            if pres_np[i, j]:
                sims[(names[i], names[j])] = float(sim_np[i, j])
    want = oracle.hudson_fst_grouped(sims, names[:2], names[2:4], 0.999)
    got = hudson_fst_grouped_pairs(
        jnp.asarray(sim_np), jnp.asarray(pres_np),
        jnp.asarray(pmasks[:1] & member[None, :]),
        jnp.asarray(pmasks[1:] & member[None, :]), t)
    np.testing.assert_allclose(float(got.fst[0]), want["fst"], rtol=1e-6)
    # and the fused seed-representative value indeed deviates here —
    # the flag is what makes the scan swap it out
    assert abs(float(res.hudson_grouped.fst[0]) - want["fst"]) > 1e-3

    # clean full coverage: no flag
    pres_ok = pres_np.copy()
    pres_ok[0, 2] = pres_ok[2, 0] = True
    sim_ok = sim_np.copy()
    sim_ok[0, 2] = sim_ok[2, 0] = 0.9950
    res_ok = fused_panel_stats(jnp.asarray(sim_ok), jnp.asarray(pres_ok),
                               jnp.asarray(member), jnp.asarray(pmasks),
                               pair_a, pair_b, t, pairs_disjoint=True)
    assert not bool(res_ok.seed_risk)
