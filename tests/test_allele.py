"""Allele-matrix path: pairwise diffs, S, AFS, and the identity-path
equivalence property (SURVEY.md §4b)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from impop_tpu.stats.allele import (
    allele_frequency_spectrum,
    allele_window_stats,
    identity_from_alleles,
    identity_route,
    pairwise_diff,
    pairwise_identity_f32,
    pairwise_identity_int8,
    segregating_sites,
)
from impop_tpu.stats.api import pi_grouped_jit

CAP_N, CAP_S = 64, 256


def random_geno(rng, n, s, num_alleles=2, missing_frac=0.0):
    geno = np.full((CAP_N, CAP_S), -1, dtype=np.int8)
    g = rng.integers(0, num_alleles, size=(n, s)).astype(np.int8)
    if missing_frac:
        drop = rng.random((n, s)) < missing_frac
        g[drop] = -1
    geno[:n, :s] = g
    member = np.zeros(CAP_N, dtype=bool)
    member[:n] = True
    site_mask = np.zeros(CAP_S, dtype=bool)
    site_mask[:s] = True
    return jnp.asarray(geno), jnp.asarray(member), jnp.asarray(site_mask)


pairwise_diff_jit = jax.jit(pairwise_diff, static_argnames=("num_alleles",))
segregating_sites_jit = jax.jit(segregating_sites)
afs_jit = jax.jit(allele_frequency_spectrum, static_argnames=("max_n", "folded"))


@pytest.mark.parametrize("num_alleles,missing", [(2, 0.0), (2, 0.15),
                                                 (4, 0.0), (4, 0.2)])
def test_pairwise_diff_matches_numpy(rng, num_alleles, missing):
    n, s = 20, 100
    geno, member, site_mask = random_geno(rng, n, s, num_alleles, missing)
    diff, compared = pairwise_diff_jit(geno, member, site_mask,
                                       num_alleles=num_alleles)
    g = np.asarray(geno)[:n, :s]
    valid = g >= 0
    for i in range(n):
        for j in range(n):
            both = valid[i] & valid[j]
            want_d = np.sum(both & (g[i] != g[j]))
            assert float(diff[i, j]) == want_d, (i, j)
            assert float(compared[i, j]) == np.sum(both), (i, j)


def test_segregating_sites(rng):
    n, s = 15, 80
    geno, member, site_mask = random_geno(rng, n, s, 2, 0.1)
    g = np.asarray(geno)[:n, :s]
    want = 0
    for c in range(s):
        vals = g[:, c][g[:, c] >= 0]
        if len(vals) and vals.max() != vals.min():
            want += 1
    assert int(segregating_sites_jit(geno, member, site_mask)) == want


def test_afs(rng):
    n, s = 12, 60
    geno, member, site_mask = random_geno(rng, n, s, 2, 0.0)
    g = np.asarray(geno)[:n, :s]
    hist = np.asarray(afs_jit(geno, member, site_mask, max_n=CAP_N))
    want = np.zeros(CAP_N + 1, dtype=int)
    for c in range(s):
        ones = int(g[:, c].sum())
        if 0 < ones < n:
            want[min(ones, n - ones)] += 1
    np.testing.assert_array_equal(hist, want)


def test_identity_path_equals_allele_path(rng):
    """π computed from the allele-derived identity matrix == π from direct
    hamming, when grouping threshold collapses exact duplicates only."""
    n, s, length = 24, 40, 1000
    # low diversity: most haplotypes identical => realistic grouping
    base = rng.integers(0, 2, size=s).astype(np.int8)
    geno_np = np.tile(base, (n, 1))
    for i in range(n):
        nmut = rng.integers(0, 4)
        for _ in range(nmut):
            geno_np[i, rng.integers(0, s)] ^= 1
    geno = np.full((CAP_N, CAP_S), -1, dtype=np.int8)
    geno[:n, :s] = geno_np
    member = np.zeros(CAP_N, dtype=bool); member[:n] = True
    site_mask = np.zeros(CAP_S, dtype=bool); site_mask[:s] = True
    geno, member, site_mask = map(jnp.asarray, (geno, member, site_mask))

    sim, present = jax.jit(identity_from_alleles)(
        geno, member, site_mask, jnp.float32(length)
    )
    # threshold just below 1.0 groups only exact duplicates
    res = pi_grouped_jit(sim, present, member, 1.0 - 0.5 / length)

    # oracle: group identical rows, frequency-weighted hamming over reps
    uniq, inverse, counts = np.unique(
        geno_np, axis=0, return_inverse=True, return_counts=True
    )
    freqs = counts / n
    acc = 0.0
    for a in range(len(uniq)):
        for b in range(a + 1, len(uniq)):
            d = np.sum(uniq[a] != uniq[b]) / length
            acc += 2 * d * freqs[a] * freqs[b]
    want = n / (n - 1) * acc
    np.testing.assert_allclose(float(res.pi), want, rtol=1e-5, atol=1e-10)


def test_allele_window_stats_bundle(rng):
    n, s = 20, 100
    geno, member, site_mask = random_geno(rng, n, s, 2, 0.0)
    stats = jax.jit(allele_window_stats, static_argnames=("max_n", "num_alleles"))(
        geno, member, site_mask, max_n=CAP_N
    )
    g = np.asarray(geno)[:n, :s]
    diffs = [np.sum(g[i] != g[j]) for i in range(n) for j in range(i + 1, n)]
    np.testing.assert_allclose(float(stats.pi_direct), np.mean(diffs), rtol=1e-6)
    assert int(stats.n) == n


@pytest.mark.parametrize("platform", ["cpu", "gpu", "rocm", "METAL"])
@pytest.mark.parametrize("has_weights", [False, True])
def test_identity_route(platform, has_weights):
    """Weighted tiles and every platform but the GPU take the f32 reference
    route; unit-weight tiles on the GPU take the int8 z-Gram (the winner at
    both window lengths timed on an H100, PERF.md)."""
    got = identity_route(platform, has_weights)
    if platform == "gpu" and not has_weights:
        assert got == "int8"
    else:
        assert got == "f32"


def test_identity_from_alleles_routes_gpu_unit_weights_to_int8(
        rng, monkeypatch):
    """identity_from_alleles asks identity_route with the backend and
    whether weights were given, and runs the route it names."""
    from impop_tpu.stats import allele

    calls = []

    def fake_route(platform, has_weights):
        calls.append((platform, has_weights))
        return "int8"

    monkeypatch.setattr(allele, "identity_route", fake_route)
    monkeypatch.setattr(allele, "pairwise_identity_int8",
                        lambda *a: ("int8", a))
    geno = jnp.asarray(rng.integers(0, 2, size=(8, 16)).astype(np.int8))
    member = jnp.ones(8, bool)
    smask = jnp.ones(16, bool)
    got = allele.identity_from_alleles(geno, member, smask,
                                       jnp.float32(100.0))
    assert got[0] == "int8"
    assert calls == [(jax.default_backend(), False)]
    # multiallelic codes never ask: only the f32 route handles them
    allele.identity_from_alleles(geno, member, smask, jnp.float32(100.0),
                                 num_alleles=3)
    assert len(calls) == 1


def test_int8_identity_bit_equal_to_f32_route(rng):
    """The int8 z-Gram gives sim/present bit-identical to the f32
    pairwise_diff route (integer counts are exact in both formulations),
    including padding rows, masked sites and missing calls."""
    n, s = 48, 300
    geno = rng.integers(0, 2, size=(n, s)).astype(np.int8)
    geno[rng.random((n, s)) < 0.1] = -1
    geno[-5:] = -1
    member = np.ones(n, bool)
    member[-5:] = False
    member[3] = True
    geno[3] = -1                      # a member with zero valid calls
    smask = rng.random(s) < 0.9
    args = tuple(map(jnp.asarray, (geno, member, smask))) + (
        jnp.float32(5000.0),)
    sim_f, pres_f = jax.jit(pairwise_identity_f32)(*args)
    sim_z, pres_z = jax.jit(pairwise_identity_int8)(*args)
    np.testing.assert_array_equal(np.asarray(pres_z), np.asarray(pres_f))
    np.testing.assert_array_equal(np.asarray(sim_z), np.asarray(sim_f))
