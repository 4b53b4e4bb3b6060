"""Card-only checks: exactness under TF32 and oracle differentials on the GPU.

On the GPU a DEFAULT-precision f32 dot may run as TF32 (10-bit mantissa).
The exact dots of this package (identity counts, the grouping and EHH
exponent-field decodes) rely on 0/1, ±1 and power-of-two operands with f32
accumulation staying exact there; these tests check that on the card rather
than assume it, and rerun the CPU suite's oracle differentials at
production width on the card.  Each skips where JAX finds no GPU (the
``gpu`` fixture):

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import test_allele
import test_ehh
import test_grouping
import test_panelstats

pytestmark = pytest.mark.gpu


def test_default_precision_dot_exact_on_01_and_pm1_operands(gpu, rng):
    """0/1 and ±1 operands through DEFAULT-precision f32 dots over 512
    rows give the exact integer Grams (the grouping recurrence's seed
    and link products, the group-size histogram)."""
    x = (rng.random((512, 512)) < 0.5).astype(np.float32)
    z = np.where(rng.random((512, 512)) < 0.5, 1.0, -1.0).astype(np.float32)
    z[rng.random(z.shape) < 0.1] = 0.0
    dot = jax.jit(lambda a, b: jnp.dot(a, b.T,
                                       preferred_element_type=jnp.float32))
    for a in (x, z):
        want = a.astype(np.int64) @ a.astype(np.int64).T
        got = np.asarray(dot(jnp.asarray(a), jnp.asarray(a)))
        np.testing.assert_array_equal(got.astype(np.int64), want)


def test_default_precision_dot_exact_on_power_of_two_weights(gpu, rng):
    """Bit-weighted 16-column blocks (weights 2^15 .. 2^0 times 0/1) sum
    exactly, and the f32 exponent field reads back the first set bit —
    the decode of stats/grouping._gid_from_seeds and stats/ehh."""
    kb = 16
    w = np.exp2(np.arange(kb - 1, -1, -1, dtype=np.float64)).astype(
        np.float32)
    x = (rng.random((512, kb)) < 0.3).astype(np.float32)
    y = (rng.random((512, kb)) < 0.3).astype(np.float32)
    f = jax.jit(lambda a, b: jnp.dot(a * w[None, :], b.T,
                                     preferred_element_type=jnp.float32))
    got = np.asarray(f(jnp.asarray(x), jnp.asarray(y)))
    both = x[:, None, :] * y[None, :, :]                    # [N, N, kb]
    want = (both * w.astype(np.float64)).sum(-1)
    np.testing.assert_array_equal(got.astype(np.float64), want)
    expo = (got.view(np.int32) >> 23) - 127
    first = np.where(both.any(-1), both.argmax(-1), -1)
    np.testing.assert_array_equal(
        np.where(got > 0, kb - 1 - expo, -1), first)


def test_greedy_group_panels_on_card_matches_oracle(gpu, rng):
    test_grouping.test_greedy_group_panels_at_production_cap_matches_oracle(
        rng)


def test_ehh_area_dynamic_on_card_matches_numpy_reference(gpu, rng):
    test_ehh.test_ehh_area_dynamic_at_production_cap_matches_numpy_reference(
        rng)


def test_int8_identity_on_card_bit_equal_to_f32_route(gpu, rng):
    test_allele.test_int8_identity_bit_equal_to_f32_route(rng)


@pytest.mark.parametrize("s_cap", [128, 8192])
def test_chosen_identity_route_bit_equal_to_f32(gpu, rng, s_cap):
    """Whatever identity_route picks on the card gives sim/present
    bit-identical to the f32 reference route at the scan's and the long
    window's site capacities."""
    from impop_tpu.stats.allele import (identity_from_alleles,
                                        pairwise_identity_f32)

    n = 512
    classes = rng.integers(0, 2, size=(16, s_cap)).astype(np.int8)
    geno = classes[rng.integers(0, 16, size=n)]
    geno = np.where(rng.random((n, s_cap)) < 0.002, 1 - geno, geno)
    geno = geno.astype(np.int8)
    geno[rng.random((n, s_cap)) < 0.02] = -1
    geno[466:] = -1
    member = np.zeros(n, bool)
    member[:466] = True
    smask = rng.random(s_cap) < 0.95
    args = tuple(map(jnp.asarray, (geno, member, smask))) + (
        jnp.float32(5000.0),)
    sim, pres = jax.jit(identity_from_alleles)(*args)
    sim_f, pres_f = jax.jit(pairwise_identity_f32)(*args)
    np.testing.assert_array_equal(np.asarray(pres), np.asarray(pres_f))
    np.testing.assert_array_equal(np.asarray(sim), np.asarray(sim_f))


def test_fused_panel_stats_on_card_matches_composed(gpu, rng):
    test_panelstats.test_fused_matches_composed(rng)


def test_overlapping_panels_on_card_match_disjoint_path(gpu, rng):
    test_panelstats.test_pairs_disjoint_fast_path_equivalence(rng)


def test_headline_program_on_card_matches_oracle(gpu):
    """The bench's headline program on 2 windows against the f64 oracle
    (π and dxy relative, Fst absolute, counts and group ids exact)."""
    import chip_smoke

    chip_smoke.check_headline(n_check=2, batch=16)
