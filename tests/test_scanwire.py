"""Fused scan wire-format roundtrip: pack_scan_batch (host) must invert
exactly through the device-side unpack prologue of the scan step
(cli._scan_step).  The scan ships ONE uint8 buffer per batch through the
host-to-device transfer (doc/architecture.md "End-to-end scan transfer
rules"); a silent bit-order or offset mismatch would corrupt every
statistic downstream, so the decode is pinned here cell-for-cell.
"""
import numpy as np
import pytest

from impop_tpu.cli import _scan_buf_layout, pack_scan_batch


def _unpack_host(flat, cap_n, cap_s, p_count, use_weights):
    """Reference decode mirroring the device prologue (numpy)."""
    lay = _scan_buf_layout(cap_n, cap_s, p_count, use_weights)
    gp = flat[lay["g"]:lay["m"]].reshape(cap_n, cap_s // 4)
    codes = (gp[:, :, None] >> np.array([0, 2, 4, 6], np.uint8)) & 3
    geno = codes.reshape(cap_n, cap_s).astype(np.int8) - 1
    member = np.unpackbits(flat[lay["m"]:lay["sm"]],
                           bitorder="little")[:cap_n].astype(bool)
    smask = np.unpackbits(flat[lay["sm"]:lay["p"]],
                          bitorder="little")[:cap_s].astype(bool)
    pb = flat[lay["p"]:lay["l"]].reshape(p_count, cap_n // 8)
    panels = np.unpackbits(pb, axis=1, bitorder="little")[:, :cap_n].astype(bool)
    length = float(flat[lay["l"]:lay["l"] + 4].view(np.uint32)[0])
    wts = None
    if use_weights:
        wts = flat[lay["w"]:lay["w"] + 4 * cap_s].view(np.float32).copy()
    return geno, member, smask, panels, length, wts


@pytest.mark.parametrize("use_weights", [False, True])
def test_pack_roundtrip(use_weights):
    rng = np.random.default_rng(3)
    w, cap_n, cap_s, p = 5, 64, 128, 3
    geno = rng.integers(-1, 2, size=(w, cap_n, cap_s)).astype(np.int8)
    member = rng.random((w, cap_n)) < 0.7
    smask = rng.random((w, cap_s)) < 0.6
    panels = rng.random((w, p, cap_n)) < 0.4
    lengths = rng.integers(1, 10_000_000, size=w).astype(np.float32)
    # include SV-scale indel weights far beyond the old uint16 wire range
    wts = rng.integers(1, 2_000_000, size=(w, cap_s)).astype(np.float32)

    flat = pack_scan_batch(geno, member, smask, panels, lengths,
                           wts if use_weights else None, use_weights)
    lay = _scan_buf_layout(cap_n, cap_s, p, use_weights)
    assert flat.shape == (w, lay["total"])
    assert flat.dtype == np.uint8

    for wi in range(w):
        g2, m2, sm2, p2, ln2, wt2 = _unpack_host(
            flat[wi], cap_n, cap_s, p, use_weights)
        np.testing.assert_array_equal(g2, geno[wi])
        np.testing.assert_array_equal(m2, member[wi])
        np.testing.assert_array_equal(sm2, smask[wi])
        np.testing.assert_array_equal(p2, panels[wi])
        assert ln2 == float(lengths[wi])
        if use_weights:
            # f32 wire weights: exact, no clamp — SV indel lengths far past
            # 65535 must survive the wire (advisor r3 finding)
            np.testing.assert_array_equal(wt2, wts[wi])


def test_pack_rejects_multiallelic():
    geno = np.full((1, 8, 4), 2, np.int8)
    with pytest.raises(SystemExit):
        pack_scan_batch(geno, np.ones((1, 8), bool), np.ones((1, 4), bool),
                        np.ones((1, 1, 8), bool),
                        np.ones(1, np.float32), None, False)


def test_device_unpack_weights_f32_exact():
    """Site weights cross the wire as f32 — the step's π must equal the
    same computation fed the weights directly (the old uint16 wire clamped
    at 65535 and failed this for SV-scale indel weights; advisor r3)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from impop_tpu.cli import _scan_step
    from impop_tpu.stats.allele import identity_from_alleles
    from impop_tpu.stats.panelstats import fused_panel_stats

    rng = np.random.default_rng(23)
    w, cap_n, cap_s = 2, 64, 128
    geno = np.full((w, cap_n, cap_s), -1, np.int8)
    geno[:, :32, :64] = rng.integers(0, 2, size=(w, 32, 64)).astype(np.int8)
    member = np.zeros((w, cap_n), bool); member[:, :32] = True
    smask = np.zeros((w, cap_s), bool); smask[:, :64] = True
    panels = np.zeros((w, 1, cap_n), bool); panels[:, 0, :32] = True
    lengths = np.full(w, 5_000_000.0, np.float32)
    wts = np.ones((w, cap_s), np.float32)
    wts[:, 3] = 250_000.0   # an SV far beyond the old uint16 range
    wts[:, 7] = 70_000.0

    flat = pack_scan_batch(geno, member, smask, panels, lengths, wts, True)
    step = _scan_step(cap_n, cap_s, 1, (), 0.999, True, False, 512, True,
                      False, tuple(jax.local_devices()[:1]))
    out = np.asarray(step(flat))

    for wi in range(w):
        sim, present = identity_from_alleles(
            jnp.asarray(geno[wi]), jnp.asarray(member[wi]),
            jnp.asarray(smask[wi]), jnp.float32(lengths[wi]),
            site_weights=jnp.asarray(wts[wi]))
        res = fused_panel_stats(sim, present, jnp.asarray(member[wi]),
                                jnp.asarray(panels[wi]),
                                jnp.asarray([0], jnp.int32),
                                jnp.asarray([0], jnp.int32),
                                jnp.float32(0.999), pairs_disjoint=False)
        np.testing.assert_allclose(out[wi, 0], float(res.pi[0]), rtol=1e-6)


def test_device_unpack_matches_host_decode():
    """The jitted step's prologue must agree with the host decode: feed a
    buffer whose decoded geno is known, and check S (segregating sites)
    computed on device equals numpy's on the decoded tile."""
    jax = pytest.importorskip("jax")
    from impop_tpu.cli import _scan_step

    rng = np.random.default_rng(11)
    w, cap_n, cap_s = 3, 64, 128
    geno = np.full((w, cap_n, cap_s), -1, np.int8)
    geno[:, :40, :90] = rng.integers(0, 2, size=(w, 40, 90)).astype(np.int8)
    member = np.zeros((w, cap_n), bool)
    member[:, :40] = True
    smask = np.zeros((w, cap_s), bool)
    smask[:, :90] = True
    panels = np.zeros((w, 1, cap_n), bool)
    panels[:, 0, :40] = True
    lengths = np.full(w, 5000.0, np.float32)

    flat = pack_scan_batch(geno, member, smask, panels, lengths, None, False)
    step = _scan_step(cap_n, cap_s, 1, (), 0.999, False, False, 512, True,
                      False, tuple(jax.local_devices()[:1]))
    out = np.asarray(step(flat))
    # packed row layout:
    # [pi(1), d(1), fst(1), fstg(1), f3(1), S, n, seed_risk, afs(1)]
    s_dev = out[:, 5]
    for wi in range(w):
        g = geno[wi][member[wi]][:, smask[wi]]
        s_np = int(((g.max(0) != g.min(0)) & (g.min(0) >= 0)).sum())
        assert int(s_dev[wi]) == s_np
    assert np.all(out[:, 6] == 40)
