"""EHH scan kernel vs the reference's triple-loop semantics."""
import jax
import jax.numpy as jnp
import numpy as np

from impop_tpu.stats.ehh import (ehh_area_dynamic, ehh_bidirectional,
                                 ehh_decay_from_focal, ehh_forward)


def oracle_ehh(hap: np.ndarray) -> np.ndarray:
    """Direct reimplementation of wip/ehh2.py:72-86 (without its round())."""
    n, s = hap.shape
    out = np.zeros(s)
    denom = n * (n - 1) / 2
    for i in range(s):
        agree = 0
        for j in range(n):
            for k in range(j + 1, n):
                if np.array_equal(hap[j, : i + 1], hap[k, : i + 1]):
                    agree += 1
        out[i] = agree / denom
    return out


def _tile(hap, cap_n=16, cap_s=32):
    n, s = hap.shape
    geno = np.full((cap_n, cap_s), -1, dtype=np.int8)
    geno[:n, :s] = hap
    member = np.zeros(cap_n, dtype=bool); member[:n] = True
    site_mask = np.zeros(cap_s, dtype=bool); site_mask[:s] = True
    return jnp.asarray(geno), jnp.asarray(member), jnp.asarray(site_mask)


def test_ehh_forward_matches_reference_loops(rng):
    hap = rng.integers(0, 3, size=(6, 10)).astype(np.int8)
    geno, member, site_mask = _tile(hap)
    got = np.asarray(jax.jit(ehh_forward)(geno, member, site_mask))[:10]
    np.testing.assert_allclose(got, oracle_ehh(hap), atol=1e-6)


def test_ehh_reference_fixture():
    """The A1 matrix from wip/ehh2.py:3-10 — all rows identical => EHH == 1."""
    hap = np.tile(np.array([1, 2, 3, 4, 5, 6, 7, 8, 9, 0], dtype=np.int8), (6, 1))
    geno, member, site_mask = _tile(hap)
    got = np.asarray(jax.jit(ehh_forward)(geno, member, site_mask))[:10]
    np.testing.assert_allclose(got, np.ones(10), atol=1e-7)


def test_ehh_bidirectional_shape(rng):
    hap = rng.integers(0, 2, size=(5, 12)).astype(np.int8)
    geno, member, site_mask = _tile(hap, cap_s=12)
    got = np.asarray(jax.jit(ehh_bidirectional)(geno, member, site_mask))
    assert got.shape == (24,)
    fwd = oracle_ehh(hap)
    rev = oracle_ehh(hap[:, ::-1])
    want = np.concatenate([rev[::-1], fwd])
    np.testing.assert_allclose(got, want, atol=1e-6)


def _reference_ehh_cli_oracle(whole, test_snp, wsize, refpos, compat):
    """Straight numpy port of wip/ehhgfa.py's window/allele loop (the
    pre-batching cmd_ehh semantics) — the ground truth for the batched CLI."""
    whole = (whole != 0).astype(np.int8)
    n, total = whole.shape
    rows = []
    window_name = 1
    colstart = 0
    while colstart < total:
        colend = min(colstart + wsize, total)
        window = whole[:, colstart:colend]
        if window.shape[1] == 0 or test_snp >= window.shape[1]:
            colstart = colend
            window_name += 1
            continue
        ref_allele = window[refpos - 1, test_snp]
        for al in np.unique(window[:, test_snp]):
            sub = window[window[:, test_snp] == al]
            right = sub[:, test_snp + 1:]
            left = right if compat else sub[:, :test_snp]

            def e(mat):
                if mat.shape[1] == 0 or mat.shape[0] < 2:
                    return np.zeros(mat.shape[1])
                return oracle_ehh(mat)

            curve = np.concatenate([e(left[:, ::-1])[::-1], e(right)])
            area = float(np.cumsum(curve)[-1]) if curve.size else 0.0
            typeal = "REF" if al == ref_allele else "ALT"
            rows.append((window_name, colstart, colend, int(al), typeal,
                         area))
        colstart = colend
        window_name += 1
    return rows


def test_ehh_cli_batched_matches_oracle_one_compile(tmp_path, rng):
    """100-window scan: one jit compile, outputs equal the reference-loop
    oracle in both default and --compat-ehhgfa modes."""
    from impop_tpu.cli import main
    from impop_tpu.stats import ehh as ehh_mod

    whole = rng.integers(0, 2, size=(12, 1000)).astype(np.int8)
    mat = tmp_path / "m.txt"
    np.savetxt(mat, whole, fmt="%d")

    for compat in (False, True):
        before = ehh_mod.ehh_area_batch._cache_size()
        out = tmp_path / f"ehh_{compat}.txt"
        argv = ["ehh", "-i", str(mat), "-p", "4", "-w", "10",
                "-o", str(out)]
        if compat:
            argv.append("--compat-ehhgfa")
        main(argv)
        after = ehh_mod.ehh_area_batch._cache_size()
        assert after - before <= 1, "scan must cost at most one compile"

        want = _reference_ehh_cli_oracle(whole, 3, 10, 1, compat)
        got = []
        for line in out.read_text().splitlines():
            w, cs, ce, al, t, area = line.split()
            got.append((int(w), int(cs), int(ce), int(al), t, float(area)))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g[:5] == w[:5]
            np.testing.assert_allclose(g[5], w[5], atol=1e-4)


def test_ehh_decay_from_focal(rng):
    """Carrier subsetting + split/concat/area semantics of wip/ehhgfa.py."""
    hap = rng.integers(0, 2, size=(8, 11)).astype(np.int8)
    focal = 5
    geno, member, site_mask = _tile(hap, cap_s=11)
    res = jax.jit(ehh_decay_from_focal, static_argnames=("focal",))(
        geno, member, site_mask, focal=focal, allele=jnp.int8(1)
    )
    sub = hap[hap[:, focal] == 1]
    a = sub[:, :focal]
    b = sub[:, focal + 1:]
    if len(sub) >= 2:
        left = oracle_ehh(a[:, ::-1])
        right = oracle_ehh(b)
        want_curve = np.concatenate([left[::-1], right])
        got = np.asarray(res.ehh)
        np.testing.assert_allclose(got, want_curve, atol=1e-6)
        np.testing.assert_allclose(float(res.area), want_curve.sum(), rtol=1e-5)
    assert int(res.carriers) == len(sub)


def test_ehh_cli_from_extraction_path(tmp_path):
    """`ehh --paf --fasta -b … --focal P` (no text matrix): focal sites are
    selected by genomic position from the engine's own extracted allele
    tiles, and the areas match the reference's loop semantics
    (wip/ehhgfa.py:47-69) computed on the same tile."""
    from impop_tpu.cli import main
    from impop_tpu.extract import NativeExtractor
    from impop_tpu.extract.simulate import simulate

    sim = simulate(str(tmp_path), ref_len=4000, n_haps=12, seed=17,
                   site_pool=30, span=(0, 4000))
    bed = tmp_path / "w.bed"
    bed.write_text("chr1\t0\t2000\nchr1\t2000\t4000\n")

    ex = NativeExtractor(sim.paf_path, sim.fasta_path)
    wm = ex.extract(sim.ref_name, 0, 2000)
    h = (np.asarray(wm.geno) == 1).astype(np.int8)
    # a focal site where both alleles have >=2 carriers
    counts = h.sum(0)
    fi = int(np.argmax((counts >= 2) & (counts <= h.shape[0] - 2)))
    assert counts[fi] >= 2
    focal_pos = int(wm.site_pos[fi])

    out = tmp_path / "ehh.tsv"
    main(["ehh", "--paf", sim.paf_path, "--fasta", sim.fasta_path,
          "-b", str(bed), "-P", "CHM13#0#", "--focal", str(focal_pos),
          "-o", str(out)])
    lines = [l.split() for l in out.read_text().splitlines() if l]
    assert len(lines) == 2  # both alleles carried
    for parts in lines:
        region, fp, used_pos, key, al, typeal, carriers, area = parts
        assert region == "CHM13#0#chr1:0-2000"
        assert int(fp) == int(used_pos) == focal_pos
        assert typeal == ("REF" if al == "0" else "ALT")
        sel = h[:, fi] == int(al)
        assert int(carriers) == int(sel.sum())
        left = h[sel][:, :fi][:, ::-1]
        right = h[sel][:, fi + 1:]
        want = 0.0
        for half in (left, right):
            if half.shape[1]:
                want += float(np.sum(oracle_ehh(half)))
        np.testing.assert_allclose(float(area), want, atol=1e-4)


def test_pair_death_area_matches_scan_formulation(rng):
    """The matmul death-site area (ehh_pair_death) must equal the per-site
    scan's summed curve: area = sum_i EHH(i) = sum_pairs death/denom."""
    import jax.numpy as jnp

    from impop_tpu.stats.ehh import ehh_forward, ehh_pair_death

    n, s = 48, 37   # deliberately not a 16-multiple
    geno = rng.integers(0, 2, size=(n, s)).astype(np.int8)
    member = rng.random(n) < 0.8
    smask = rng.random(s) < 0.85

    curve = np.asarray(ehh_forward(jnp.asarray(geno), jnp.asarray(member),
                                   jnp.asarray(smask)))
    death = np.asarray(ehh_pair_death(jnp.asarray(geno),
                                      jnp.asarray(smask)))
    upper = np.triu(np.ones((n, n), bool), k=1)
    pairs = upper & member[:, None] & member[None, :]
    n_m = int(member.sum())
    denom = max(n_m * (n_m - 1) / 2.0, 1.0)
    area_death = death[pairs].sum() / denom
    np.testing.assert_allclose(curve.sum(), area_death, rtol=1e-5)

    # death itself pinned against a direct numpy recomputation
    g2 = np.where(smask[None, :], geno, 0)
    for _ in range(200):
        i, j = rng.integers(0, n, 2)
        d = np.nonzero(g2[i] != g2[j])[0]
        expect = int(d[0]) if d.size else s
        assert death[i, j] == expect, (i, j, death[i, j], expect)


def test_ehh_area_dynamic_matches_static_batch(rng):
    """ehh_area_dynamic (traced focal index — the fused-scan formulation)
    must reproduce ehh_area_batch run on the COMPACTED window (masked
    columns dropped, focal re-indexed to its active rank): areas count
    active site steps only, so they are independent of the tile's padding
    capacity — the fused-scan requirement."""
    import jax
    import jax.numpy as jnp

    from impop_tpu.stats.ehh import ehh_area_batch, ehh_area_dynamic

    n, s, w = 64, 50, 6   # s deliberately not a 16-multiple
    geno = (rng.random((w, n, s)) < 0.4).astype(np.int8)
    member = rng.random((w, n)) < 0.85
    smask = rng.random((w, s)) < 0.9
    smask[:, s // 2] = True   # shared active focal for the batched call
    alleles = jnp.asarray([0, 1], jnp.int32)

    dyn = jax.jit(jax.vmap(
        lambda g, m, sm, f: ehh_area_dynamic(g, m, sm, f, alleles=(0, 1))))

    def oracle(wi, focal):
        """static-batch engine on the compacted (mask-dropped) window"""
        act = smask[wi]
        gc = geno[wi][:, act][None]
        fc = int(act[:focal].sum())
        a, c = ehh_area_batch(
            jnp.asarray(gc), jnp.asarray(member[wi:wi + 1]),
            jnp.ones((1, gc.shape[2]), bool), fc, alleles)
        return np.asarray(a)[0], np.asarray(c)[0]

    # shared focal across the batch, one compiled dynamic call
    focal = s // 2
    fis = jnp.full((w,), focal, jnp.int32)
    a_dy, c_dy = dyn(jnp.asarray(geno), jnp.asarray(member),
                     jnp.asarray(smask), fis)
    for wi in range(w):
        a_st, c_st = oracle(wi, focal)
        # carriers read the RAW focal column in both engines
        np.testing.assert_array_equal(c_st, np.asarray(c_dy)[wi])
        np.testing.assert_allclose(a_st, np.asarray(a_dy)[wi],
                                   rtol=1e-6, atol=1e-6, err_msg=f"wi={wi}")

    # mixed per-window ACTIVE focals (incl. edges) in ONE compiled call
    fis = []
    for wi in range(w):
        act_idx = np.nonzero(smask[wi])[0]
        pick = [act_idx[0], act_idx[-1],
                act_idx[len(act_idx) // 2]][wi % 3]
        fis.append(int(pick))
    fis_j = jnp.asarray(fis, jnp.int32)
    a_dy, c_dy = dyn(jnp.asarray(geno), jnp.asarray(member),
                     jnp.asarray(smask), fis_j)
    for wi in range(w):
        a_st, c_st = oracle(wi, fis[wi])
        np.testing.assert_array_equal(c_st, np.asarray(c_dy)[wi])
        np.testing.assert_allclose(a_st, np.asarray(a_dy)[wi],
                                   rtol=1e-6, atol=1e-6,
                                   err_msg=f"wi={wi} focal={fis[wi]}")

    # padding-independence: widening the tile must not change the areas
    pad = 30
    g2 = np.concatenate([geno, np.zeros((w, n, pad), np.int8)], axis=2)
    sm2 = np.concatenate([smask, np.zeros((w, pad), bool)], axis=1)
    dyn2 = jax.jit(jax.vmap(
        lambda g, m, sm, f: ehh_area_dynamic(g, m, sm, f, alleles=(0, 1))))
    a2, c2 = dyn2(jnp.asarray(g2), jnp.asarray(member), jnp.asarray(sm2),
                  fis_j)
    np.testing.assert_allclose(np.asarray(a2), np.asarray(a_dy),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(c2), np.asarray(c_dy))


def test_ehh_area_dynamic_at_production_cap_matches_numpy_reference(rng):
    """ehh_area_dynamic at the scan's cap of 512 rows and 128 site columns
    (466 haplotypes, masked columns, a mid-window focal) against the
    numpy reference of the area semantics (oracle.ehh_areas)."""
    import oracle

    n_cap, n, s = 512, 466, 128
    classes = rng.integers(0, 2, size=(12, s)).astype(np.int8)
    geno = classes[rng.integers(0, 12, size=n_cap)]
    geno = np.where(rng.random((n_cap, s)) < 0.02, 1 - geno, geno)
    geno = geno.astype(np.int8)
    member = np.zeros(n_cap, bool)
    member[:n] = True
    smask = rng.random(s) < 0.85
    focal = int(np.nonzero(smask)[0][40])
    area, carr = jax.jit(
        lambda g, m, sm, f: ehh_area_dynamic(g, m, sm, f, alleles=(0, 1)))(
        jnp.asarray(geno), jnp.asarray(member), jnp.asarray(smask),
        jnp.int32(focal))
    hap = geno[:n][:, smask]
    want_area, want_carr = oracle.ehh_areas(hap, int(smask[:focal].sum()))
    np.testing.assert_array_equal(np.asarray(carr), want_carr)
    np.testing.assert_allclose(np.asarray(area), want_area, rtol=1e-6)
