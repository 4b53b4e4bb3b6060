"""Extraction layer: C++ path vs Python fallback vs planted ground truth."""
import os
import shutil
import subprocess

import numpy as np
import pytest

from impop_tpu.extract.pyfallback import PyExtractor
from impop_tpu.extract.simulate import simulate

HAVE_TOOLCHAIN = shutil.which("make") and shutil.which("g++")


def _native(tmp_path):
    from impop_tpu.extract import NativeExtractor

    return NativeExtractor


def _planted_truth(sim, start, end):
    """Expected variant keys within [start, end) per haplotype."""
    out = {}
    for hap in sim.haplotypes:
        keys = set()
        for pos, alt in hap.snps.items():
            if start <= pos < end:
                keys.add((pos, sim.ref_seq[pos], alt))
        for pos, ins in hap.insertions.items():
            if start < pos <= end:
                keys.add((pos, "", ins))
        for pos, dlen in hap.deletions.items():
            d0, d1 = max(pos, start), min(pos + dlen, end)
            if d0 < d1:
                keys.add((d0, sim.ref_seq[d0:d1], ""))
        out[hap.name] = keys
    return out


def test_python_extractor_recovers_planted_variants(tmp_path, rng):
    sim = simulate(str(tmp_path), ref_len=1500, n_haps=8, n_snps=6, seed=3)
    ex = PyExtractor(sim.paf_path, sim.fasta_path)
    start, end = 100, 1400
    wm = ex.extract(sim.ref_name, start, end)
    truth = _planted_truth(sim, start, end)

    key_of_col = {}
    for c, key in enumerate(wm.site_keys):
        pos_s, rest = key.split(":", 1)
        ref, alt = rest.split(">", 1)
        key_of_col[c] = (int(pos_s), ref, alt)

    for row, name in enumerate(wm.names):
        contig = name.split(":", 1)[0]
        if contig == sim.ref_name.split(":", 1)[0] or name.startswith(sim.ref_name):
            assert not (wm.geno[row] == 1).any()  # reference row: no variants
            continue
        hap_truth = truth[contig]
        called = {key_of_col[c] for c in np.nonzero(wm.geno[row] == 1)[0]}
        # restrict truth to the hap's covered span
        hap = next(h for h in sim.haplotypes if h.name == contig)
        expect = {k for k in hap_truth
                  if hap.target_start <= k[0] < hap.target_end}
        assert called == expect, (name, called ^ expect)


@pytest.mark.skipif(not HAVE_TOOLCHAIN, reason="no C++ toolchain")
def test_cpp_matches_python(tmp_path):
    from impop_tpu.extract import NativeExtractor

    kwargs = [dict(n_snps=8, seed=0), dict(n_snps=8, seed=7),
              dict(site_pool=30, seed=3)]  # shared-pool (realistic) mode
    for i, kw in enumerate(kwargs):
        d = tmp_path / f"s{i}"
        sim = simulate(str(d), ref_len=2400, n_haps=10, **kw)
        py = PyExtractor(sim.paf_path, sim.fasta_path)
        with NativeExtractor(sim.paf_path, sim.fasta_path) as cc:
            for (start, end) in ((0, 2400), (351, 1777), (1200, 1300)):
                a = py.extract(sim.ref_name, start, end)
                b = cc.extract(sim.ref_name, start, end)
                assert a.names == b.names, (start, end)
                assert a.site_keys == b.site_keys, (start, end)
                np.testing.assert_array_equal(a.geno, b.geno)


@pytest.mark.skipif(not HAVE_TOOLCHAIN, reason="no C++ toolchain")
def test_cpp_gzip_paf(tmp_path):
    import gzip

    from impop_tpu.extract import NativeExtractor

    sim = simulate(str(tmp_path), ref_len=900, n_haps=4, n_snps=4, seed=11)
    gz = sim.paf_path + ".gz"
    with open(sim.paf_path, "rb") as fin, gzip.open(gz, "wb") as fout:
        fout.write(fin.read())
    py = PyExtractor(sim.paf_path, sim.fasta_path)
    with NativeExtractor(gz, sim.fasta_path) as cc:
        a = py.extract(sim.ref_name, 50, 850)
        b = cc.extract(sim.ref_name, 50, 850)
        assert a.names == b.names
        np.testing.assert_array_equal(a.geno, b.geno)


@pytest.mark.skipif(not HAVE_TOOLCHAIN, reason="no C++ toolchain")
def test_cpp_bgzf_fasta(tmp_path):
    """BGZF-compressed FASTA: native random access == plain-text access,
    and the block index round-trips through the samtools .gzi format."""
    from impop_tpu.extract import NativeExtractor
    from impop_tpu.io.bgzf import write_bgzf

    sim = simulate(str(tmp_path), ref_len=3000, n_haps=6, n_snps=8, seed=17,
                   span=(0, 3000))
    bgz = sim.fasta_path + ".bgz.gz"
    with open(sim.fasta_path, "rb") as fin:
        # small chunks force several BGZF blocks per sequence
        data = fin.read()
    write_bgzf(bgz, [data[i:i + 1024] for i in range(0, len(data), 1024)])

    py = PyExtractor(sim.paf_path, sim.fasta_path)
    with NativeExtractor(sim.paf_path, bgz) as cc:
        for (start, end) in ((0, 3000), (751, 2250)):
            a = py.extract(sim.ref_name, start, end)
            b = cc.extract(sim.ref_name, start, end)
            assert a.names == b.names
            assert a.site_keys == b.site_keys
            np.testing.assert_array_equal(a.geno, b.geno)
    # .gzi + .fai persisted; a fresh reader must load them and agree
    assert os.path.exists(bgz + ".gzi") and os.path.exists(bgz + ".fai")
    with NativeExtractor(sim.paf_path, bgz) as cc2:
        a = py.extract(sim.ref_name, 100, 2900)
        b = cc2.extract(sim.ref_name, 100, 2900)
        np.testing.assert_array_equal(a.geno, b.geno)


@pytest.mark.skipif(not HAVE_TOOLCHAIN, reason="no C++ toolchain")
def test_cpp_plain_gzip_fasta(tmp_path):
    """Single-member gzip FASTA (no random access): whole-file inflate path."""
    import gzip

    from impop_tpu.extract import NativeExtractor

    sim = simulate(str(tmp_path), ref_len=1200, n_haps=4, n_snps=5, seed=23)
    gz = sim.fasta_path + ".gz"
    with open(sim.fasta_path, "rb") as fin, gzip.open(gz, "wb") as fout:
        fout.write(fin.read())
    py = PyExtractor(sim.paf_path, sim.fasta_path)
    with NativeExtractor(sim.paf_path, gz) as cc:
        a = py.extract(sim.ref_name, 50, 1150)
        b = cc.extract(sim.ref_name, 50, 1150)
        assert a.names == b.names
        np.testing.assert_array_equal(a.geno, b.geno)


def test_extract_to_stats_end_to_end(tmp_path):
    """Planted SNPs flow through extraction into the device S/pi statistics."""
    import jax

    from impop_tpu.stats.allele import segregating_sites

    # all haplotypes span the full reference: S == number of distinct planted
    # variant keys that are polymorphic (every non-ref haplotype row exists)
    sim = simulate(str(tmp_path), ref_len=1000, n_haps=6, n_snps=5,
                   p_indel=0.0, seed=5, span=(0, 1000))
    ex = PyExtractor(sim.paf_path, sim.fasta_path)
    wm = ex.extract(sim.ref_name, 0, 1000)
    n, s = wm.geno.shape
    cap_n, cap_s = 16, max(8, s)
    geno = np.full((cap_n, cap_s), -1, dtype=np.int8)
    geno[:n, :s] = wm.geno
    member = np.zeros(cap_n, bool); member[:n] = True
    site_mask = np.zeros(cap_s, bool); site_mask[:s] = True
    s_count = int(jax.jit(segregating_sites)(geno, member, site_mask))
    distinct = {k for h in sim.haplotypes
                for k in _planted_truth(sim, 0, 1000)[h.name]}
    assert s_count == len(distinct) == s


def test_missing_window_region(tmp_path):
    sim = simulate(str(tmp_path), ref_len=600, n_haps=3, n_snps=3, seed=9)
    ex = PyExtractor(sim.paf_path, sim.fasta_path)
    wm = ex.extract("CHM13#0#chrNOPE", 0, 100)
    # only the reference placeholder row, no sites
    assert wm.geno.shape[1] == 0
    assert len(wm.names) == 1


def test_extract_cli_to_tajd_and_pi(tmp_path):
    """simulate -> `extract` CLI -> `tajd` + `pi --geno-dir` CLIs."""
    from impop_tpu.cli import main

    sim = simulate(str(tmp_path), ref_len=3000, n_haps=10, n_snps=8, seed=1,
                   span=(0, 3000))
    bed = tmp_path / "w.bed"
    bed.write_text("chr1\t0\t1500\nchr1\t1500\t3000\n")
    tiles = tmp_path / "tiles"
    main(["extract", "-b", str(bed), "--paf", sim.paf_path,
          "--fasta", sim.fasta_path, "--out-dir", str(tiles),
          "-P", "CHM13#0#", "--python"])
    assert len(list(tiles.glob("*.npz"))) == 2

    out = tmp_path / "tajd.tsv"
    main(["tajd", "-b", str(bed), "--geno-dir", str(tiles),
          "-P", "CHM13#0#", "-o", str(out)])
    lines = [l for l in out.read_text().splitlines() if l]
    assert len(lines) == 3
    f1 = lines[1].split("\t")
    assert f1[2] == "11"          # 10 haplotypes + reference row
    assert int(f1[3]) > 0         # segregating sites found

    out2 = tmp_path / "pi.tsv"
    main(["pi", "-b", str(bed), "--geno-dir", str(tiles), "-P", "CHM13#0#",
          "-t", "0.999", "-r", "5", "-o", str(out2)])
    lines2 = [l for l in out2.read_text().splitlines() if l]
    assert len(lines2) == 3
    assert not lines2[1].split("\t")[4].startswith("0.00000000")


def test_extract_vcf_line_count_is_s(tmp_path):
    """--vcf: non-header record count == segregating sites (povu contract)."""
    import jax

    from impop_tpu.cli import main
    from impop_tpu.stats.allele import segregating_sites

    sim = simulate(str(tmp_path), ref_len=1200, n_haps=6, n_snps=5,
                   p_indel=0.3, seed=13, span=(0, 1200))
    bed = tmp_path / "w.bed"
    bed.write_text("chr1\t0\t1200\n")
    tiles = tmp_path / "tiles"
    main(["extract", "-b", str(bed), "--paf", sim.paf_path,
          "--fasta", sim.fasta_path, "--out-dir", str(tiles),
          "-P", "CHM13#0#", "--python", "--vcf"])
    vcf = next(tiles.glob("*.vcf"))
    records = [l for l in vcf.read_text().splitlines()
               if l and not l.startswith("#")]
    npz = np.load(next(tiles.glob("*.npz")))
    g = npz["geno"]
    n, s = g.shape
    member = np.ones(n, bool)
    smask = np.ones(max(s, 1), bool)[:s] if s else np.zeros(0, bool)
    # every variant column is polymorphic here (ref row has 0 everywhere)
    assert len(records) == s
    assert records[0].split("\t")[0] == "CHM13#0#chr1"


def test_greedy_group_pathological_chain(rng):
    """Worst-case sequential dependency: a chain a0-a1-a2-... where each
    link crosses the threshold but no transitive link does. The greedy
    semantics make a0, a2, a4... seeds; peeling must reproduce that."""
    import jax
    import jax.numpy as jnp

    from impop_tpu.stats.grouping import greedy_group

    n = 32
    sim = np.zeros((n, n)); present = np.eye(n, dtype=bool)
    np.fill_diagonal(sim, 1.0)
    for i in range(n - 1):
        sim[i, i + 1] = sim[i + 1, i] = 0.9995
        present[i, i + 1] = present[i + 1, i] = True
    cap = 64
    sim_p = np.zeros((cap, cap), np.float32); sim_p[:n, :n] = sim
    pres_p = np.zeros((cap, cap), bool); pres_p[:n, :n] = present
    member = np.zeros(cap, bool); member[:n] = True
    gid = np.asarray(jax.jit(greedy_group)(
        jnp.asarray(sim_p), jnp.asarray(pres_p), jnp.asarray(member),
        jnp.float32(0.999)))
    # greedy with sorted order: 0 absorbs 1; 2 becomes seed, absorbs 3; ...
    for i in range(n):
        assert gid[i] == (i // 2) * 2, i


def test_extract_gfa_paths_spell_haplotypes(tmp_path):
    """GFA export: concatenating each path's segment sequences reproduces
    the haplotype's window sequence (the graph is a faithful encoding)."""
    from impop_tpu.extract.gfa import window_to_gfa
    from impop_tpu.extract.pyfallback import read_fasta

    sim = simulate(str(tmp_path), ref_len=800, n_haps=5, n_snps=6,
                   p_indel=0.5, seed=21, span=(0, 800))
    ex = PyExtractor(sim.paf_path, sim.fasta_path)
    wm = ex.extract(sim.ref_name, 0, 800)
    seqs = read_fasta(sim.fasta_path)
    gfa = window_to_gfa(wm, seqs[sim.ref_name][:800], 0, sim.ref_name)

    seg = {}
    paths = {}
    for line in gfa.splitlines():
        parts = line.split("\t")
        if parts[0] == "S":
            seg[parts[1]] = "" if parts[2] == "*" else parts[2]
        elif parts[0] == "P":
            paths[parts[1]] = [x[:-1] for x in parts[2].split(",")]

    # reference path spells the reference window
    ref_path = f"{sim.ref_name}:0-800"
    assert "".join(seg[s] for s in paths[ref_path]) == seqs[sim.ref_name][:800]

    # each fully-spanning haplotype path spells its own sequence (all spans
    # are (0, 800) here; reverse-strand contigs are stored revcomp'd)
    from impop_tpu.extract.pyfallback import revcomp

    for hap in sim.haplotypes:
        row_name = next(n for n in wm.names if n.startswith(hap.name + ":"))
        walked = "".join(seg[s] for s in paths[row_name])
        stored = seqs[hap.name]
        want = revcomp(stored) if hap.reverse else stored
        assert walked == want, hap.name


def test_extract_split_equals_per_window(tmp_path):
    """--split range extraction == independent per-window extraction."""
    from impop_tpu.cli import main

    sim = simulate(str(tmp_path), ref_len=4000, n_haps=8, n_snps=12, seed=6,
                   span=(0, 4000))
    bed_windows = tmp_path / "wins.bed"
    bed_windows.write_text(
        "".join(f"chr1\t{i*1000}\t{(i+1)*1000}\n" for i in range(4))
    )
    bed_range = tmp_path / "range.bed"
    bed_range.write_text("chr1\t0\t4000\n")

    a_dir, b_dir = tmp_path / "a", tmp_path / "b"
    main(["extract", "-b", str(bed_windows), "--paf", sim.paf_path,
          "--fasta", sim.fasta_path, "--out-dir", str(a_dir),
          "-P", "CHM13#0#", "--python"])
    main(["extract", "-b", str(bed_range), "--paf", sim.paf_path,
          "--fasta", sim.fasta_path, "--out-dir", str(b_dir),
          "-P", "CHM13#0#", "--python", "--split", "1000"])

    a_files = sorted(f.name for f in a_dir.glob("*.npz"))
    b_files = sorted(f.name for f in b_dir.glob("*.npz"))
    assert a_files == b_files
    for name in a_files:
        a = np.load(a_dir / name)
        b = np.load(b_dir / name)
        # same variant keys and genotypes (row sets may differ only if a
        # haplotype doesn't overlap the subwindow; with full spans they match)
        assert list(a["site_keys"]) == list(b["site_keys"]), name
        np.testing.assert_array_equal(a["geno"], b["geno"])


def test_paf_index_cache_roundtrip_and_invalidation(tmp_path):
    """The persistent PAF index sidecar (<paf>.impopidx) must reproduce
    the parsed index exactly on reopen, and must be ignored when the
    source PAF changes (size/mtime validation)."""
    import os
    import time

    from impop_tpu.extract import NativeExtractor
    from impop_tpu.extract.simulate import simulate

    sim = simulate(str(tmp_path), ref_len=8000, n_haps=8, seed=9,
                   site_pool=60, span=(0, 8000))
    with NativeExtractor(sim.paf_path, sim.fasta_path) as nat:
        base = nat.extract("CHM13#0#chr1", 1000, 5000)
    idx = sim.paf_path + ".impopidx"
    assert os.path.exists(idx), "index sidecar not written"

    # reopen: loads the sidecar; results must be identical
    with NativeExtractor(sim.paf_path, sim.fasta_path) as nat:
        again = nat.extract("CHM13#0#chr1", 1000, 5000)
    assert again.names == base.names
    assert again.site_keys == base.site_keys
    assert np.array_equal(again.geno, base.geno)

    # stale sidecar: regenerate the pangenome in place (different seed ->
    # different CIGARs); the old index must be rejected, not trusted
    time.sleep(0.01)
    sim2 = simulate(str(tmp_path), ref_len=8000, n_haps=8, seed=10,
                    site_pool=60, span=(0, 8000))
    with NativeExtractor(sim2.paf_path, sim2.fasta_path) as nat:
        fresh = nat.extract("CHM13#0#chr1", 1000, 5000)
    from impop_tpu.extract.pyfallback import PyExtractor

    py = PyExtractor(sim2.paf_path, sim2.fasta_path)
    want = py.extract("CHM13#0#chr1", 1000, 5000)
    assert fresh.names == want.names
    assert fresh.site_keys == want.site_keys
    assert np.array_equal(fresh.geno, want.geno)

    # IMPOP_PAF_INDEX=0 disables the cache entirely
    os.remove(idx)
    env = dict(os.environ, IMPOP_PAF_INDEX="0")
    import subprocess
    import sys

    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from impop_tpu.extract import NativeExtractor\n"
        "with NativeExtractor(%r, %r) as nat:\n"
        "    nat.extract('CHM13#0#chr1', 1000, 5000)\n"
    ) % ("/root/repo", sim2.paf_path, sim2.fasta_path)
    subprocess.run([sys.executable, "-c", code], env=env, check=True)
    assert not os.path.exists(idx)
