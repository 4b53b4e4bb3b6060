"""Command-line drivers.

One entry point (``python -m impop_tpu.cli`` or the ``impop-tpu`` script)
with subcommands mirroring the reference's seven bash drivers and Python
tools (SURVEY.md §2.1), plus the fused ``scan``:

  pi           run_pica2_impg.sh     π window scan
  hfst         run_h-fst.sh          Hudson Fst (direct), 8-column table
  hud          hudson/run_hud.sh     Hudson Fst, -m direct|grouped
  fst3pi       run_fst_impg.sh       3-π union Fst, 9-column table
  tajd         run_tajd.sh           S + π + Tajima's D, 6-column table
  afs          af.py                 allele-class cluster frequencies
  panels-tajd  run_tajd_panels.sh    5-panel Tajima batch
  panels-hfst  run_h_fst_panels.sh   10-pair Hudson batch
  makewindows  (bedtools capability) fixed-width BED windows
  plot         plot_*_trend.R        trend plots (π / Fst / Tajima's D)
  scan         —                     fused π+Fst+TajD+AFS from allele tiles

Inputs: similarity matrices come from per-window TSVs (``--sim-dir``, the
reference's own intermediate format) or live extraction via an ``impg``
binary when present (``--paf/--agc``); allele windows come from ``.npz``
tiles (``--geno-dir``, the native format emitted by the extraction layer).
Windows that fail to load are skipped with a warning, matching the
reference's per-window skip-and-continue (run_pica2_impg.sh:168-180).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from impop_tpu.io.bed import Region, make_windows, read_bed
from impop_tpu.io.panels import read_panel_file
from impop_tpu.io.simtsv import SimilarityMatrix, read_similarity_tsv
from impop_tpu.report import tables


def _warn(msg: str) -> None:
    print(msg, file=sys.stderr)


def _write_window_log(log_dir: str, region: str, title: str, payload: dict) -> None:
    """Two-channel output contract (SURVEY.md §5): the TSV table goes to
    stdout/-o, per-window debug detail goes to a log directory — the
    reference writes step-by-step math to <input>.log (pica2.py:186-206,
    h-fst.py:323-335); ours is one human-readable + machine-parseable file
    per window."""
    import json

    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{_sanitize(region)}.log")
    with open(path, "w") as fh:
        fh.write(f"{title}\n{'=' * len(title)}\n")
        for key, val in payload.items():
            fh.write(f"{key}: {val}\n")
        fh.write("\n" + json.dumps(payload) + "\n")


def _out_stream(path: Optional[str]):
    return open(path, "w") if path else sys.stdout


# --------------------------------------------------------------- sim sources


class WindowError(RuntimeError):
    pass


def _sanitize(region: str) -> str:
    return region.replace("#", "_").replace(":", "_").replace("-", "_")


class SimSource:
    """Resolve a region string to a SimilarityMatrix."""

    def load(self, region: str) -> SimilarityMatrix:
        raise NotImplementedError


class DirSimSource(SimSource):
    """Per-window TSVs in a directory.

    Tries ``<region>.sim``, ``<region>.tsv``, then sanitized variants
    (``#``/``:``/``-`` → ``_``).
    """

    def __init__(self, directory: str, round_digits: Optional[int]):
        self.directory = directory
        self.round_digits = round_digits

    def load(self, region: str) -> SimilarityMatrix:
        candidates = [
            f"{region}.sim", f"{region}.tsv",
            f"{_sanitize(region)}.sim", f"{_sanitize(region)}.tsv",
        ]
        for cand in candidates:
            path = os.path.join(self.directory, cand)
            if os.path.exists(path):
                return read_similarity_tsv(path, self.round_digits)
        raise WindowError(f"no similarity file for region {region} "
                          f"in {self.directory}")


class ImpgSimSource(SimSource):
    """Live extraction through an external ``impg`` binary (compat mode:
    exactly the reference's L1 call, run_pica2_impg.sh:162-168)."""

    def __init__(self, paf: str, agc: str, round_digits: Optional[int],
                 subset_list: Optional[str] = None):
        self.paf = paf
        self.agc = agc
        self.round_digits = round_digits
        self.subset_list = subset_list

    def load(self, region: str) -> SimilarityMatrix:
        cmd = ["impg", "similarity", "-p", self.paf, "-r", region,
               "--sequence-files", self.agc]
        if self.subset_list:
            cmd += ["--subset-sequence-list", self.subset_list]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=600)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise WindowError(f"impg similarity failed for {region}: {e}")
        if proc.returncode != 0:
            raise WindowError(f"impg similarity failed for {region}")
        import io as _io
        return read_similarity_tsv(_io.StringIO(proc.stdout),
                                   self.round_digits)


class GenoSimSource(SimSource):
    """Identity matrices derived from allele tiles (.npz windows or live
    native extraction from PAF+FASTA) — the impg-free path.

    The pairwise difference counts run on the DEVICE (stats/allele
    .pairwise_diff — the same kernel the fused scan uses); counts are exact
    integers in f32, so the final ``1 − diff/length`` division and decimal
    rounding stay host-side in f64, preserving the reference's
    round-half-even parity contract (io/simtsv.round_half_even).

    ``identity_mode`` selects the deviation spec of doc/how_stats.md:
    "events" (default) counts one difference per variant record; "columns"
    weighs indels by their base length, matching alignment-column identity.
    """

    def __init__(self, round_digits: Optional[int],
                 geno_dir: Optional[str] = None,
                 paf: Optional[str] = None, fasta: Optional[str] = None,
                 use_native: bool = True, gfa_dir: Optional[str] = None,
                 identity_mode: str = "events"):
        self.round_digits = round_digits
        self.identity_mode = identity_mode
        self.geno_src = (GenoSource(geno_dir) if geno_dir
                         else GfaDirSource(gfa_dir) if gfa_dir else None)
        self.extractor = None
        if paf and fasta:
            self.extractor = _open_extractor(paf, fasta, use_native)

    def load(self, region: str) -> SimilarityMatrix:
        from impop_tpu.io.bed import parse_region
        from impop_tpu.io.simtsv import SimilarityMatrix, round_half_even

        reg = parse_region(region)
        if self.geno_src is not None:
            geno, names, site_keys = self.geno_src.load(region)
        elif self.extractor is not None:
            wm = self.extractor.extract(reg.chrom, reg.start, reg.end)
            geno, names, site_keys = wm.geno, wm.names, wm.site_keys
        else:
            raise WindowError(f"no allele source for region {region}")
        order = np.argsort(names)
        geno = np.asarray(geno, dtype=np.int8)[order]
        names = [names[i] for i in order]
        n, s = geno.shape
        length = max(reg.length, 1)

        weights = None
        if self.identity_mode == "columns":
            if site_keys is None:
                _warn(f"Warning: no site keys for {region}; "
                      "columns identity falls back to events")
            else:
                from impop_tpu.extract import site_weights_from_keys

                weights = site_weights_from_keys(site_keys)

        cap_n = _capacity_for([n])
        cap_s = max(8, ((s + 127) // 128) * 128)
        g = np.full((cap_n, cap_s), -1, dtype=np.int8)
        g[:n, :s] = geno
        member = np.zeros(cap_n, bool); member[:n] = True
        smask = np.zeros(cap_s, bool); smask[:s] = True
        w = None
        if weights is not None:
            w = np.zeros(cap_s, np.float32)
            w[:s] = weights
        num_alleles = int(geno.max(initial=1)) + 1
        diff_d, compared_d = _pairwise_diff_jit(num_alleles)(
            g, member, smask, w
        )
        diff = np.asarray(diff_d, dtype=np.float64)[:n, :n]
        compared = np.asarray(compared_d, dtype=np.float64)[:n, :n]
        sim = 1.0 - diff / length
        present = compared > 0
        np.fill_diagonal(present, True)
        sim = np.where(present, sim, 0.0)
        np.fill_diagonal(sim, 1.0)
        if self.round_digits is not None:
            sim = round_half_even(sim, self.round_digits)
        return SimilarityMatrix(names=names, sim=sim, present=present,
                                pair_count=n * (n - 1) // 2)


import functools as _ft


@_ft.lru_cache(maxsize=8)
def _pairwise_diff_jit(num_alleles: int):
    import jax

    from impop_tpu.stats.allele import pairwise_diff

    def run(g, member, smask, w):
        return pairwise_diff(g, member, smask, num_alleles, w)

    jitted = jax.jit(run)
    jitted_nw = jax.jit(lambda g, m, s: pairwise_diff(g, m, s, num_alleles))

    def dispatch(g, member, smask, w):
        if w is None:
            return jitted_nw(g, member, smask)
        return jitted(g, member, smask, w)

    return dispatch


def _open_extractor(paf: str, fasta: str, use_native: bool = True):
    if use_native:
        try:
            from impop_tpu.extract import NativeExtractor

            return NativeExtractor(paf, fasta)
        except Exception as e:  # no toolchain / build failure
            _warn(f"Warning: native extractor unavailable ({e}); "
                  "using Python fallback")
    from impop_tpu.extract.pyfallback import PyExtractor

    return PyExtractor(paf, fasta)


def _resolve_fasta(args) -> Optional[str]:
    """--fasta, or --agc auto-converted once to a cached BGZF FASTA store
    (extract/agc.py) so AGC-format inputs run natively with no external impg
    (the reference shells to impg per window, run_pica2_impg.sh:162-168)."""
    fasta = getattr(args, "fasta", None)
    if fasta:
        return fasta
    agc = getattr(args, "agc", None)
    if agc:
        from impop_tpu.extract.agc import ensure_fasta_store

        return ensure_fasta_store(agc, getattr(args, "agc_bin", "agc"))
    return None


def _make_sim_source(args) -> SimSource:
    mode = getattr(args, "identity_mode", "events")
    if getattr(args, "sim_dir", None):
        return DirSimSource(args.sim_dir, args.round)
    if getattr(args, "geno_dir", None):
        return GenoSimSource(args.round, geno_dir=args.geno_dir,
                             identity_mode=mode)
    if getattr(args, "gfa_dir", None):
        return GenoSimSource(args.round, gfa_dir=args.gfa_dir,
                             identity_mode=mode)
    if getattr(args, "paf", None):
        if getattr(args, "agc", None) and getattr(args, "use_impg", False):
            return ImpgSimSource(args.paf, args.agc, args.round,
                                 getattr(args, "subset", None))
        fasta = _resolve_fasta(args)
        if fasta:
            return GenoSimSource(args.round, paf=args.paf, fasta=fasta,
                                 identity_mode=mode)
    raise SystemExit(
        "error: provide --sim-dir (per-window TSVs), --geno-dir (allele "
        "tiles), --paf + --fasta / --paf + --agc (native extraction), or "
        "--paf + --agc --use-impg (external impg compat)"
    )


class GenoSource:
    """Per-window allele tiles: ``<region>.npz`` with arrays ``geno``
    ([n, s] int8, -1 missing), ``names`` ([n] str) and optional
    ``site_keys`` ([s] str, "pos:ref>alt")."""

    def __init__(self, directory: str):
        self.directory = directory

    def load(self, region: str
             ) -> Tuple[np.ndarray, List[str], Optional[List[str]]]:
        for cand in (f"{region}.npz", f"{_sanitize(region)}.npz"):
            path = os.path.join(self.directory, cand)
            if os.path.exists(path):
                data = np.load(path, allow_pickle=False)
                names = [str(x) for x in data["names"]]
                keys = ([str(x) for x in data["site_keys"]]
                        if "site_keys" in data else None)
                return data["geno"].astype(np.int8), names, keys
        raise WindowError(f"no allele tile for region {region} "
                          f"in {self.directory}")


def split_multiallelic(geno: np.ndarray, keys: Optional[List[str]]
                       ) -> Tuple[np.ndarray, Optional[List[str]]]:
    """Normalise multiallelic tile columns to the native extractor's
    per-(pos, ref, alt) convention: a column with allele codes > 1 becomes
    one 0/1 indicator column per carried alt allele (carriers 1, other
    covered haplotypes 0, uncovered -1).

    The fused scan ships 2-bit biallelic codes over the wire
    (pack_scan_batch), but pica2's estimator is alphabet-agnostic
    (reference pica2.py:60-169) and ``--geno-dir`` tiles from other
    producers may carry codes {0, 1, 2, ...}.  Splitting reproduces
    exactly what the native extractor would have emitted for the same
    variation (each variant key its own column — doc/how_stats.md
    "Identity definition", deviation 2: two haplotypes with different alt
    alleles at one site differ at 2 matrix columns).  Split columns
    duplicate the source column's site key (same position, same indel
    weight).
    """
    if int(geno.max(initial=0)) <= 1:
        return geno, keys
    cols: List[np.ndarray] = []
    out_keys: Optional[List[str]] = [] if keys is not None else None
    for c in range(geno.shape[1]):
        col = geno[:, c]
        alts = np.unique(col[col > 0])
        if alts.size <= 1 and int(col.max(initial=0)) <= 1:
            cols.append(col)
            if out_keys is not None:
                out_keys.append(keys[c])
            continue
        valid = col >= 0
        for a in alts:
            cols.append(np.where(valid, (col == a).astype(np.int8),
                                 np.int8(-1)))
            if out_keys is not None:
                out_keys.append(keys[c])
    return np.stack(cols, axis=1), out_keys


class GfaDirSource:
    """Per-window variation graphs: ``<region>.gfa``, ingested through the
    graph path (impg query -o gfa → odgi → povu equivalents,
    run_pica2_odgi.sh:74-96) into the same allele tiles as GenoSource."""

    def __init__(self, directory: str, ref_path: Optional[str] = None):
        self.directory = directory
        self.ref_path = ref_path

    def load(self, region: str
             ) -> Tuple[np.ndarray, List[str], Optional[List[str]]]:
        from impop_tpu.extract.gfa import alleles_from_gfa, read_gfa

        for cand in (f"{region}.gfa", f"{_sanitize(region)}.gfa"):
            path = os.path.join(self.directory, cand)
            if os.path.exists(path):
                wm, _ = alleles_from_gfa(read_gfa(path),
                                         ref_path=self.ref_path,
                                         include_ref_row=True)
                return wm.geno, wm.names, wm.site_keys
        raise WindowError(f"no window GFA for region {region} "
                          f"in {self.directory}")


# --------------------------------------------------------------- batching


def _capacity_for(n_values: Sequence[int], floor: int = 64) -> int:
    cap = max([floor] + list(n_values))
    # round up to a lane-friendly multiple
    m = 128 if cap > 64 else 64
    return ((cap + m - 1) // m) * m


def _load_windows(
    regions: Sequence[Region],
    src: SimSource,
    prefix: str,
) -> Tuple[List[Region], List[SimilarityMatrix], List[str]]:
    kept: List[Region] = []
    mats: List[SimilarityMatrix] = []
    region_strings: List[str] = []
    errors = 0
    for reg in regions:
        rs = reg.region_string(prefix)
        try:
            mats.append(src.load(rs))
        except WindowError as e:
            _warn(f"Warning: {e}; skipping window")
            errors += 1
            continue
        kept.append(reg)
        region_strings.append(rs)
    _print_counters(len(kept), errors)
    return kept, mats, region_strings


def _print_counters(ok: int, errors: int) -> None:
    """End-of-run success/error counters — the reference drivers keep and
    print these (run_h-fst.sh:151-203, run_pica2_impg.sh:168-180)."""
    _warn(f"Processed: {ok + errors} windows "
          f"(success: {ok}, errors: {errors})")


# --------------------------------------------------------------- pi


def cmd_pi(args) -> int:
    from impop_tpu.parallel.scan import batch_pi_panels
    from impop_tpu.runtime.batcher import PanelSet, build_window_batch

    regions = read_bed(args.bed)
    src = _make_sim_source(args)
    kept, mats, region_strings = _load_windows(regions, src, args.prefix)
    if not kept:
        _warn("Warning: no windows could be processed")

    subset_label = os.path.basename(args.subset) if args.subset else None
    panels = (
        PanelSet.from_dict({"S": tuple(read_panel_file(args.subset))})
        if args.subset else None
    )

    out = _out_stream(args.output)
    try:
        print(tables.pi_table_header(subset_label is not None), file=out)
        if not kept:
            return 0
        cap = _capacity_for([m.n for m in mats])
        batch, _ = build_window_batch(mats, panels, capacity=cap)
        res = batch_pi_panels(batch.sim, batch.present, batch.member,
                              batch.panels, args.threshold)
        pi = np.asarray(res.pi)[:, 0]
        n_v = np.asarray(res.n)[:, 0]
        groups_v = np.asarray(res.num_groups)[:, 0]
        used_v = np.asarray(res.pairs_used)[:, 0]
        miss_v = np.asarray(res.pairs_missing)[:, 0]
        for wi, reg in enumerate(kept):
            length = args.length or reg.length
            pica = tables.format_pica_output(
                float(pi[wi]), float(pi[wi]) / length, length
            )
            print(tables.pi_row(region_strings[wi], subset_label, length,
                                args.threshold, args.round, pica), file=out)
            if args.log_dir:
                _write_window_log(
                    args.log_dir, region_strings[wi],
                    "Nucleotide Diversity Analysis Log",
                    {
                        "region": region_strings[wi],
                        "threshold": args.threshold,
                        "round_digits": args.round,
                        "n": int(n_v[wi]),
                        "groups": int(groups_v[wi]),
                        "group_pairs_with_data": int(used_v[wi]),
                        "group_pairs_missing": int(miss_v[wi]),
                        "pi": float(pi[wi]),
                        "pi_per_site": float(pi[wi]) / length,
                    },
                )
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


# --------------------------------------------------------------- hudson fst


def _two_panel_batch(args, mats, exact=False):
    from impop_tpu.runtime.batcher import PanelSet, build_window_batch

    pop_a = read_panel_file(args.pop_a)
    pop_b = read_panel_file(args.pop_b)
    panels = PanelSet.from_dict({"A": tuple(pop_a), "B": tuple(pop_b)})
    cap = _capacity_for([m.n for m in mats])
    return build_window_batch(mats, panels, capacity=cap,
                              exact_names=exact)[0]


def _load_geno_windows(args, regions):
    """Allele-tile windows (geno, sorted names) for the pair-shard path."""
    geno_src = (GenoSource(args.geno_dir)
                if getattr(args, "geno_dir", None) else None)
    extractor = None
    if geno_src is None:
        fasta_store = _resolve_fasta(args)
        if args.paf and fasta_store:
            extractor = _open_extractor(args.paf, fasta_store)
    if geno_src is None and extractor is None:
        return None
    kept, tiles, rss = [], [], []
    for reg in regions:
        rs = reg.region_string(args.prefix)
        try:
            if geno_src is not None:
                g, names, _ = geno_src.load(rs)
            else:
                wm = extractor.extract(rs.rsplit(":", 1)[0],
                                       reg.start, reg.end)
                g, names = wm.geno, wm.names
        except Exception as e:
            print(f"Warning: skipping window {rs}: {e}", file=sys.stderr)
            continue
        order = np.argsort(names)
        tiles.append((np.asarray(g, np.int8)[order],
                      [names[i] for i in order]))
        kept.append(reg)
        rss.append(rs)
    return kept, tiles, rss


def _run_hudson_pair_sharded(args, force: bool) -> Optional[int]:
    """Direct-method Hudson with the pair space sharded by row blocks over
    the local devices (parallel/pairspace.py): each device computes only
    its [N/D, N] block of pairwise differences and partial sums merge with
    psum — the [N, N] identity matrix never materialises anywhere.  For
    haplotype counts past a few thousand this is the scaling path the
    replicated [N, N] batch cannot take (SURVEY §2.3 row 3,
    h-fst.py:141-151).  Output schema and host-side f64 derivations match
    the replicated path; only f32 summation order differs.

    Returns None when ``force`` is False and every window is below the
    sharding threshold (caller falls back to the replicated batch path).
    """
    import jax

    from impop_tpu.io.panels import expand_population
    from impop_tpu.parallel.mesh import make_mesh
    from impop_tpu.parallel.pairspace import pair_sharded_direct_stats

    regions = read_bed(args.bed)
    loaded = _load_geno_windows(args, regions)
    if loaded is None:
        if force:
            raise SystemExit("error: --pair-shard on needs an allele "
                             "source (--geno-dir or --paf + --fasta/--agc)")
        return None
    kept, tiles, region_strings = loaded
    max_n = max((g.shape[0] for g, _ in tiles), default=0)
    if not force and max_n < 1024:
        return None

    if getattr(args, "round", None) is not None:
        _warn("Warning: --pair-shard computes masked pair sums without "
              "materialising per-pair similarities, so -r rounding does "
              "not apply (use the replicated path for -r parity)")
    n_dev = len(jax.local_devices())
    mesh = make_mesh(data=n_dev)
    pair_fn = pair_sharded_direct_stats(mesh)
    pop_a = read_panel_file(args.pop_a)
    pop_b = read_panel_file(args.pop_b)

    # one compile: pad every window to shared caps (rows to a multiple of
    # the mesh axis, sites to the lane width)
    cap_n = _capacity_for([max_n])
    cap_n = ((cap_n + n_dev - 1) // n_dev) * n_dev
    cap_s = max(128, max((g.shape[1] for g, _ in tiles), default=1))
    cap_s = ((cap_s + 127) // 128) * 128

    out = _out_stream(args.output)
    try:
        print(tables.HFST_HEADER, file=out)
        for reg, (g, names), rs in zip(kept, tiles, region_strings):
            n, s = g.shape
            gp = np.full((cap_n, cap_s), -1, np.int8)
            gp[:n, :s] = g
            member = np.zeros(cap_n, bool)
            member[:n] = True
            smask = np.zeros(cap_s, bool)
            smask[:s] = True
            if args.exact_names:
                in_a = set(pop_a)
                in_b = set(pop_b)
                sel_a = np.asarray([nm in in_a for nm in names], bool)
                sel_b = np.asarray([nm in in_b for nm in names], bool)
            else:
                m_a, _ = expand_population(pop_a, names)
                m_b, _ = expand_population(pop_b, names)
                sel_a = np.asarray([nm in m_a for nm in names], bool)
                sel_b = np.asarray([nm in m_b for nm in names], bool)
            overlap = sel_a & sel_b          # h-fst.py:181-185 strip
            mask_a = np.zeros((1, cap_n), bool)
            mask_b = np.zeros((1, cap_n), bool)
            mask_a[0, :n] = sel_a & ~overlap
            mask_b[0, :n] = sel_b & ~overlap
            res = pair_fn(gp, member, smask, mask_a, mask_b,
                          float(reg.length))
            pi_a = float(np.asarray(res[0], np.float64)[0])
            pi_b = float(np.asarray(res[1], np.float64)[0])
            dxy = float(np.asarray(res[2], np.float64)[0])
            pi_xy = 0.5 * (pi_a + pi_b)
            fst = (dxy - pi_xy) / dxy if dxy > 0 else 0.0
            da = dxy - pi_xy
            inv = 1.0 / reg.length
            print(tables.hfst_row(
                rs, reg.length, fst,
                pi_a * inv, pi_b * inv, pi_xy * inv, dxy * inv, da * inv,
            ), file=out)
            if args.log_dir:
                _write_window_log(
                    args.log_dir, rs, "FST Calculation",
                    {
                        "region": rs, "method": "direct (pair-sharded)",
                        "devices": n_dev,
                        "pi_a": pi_a, "pi_b": pi_b, "pi_xy": pi_xy,
                        "dxy": dxy, "fst": fst, "da": da,
                        "per_site_length": reg.length,
                    },
                )
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def _run_hudson(args, grouped: bool) -> int:
    import jax.numpy as jnp

    from impop_tpu.parallel.scan import batch_hudson

    ps_mode = getattr(args, "pair_shard", "off")
    if ps_mode != "off" and not grouped:
        import jax

        if ps_mode == "on" or len(jax.local_devices()) > 1:
            done = _run_hudson_pair_sharded(args, force=(ps_mode == "on"))
            if done is not None:
                return done
    elif ps_mode == "on" and grouped:
        raise SystemExit("error: --pair-shard supports the direct method "
                         "only (the grouped estimators need the global "
                         "[N, N] grouping recurrence)")

    regions = read_bed(args.bed)
    src = _make_sim_source(args)
    kept, mats, region_strings = _load_windows(regions, src, args.prefix)

    out = _out_stream(args.output)
    try:
        print(tables.HFST_HEADER, file=out)
        if not kept:
            return 0
        batch = _two_panel_batch(args, mats, exact=args.exact_names)
        res = batch_hudson(
            batch.sim, batch.present, batch.member, batch.panels,
            jnp.asarray([0], jnp.int32), jnp.asarray([1], jnp.int32),
            args.threshold, with_grouped=grouped,
        )
        chosen = res.grouped if grouped else res.direct
        pi_a_v = np.asarray(chosen.pi_a, dtype=np.float64)[:, 0]
        pi_b_v = np.asarray(chosen.pi_b, dtype=np.float64)[:, 0]
        dxy_v = np.asarray(chosen.dxy, dtype=np.float64)[:, 0]
        for wi, reg in enumerate(kept):
            length = reg.length
            # derived quantities recomputed host-side in f64 (the reference
            # is all-f64; this avoids extra f32 cancellation in fst/da,
            # h-fst.py:203-215)
            pi_a, pi_b, dxy = pi_a_v[wi], pi_b_v[wi], dxy_v[wi]
            pi_xy = 0.5 * (pi_a + pi_b)
            fst = (dxy - pi_xy) / dxy if dxy > 0 else 0.0
            da = dxy - pi_xy
            inv = 1.0 / length
            print(tables.hfst_row(
                region_strings[wi], length, fst,
                pi_a * inv, pi_b * inv, pi_xy * inv, dxy * inv, da * inv,
            ), file=out)
            if args.log_dir:
                _write_window_log(
                    args.log_dir, region_strings[wi], "FST Calculation",
                    {
                        "region": region_strings[wi],
                        "method": "grouped" if grouped else "direct",
                        "pi_a": pi_a, "pi_b": pi_b, "pi_xy": pi_xy,
                        "dxy": dxy, "fst": fst, "da": da,
                        "per_site_length": length,
                    },
                )
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def cmd_hfst(args) -> int:
    return _run_hudson(args, grouped=False)


def cmd_hud(args) -> int:
    return _run_hudson(args, grouped=(args.method == "grouped"))


# --------------------------------------------------------------- 3-pi fst


def cmd_fst3pi(args) -> int:
    import jax.numpy as jnp

    from impop_tpu.parallel.scan import batch_fst_3pi_panels

    regions = read_bed(args.bed)
    src = _make_sim_source(args)
    kept, mats, region_strings = _load_windows(regions, src, args.prefix)

    out = _out_stream(args.output)
    try:
        print(tables.FST3PI_HEADER, file=out)
        if not kept:
            return 0
        batch = _two_panel_batch(args, mats, exact=args.exact_names)
        res = batch_fst_3pi_panels(
            batch.sim, batch.present, batch.member, batch.panels,
            jnp.asarray([0], jnp.int32), jnp.asarray([1], jnp.int32),
            args.threshold,
        )
        for wi, reg in enumerate(kept):
            length = reg.length
            print(tables.fst3pi_row(
                region_strings[wi], length, args.threshold, args.round,
                float(res.pi_a[wi, 0]) / length,
                float(res.pi_b[wi, 0]) / length,
                float(res.pi_c[wi, 0]) / length,
            ), file=out)
            if args.log_dir:
                pi_a = float(res.pi_a[wi, 0]) / length
                pi_b = float(res.pi_b[wi, 0]) / length
                pi_c = float(res.pi_c[wi, 0]) / length
                pi_ab = 0.5 * (pi_a + pi_b)
                _write_window_log(
                    args.log_dir, region_strings[wi], "3-pi FST Calculation",
                    {
                        "region": region_strings[wi],
                        "length": length,
                        "threshold": args.threshold,
                        "pi_a": pi_a, "pi_b": pi_b, "pi_c": pi_c,
                        "pi_ab": pi_ab,
                        "fst": ((pi_c - pi_ab) / pi_c if pi_c else "NA"),
                    },
                )
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


# --------------------------------------------------------------- tajima's d


def _tajd_streamed(args, regions) -> int:
    """One chromosome-scale window streamed through the device in site
    chunks (runtime/sitestream.py) — the no-length-cap regime the reference
    cannot reach (impg caps windows at ~10 kb, doc/how_pi.md:40).  The
    allele matrix is a memory-mapped [N, S] int8 .npy, so neither host nor
    device ever holds the full site axis."""
    from impop_tpu.runtime.sitestream import SiteStreamAccumulator

    if len(regions) != 1:
        raise SystemExit("error: --stream-npy processes exactly one window "
                         f"(BED has {len(regions)} rows)")
    reg = regions[0]
    rs = reg.region_string(args.prefix)
    geno = np.load(args.stream_npy, mmap_mode="r")
    if geno.ndim != 2:
        raise SystemExit("error: --stream-npy must be a 2-D [N, S] matrix")
    n_rows, s_total = geno.shape

    names = None
    if getattr(args, "stream_names", None):
        names = read_panel_file(args.stream_names)
        if len(names) != n_rows:
            raise SystemExit(f"error: {len(names)} names for {n_rows} rows")
    # deterministic seed order = sorted sequence-name row order
    order = (np.argsort(names) if names is not None
             else np.arange(n_rows))
    # S (and the accumulated counts) cover ALL rows — the reference counts
    # segregating sites over the whole window graph (run_tajd.sh:148); a -s
    # subset restricts only the grouped-π membership at finalize, exactly
    # like the batched --geno-dir path's panel mask (cmd_tajd panels[wi,0])
    member = np.ones(n_rows, bool)
    pi_member = None
    if args.samples:
        if names is None:
            raise SystemExit("error: -s filtering needs --stream-names")
        from impop_tpu.io.panels import expand_population

        sorted_names = [names[i] for i in order]
        matched, _ = expand_population(read_panel_file(args.samples),
                                       sorted_names)
        pi_member = np.asarray([nm in matched for nm in sorted_names], bool)

    length = args.length or reg.length
    chunk = max(128, args.chunk_sites)
    acc = SiteStreamAccumulator(member, chunk_s=chunk)
    for lo in range(0, s_total, chunk):
        acc.update(np.ascontiguousarray(geno[order, lo:lo + chunk]))
    st = acc.finalize(float(length), args.threshold, pi_member=pi_member)

    n_val = int(np.asarray(st.n))
    s_val = int(np.asarray(st.s))
    pi_val = float(np.asarray(st.pi_site))
    d_val = float(np.asarray(st.d))
    out = _out_stream(args.output)
    try:
        print(tables.TAJD_HEADER, file=out)
        print(tables.tajd_row(rs, int(length), n_val, s_val, pi_val, d_val),
              file=out)
    finally:
        if out is not sys.stdout:
            out.close()
    if args.log_dir:
        _write_window_log(args.log_dir, rs, "Tajima's D Calculation",
                          {"region": rs, "length": int(length),
                           "threshold": args.threshold, "n": n_val,
                           "segregating_sites": s_val,
                           "pi_per_site": pi_val,
                           "tajimas_d": "NA" if np.isnan(d_val) else d_val,
                           "site_chunks": (s_total + chunk - 1) // chunk})
    return 0


def cmd_tajd(args) -> int:
    import jax.numpy as jnp

    from impop_tpu.parallel.scan import batch_tajd_from_alleles

    regions = read_bed(args.bed)
    if getattr(args, "stream_npy", None):
        return _tajd_streamed(args, regions)
    if not args.geno_dir and not getattr(args, "gfa_dir", None):
        raise SystemExit("error: provide --geno-dir or --gfa-dir")
    geno_src = (GenoSource(args.geno_dir) if args.geno_dir
                else GfaDirSource(args.gfa_dir))
    sample_list = read_panel_file(args.samples) if args.samples else None

    kept: List[Region] = []
    tiles: List[Tuple[np.ndarray, List[str], Optional[List[str]]]] = []
    region_strings: List[str] = []
    n_err = 0
    for reg in regions:
        rs = reg.region_string(args.prefix)
        try:
            tiles.append(geno_src.load(rs))
        except WindowError as e:
            _warn(f"Warning: {e}; skipping window")
            n_err += 1
            continue
        kept.append(reg)
        region_strings.append(rs)
    _print_counters(len(kept), n_err)

    out = _out_stream(args.output)
    try:
        print(tables.TAJD_HEADER, file=out)
        if not kept:
            return 0
        cap_n = _capacity_for([t[0].shape[0] for t in tiles])
        cap_s = max(8, max(t[0].shape[1] for t in tiles))
        cap_s = ((cap_s + 127) // 128) * 128
        w = len(tiles)
        geno = np.full((w, cap_n, cap_s), -1, dtype=np.int8)
        member = np.zeros((w, cap_n), dtype=bool)
        site_mask = np.zeros((w, cap_s), dtype=bool)
        panels = np.zeros((w, 1, cap_n), dtype=bool)
        lengths = np.zeros((w,), dtype=np.float32)
        for wi, ((g, names, _keys), reg) in enumerate(zip(tiles, kept)):
            order = np.argsort(names)
            g = g[order]
            names = [names[i] for i in order]
            n, s = g.shape
            geno[wi, :n, :s] = g
            member[wi, :n] = True
            site_mask[wi, :s] = True
            lengths[wi] = args.length or reg.length
            if sample_list is None:
                panels[wi, 0, :n] = True
            else:
                from impop_tpu.io.panels import expand_population
                matched, _ = expand_population(sample_list, names)
                for i, nm in enumerate(names):
                    if nm in matched:
                        panels[wi, 0, i] = True
        res = batch_tajd_from_alleles(
            jnp.asarray(geno), jnp.asarray(member), jnp.asarray(site_mask),
            jnp.asarray(panels), lengths, args.threshold,
        )
        for wi, reg in enumerate(kept):
            n_val = int(np.asarray(res.n)[wi, 0])
            s_val = int(np.asarray(res.s)[wi])
            pi_val = float(np.asarray(res.pi)[wi, 0])
            d_val = float(np.asarray(res.d)[wi, 0])
            print(tables.tajd_row(
                region_strings[wi], int(lengths[wi]), n_val, s_val,
                pi_val, d_val,
            ), file=out)
            if args.log_dir:
                _write_window_log(
                    args.log_dir, region_strings[wi],
                    "Tajima's D Calculation",
                    {
                        "region": region_strings[wi],
                        "length": int(lengths[wi]),
                        "threshold": args.threshold,
                        "n": n_val,
                        "segregating_sites": s_val,
                        "pi_per_site": pi_val,
                        "tajimas_d": ("NA" if np.isnan(d_val)
                                      else d_val),
                    },
                )
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


# --------------------------------------------------------------- afs


def cmd_afs(args) -> int:
    import jax

    from impop_tpu.stats.grouping import label_components

    # af.py truncates identifiers at the first ':' (af.py:13-14)
    mat = read_similarity_tsv(args.input)
    short = [n.split(":", 1)[0] for n in mat.names]
    uniq = sorted(set(short))
    idx = {n: i for i, n in enumerate(uniq)}
    n = len(uniq)
    sim = np.zeros((n, n)); present = np.zeros((n, n), dtype=bool)
    np.fill_diagonal(present, True); np.fill_diagonal(sim, 1.0)
    for i in range(mat.n):
        for j in range(mat.n):
            if i != j and mat.present[i, j]:
                a, b = idx[short[i]], idx[short[j]]
                sim[a, b] = max(sim[a, b], mat.sim[i, j]) if present[a, b] and a != b else mat.sim[i, j]
                present[a, b] = True

    cap = _capacity_for([n])
    sim_p = np.zeros((cap, cap), dtype=np.float32); sim_p[:n, :n] = sim
    pres_p = np.zeros((cap, cap), dtype=bool); pres_p[:n, :n] = present
    member = np.zeros(cap, dtype=bool); member[:n] = True
    # af.py links pairs with value >= threshold (af.py:38)
    adj = (sim_p >= args.threshold) & pres_p
    labels = np.asarray(jax.jit(label_components)(adj, member))[:n]

    groups: Dict[int, List[str]] = {}
    for i, name in enumerate(uniq):
        groups.setdefault(int(labels[i]), []).append(name)
    clusters = sorted(groups.values(), key=lambda c: (-len(c), sorted(c)))

    out = _out_stream(args.output)
    try:
        print(tables.AFS_HEADER, file=out)
        for row in tables.afs_summary_rows(clusters):
            print(row, file=out)
    finally:
        if out is not sys.stdout:
            out.close()

    if args.details:
        with open(args.details, "w") as fh:
            fh.write("sample_id\tcluster_id\tthreshold\n")
            for ci, members in enumerate(clusters, 1):
                for s in sorted(members):
                    fh.write(f"{s}\tc{ci}\t{args.threshold}\n")
    return 0


# --------------------------------------------------------------- batches


def _panel_label(path: str) -> str:
    """Panel column label from a panel-list filename.

    Reference panel lists are named ``agc.EUR`` (run_tajd_panels.sh:60-66) —
    the group is the last dot-component.  For conventionally-named files
    (``panA.txt``) the last component is a generic extension, so use the stem.
    """
    base = os.path.basename(path)
    parts = base.split(".")
    if len(parts) > 1 and parts[-1].lower() not in (
        "txt", "list", "tsv", "csv", "samples"
    ):
        return parts[-1]
    return parts[0]


def cmd_panels_hfst(args) -> int:
    """All 10 unordered continental pairs (run_h_fst_panels.sh:60-71)."""
    pairs = [("EUR", "AFR"), ("EAS", "AFR"), ("SAS", "AFR"), ("AMR", "AFR"),
             ("EAS", "EUR"), ("SAS", "EUR"), ("AMR", "EUR"), ("EAS", "SAS"),
             ("AMR", "SAS"), ("AMR", "EAS")]
    for a, b in pairs:
        sub = argparse.Namespace(**vars(args))
        sub.pop_a = os.path.join(args.metadata_dir, f"agc.{a}")
        sub.pop_b = os.path.join(args.metadata_dir, f"agc.{b}")
        sub.output = f"{a.lower()}.{b.lower()}.fst"
        if not (os.path.exists(sub.pop_a) and os.path.exists(sub.pop_b)):
            _warn(f"Warning: missing panel list for {a} or {b}; skipping")
            continue
        print(f"[h-fst] {a} vs {b} -> {sub.output}", file=sys.stderr)
        cmd_hfst(sub)
    return 0


def cmd_panels_tajd(args) -> int:
    """The 5 continental panels (run_tajd_panels.sh:60-66)."""
    panels = [("EUR", "eur.tj"), ("AFR", "afr.tj"), ("EAS", "eas.tj"),
              ("SAS", "sas.tj"), ("AMR", "amr.tj")]
    for group, output in panels:
        sub = argparse.Namespace(**vars(args))
        sub.samples = os.path.join(args.metadata_dir, f"agc.{group}")
        sub.output = output
        if not os.path.exists(sub.samples):
            _warn(f"Warning: missing panel list for {group}; skipping")
            continue
        print(f"[tajd] {group} -> {output}", file=sys.stderr)
        cmd_tajd(sub)
    return 0


# --------------------------------------------------------------- scan (fused)
#
# Device programs live at module scope so they outlive one cmd_scan call:
# jax.jit keys on function identity, and rebuilding the step closure per
# scan (a journal-resumed rerun, a second scan in the same process)
# recompiled a 15-170 s program for identical shapes.
#
# The scan ships ONE fused uint8 buffer per window batch: one device_put
# per batch instead of six, and bit-packing member/site/panel masks (8x)
# plus 2-bit allele codes (4x) cuts the host-to-device payload to ~1/4.
# The device unpacks everything in one fused elementwise prologue of the
# step program.


def _scan_buf_layout(cap_n: int, cap_s: int, p_count: int,
                     use_weights: bool, use_ehh: bool = False
                     ) -> Dict[str, int]:
    """Byte offsets of the per-window fused input buffer.

    Segments: 2-bit allele codes, member bitmask, site bitmask, panel
    bitmasks, window length (uint32 LE), optional site weights (f32 LE —
    full precision: weights are indel base lengths and an integer wire
    type would silently clamp SVs > its range; 4*cap_s bytes is noise
    next to the geno segment), optional EHH focal column index
    (uint32 LE — `scan --ehh`).
    cap_n % 8 == 0 and cap_s % 128 == 0 by _capacity_for / cap rounding.
    """
    o_g = 0
    o_m = o_g + cap_n * (cap_s // 4)
    o_sm = o_m + cap_n // 8
    o_p = o_sm + cap_s // 8
    o_l = o_p + p_count * (cap_n // 8)
    o_w = o_l + 4
    o_f = o_w + (4 * cap_s if use_weights else 0)
    total = o_f + (4 if use_ehh else 0)
    return {"g": o_g, "m": o_m, "sm": o_sm, "p": o_p, "l": o_l, "w": o_w,
            "f": o_f, "total": total}


def pack_scan_batch(geno: np.ndarray, member: np.ndarray, smask: np.ndarray,
                    panels: np.ndarray, lengths: np.ndarray,
                    wts: Optional[np.ndarray],
                    use_weights: bool,
                    focals: Optional[np.ndarray] = None) -> np.ndarray:
    """Host-side fused pack -> [w, K] uint8 (layout: _scan_buf_layout).

    Runs on the prefetch worker thread; pure numpy, no device access.
    """
    w, cap_n, cap_s = geno.shape
    if geno.max(initial=-1) > 1:
        raise SystemExit("error: scan is biallelic (allele codes 0/1); "
                         "got a code > 1 in the allele tiles")
    # uint8 view + wrapping add: -1 -> 0, 0 -> 1, 1 -> 2 (no widening temp)
    codes = np.ascontiguousarray(geno).view(np.uint8) + np.uint8(1)
    c = codes.reshape(w, cap_n, -1, 4)
    g2 = c[..., 0].copy()
    g2 |= c[..., 1] << 2
    g2 |= c[..., 2] << 4
    g2 |= c[..., 3] << 6
    segs = [
        g2.reshape(w, -1),
        np.packbits(member, axis=-1, bitorder="little"),
        np.packbits(smask, axis=-1, bitorder="little"),
        np.packbits(panels, axis=-1, bitorder="little").reshape(w, -1),
        np.ascontiguousarray(lengths.astype(np.uint32)).view(np.uint8)
        .reshape(w, 4),
    ]
    if use_weights:
        segs.append(
            np.ascontiguousarray(wts.astype(np.float32))
            .view(np.uint8).reshape(w, -1)
        )
    if focals is not None:
        segs.append(
            np.ascontiguousarray(focals.astype(np.uint32))
            .view(np.uint8).reshape(w, 4)
        )
    return np.concatenate(segs, axis=1)


import functools as _functools


def _wire_unpacker(cap_n: int, cap_s: int, p_count: int, use_weights: bool,
                   use_ehh: bool = False):
    """Device-side decoder of the fused wire buffer (_scan_buf_layout):
    one traced fn flat[K] -> (geno, member, smask, panels, length, wts,
    focal), shared by the fused scan step and the exact-FSTG recompute
    step."""
    import jax
    import jax.numpy as jnp

    lay = _scan_buf_layout(cap_n, cap_s, p_count, use_weights, use_ehh)
    bitsh = jnp.arange(8, dtype=jnp.uint8)

    def unpack_bits(seg, n):
        b = (seg[:, None] >> bitsh[None, :]) & jnp.uint8(1)
        return b.reshape(-1)[:n].astype(bool)

    def unpack(flat):
        gp = flat[lay["g"]:lay["m"]].reshape(cap_n, cap_s // 4)
        shifts = jnp.asarray([0, 2, 4, 6], jnp.uint8)
        codes = (gp[:, :, None] >> shifts[None, None, :]) & jnp.uint8(3)
        g = codes.reshape(cap_n, cap_s).astype(jnp.int8) - 1
        m = unpack_bits(flat[lay["m"]:lay["sm"]], cap_n)
        smask = unpack_bits(flat[lay["sm"]:lay["p"]], cap_s)
        pb = flat[lay["p"]:lay["l"]].reshape(p_count, cap_n // 8)
        panels1 = (((pb[:, :, None] >> bitsh[None, None, :]) & jnp.uint8(1))
                   .reshape(p_count, cap_n).astype(bool))
        lb = flat[lay["l"]:lay["l"] + 4].astype(jnp.uint32)
        length = (lb[0] | (lb[1] << 8) | (lb[2] << 16)
                  | (lb[3] << 24)).astype(jnp.float32)
        if use_weights:
            wb = flat[lay["w"]:lay["w"] + 4 * cap_s].reshape(
                cap_s, 4).astype(jnp.uint32)
            bits = (wb[:, 0] | (wb[:, 1] << 8) | (wb[:, 2] << 16)
                    | (wb[:, 3] << 24))
            wts = jax.lax.bitcast_convert_type(bits, jnp.float32)
        else:
            wts = None
        if use_ehh:
            fb = flat[lay["f"]:lay["f"] + 4].astype(jnp.uint32)
            focal = (fb[0] | (fb[1] << 8) | (fb[2] << 16)
                     | (fb[3] << 24)).astype(jnp.int32)
        else:
            focal = None
        return g, m, smask, panels1, length, wts, focal

    return unpack


def _shard_windows(fn, devs):
    """shard_map a vmapped per-window fn over the local `data` mesh axis."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from impop_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(data=len(devs), devices=list(devs))
    return shard_map(fn, mesh=mesh, in_specs=(P("data"),),
                     out_specs=P("data"))


@_functools.lru_cache(maxsize=32)
def _scan_step_fstg_exact(cap_n: int, cap_s: int, p_count: int,
                          pair_key: tuple, threshold: float,
                          use_weights: bool, devs: tuple):
    """Exact grouped-Hudson recompute for seed-risk windows.

    Same wire prologue as _scan_step, then the exact first-found-pair
    representative semantics (stats/fst.hudson_fst_grouped_pairs ==
    reference hud.py:88-98, 235-263) instead of the fused
    seed-representative rows.  Returns [w, Q] FSTG.  Compiled lazily —
    only scans that actually hit a partial-coverage window (flagged by
    PanelStats.seed_risk) ever build it.
    """
    import jax
    import jax.numpy as jnp

    from impop_tpu.stats.allele import identity_from_alleles
    from impop_tpu.stats.fst import hudson_fst_grouped_pairs

    unpack = _wire_unpacker(cap_n, cap_s, p_count, use_weights)
    pair_a = jnp.asarray([a for a, _ in pair_key], jnp.int32)
    pair_b = jnp.asarray([b for _, b in pair_key], jnp.int32)
    t = jnp.float32(threshold)

    def one_window(flat):
        g, m, smask, panels1, length, wts, _focal = unpack(flat)
        sim, present = identity_from_alleles(g, m, smask, length,
                                             site_weights=wts)
        ma = panels1[pair_a] & m[None, :]
        mb = panels1[pair_b] & m[None, :]
        ov = ma & mb
        ma = ma & ~ov
        mb = mb & ~ov
        return hudson_fst_grouped_pairs(
            sim, present, ma, mb, t).fst.astype(jnp.float32)

    fn = jax.vmap(one_window)
    if len(devs) > 1:
        fn = _shard_windows(fn, devs)
    return jax.jit(fn)


@_functools.lru_cache(maxsize=32)
def _scan_step(cap_n: int, cap_s: int, p_count: int, pair_key: tuple,
               threshold: float, use_weights: bool, want_afs: bool,
               afs_bins: int, afs_folded: bool, pairs_disjoint: bool,
               devs: tuple, want_ehh: bool = False):
    """Compiled fused scan step for one (shape, config) signature.

    Returns a jitted fn mapping the fused uint8 batch buffer [w, K] to the
    packed f32 result rows [w, R] (see cmd_scan for the row layout).  On
    multiple local devices the window axis is shard_mapped over a `data`
    mesh axis.
    """
    import jax
    import jax.numpy as jnp

    from impop_tpu.stats.allele import (identity_from_alleles, panel_afs,
                                        segregating_sites)
    from impop_tpu.stats.panelstats import (fused_panel_stats,
                                            fused_window_stats)
    from impop_tpu.stats.tajima import tajimas_d

    pair_a = jnp.asarray([a for a, _ in pair_key] or [0], jnp.int32)
    pair_b = jnp.asarray([b for _, b in pair_key] or [0], jnp.int32)
    with_pairs = bool(pair_key)
    t = jnp.float32(threshold)
    unpack = _wire_unpacker(cap_n, cap_s, p_count, use_weights, want_ehh)

    def one_window(flat):
        # fused unpack of the wire format (one elementwise prologue)
        g, m, smask, panels1, length, wts, focal = unpack(flat)

        if wts is None:
            # unit weights: identity + grouping + group weights + panel
            # reduction + S (stats/panelstats.fused_window_stats)
            _sim, _present, s_countf, res = fused_window_stats(
                g, m, smask, length, panels1, pair_a, pair_b, t,
                pairs_disjoint=pairs_disjoint, return_matrices=False)
        else:
            sim, present = identity_from_alleles(g, m, smask, length,
                                                 site_weights=wts)
            s_countf = segregating_sites(g, m, smask).astype(jnp.float32)
            res = fused_panel_stats(sim, present, m, panels1, pair_a,
                                    pair_b, t,
                                    pairs_disjoint=pairs_disjoint)
        pi_panel = res.pi[:p_count]
        pi_c = res.pi[p_count:]
        d = tajimas_d(res.n[:p_count], s_countf, pi_panel / length)
        fst = res.hudson.fst
        # grouped-method Hudson (hud.py -m grouped) comes out of the same
        # fused reduction via seed-representative weight rows
        fstg = res.hudson_grouped.fst if with_pairs else jnp.zeros_like(fst)
        pi_ab = 0.5 * (pi_panel[pair_a] + pi_panel[pair_b])
        f3 = jnp.where(pi_c != 0,
                       (pi_c - pi_ab) / jnp.where(pi_c != 0, pi_c, 1.0),
                       jnp.nan)
        n_all = jnp.sum(m.astype(jnp.int32))
        afs = (panel_afs(g, m, smask, panels1, afs_bins, afs_folded)
               if want_afs
               else jnp.zeros((p_count, 1), jnp.int32))
        if want_ehh:
            # bidirectional decay areas + carrier counts for both alleles
            # at the window's focal column (wip/ehhgfa.py:47-69 capability)
            # as four extra packed values — the dynamic-focal formulation
            # shares the one compiled shape (stats/ehh.ehh_area_dynamic)
            from impop_tpu.stats.ehh import ehh_area_dynamic

            xb = (g == 1).astype(jnp.int8)
            e_area, e_carr = ehh_area_dynamic(xb, m, smask, focal,
                                              alleles=(0, 1))
            ehh_vals = jnp.concatenate(
                [e_area, e_carr.astype(jnp.float32)])
        else:
            ehh_vals = jnp.zeros((0,), jnp.float32)
        # ONE packed f32 row per window, so a batch is one device-to-host
        # fetch.  All packed values are exact in f32 (counts < 2^24).
        # seed_risk flags windows whose FSTG needs the exact
        # first-found-pair recompute (partial coverage —
        # stats/panelstats.PanelStats).
        return jnp.concatenate([
            pi_panel, d, fst.astype(jnp.float32),
            fstg.astype(jnp.float32), f3,
            s_countf.reshape(1),
            n_all.reshape(1).astype(jnp.float32),
            res.seed_risk.reshape(1).astype(jnp.float32),
            ehh_vals,
            afs.reshape(-1).astype(jnp.float32),
        ])

    fn = jax.vmap(one_window)
    if len(devs) > 1:
        fn = _shard_windows(fn, devs)
    return jax.jit(fn)


_COMPILED_SIGS: set = set()
_concat_jit = None


def _concat_outputs(*xs):
    """Device-side concat of a drain group's packed rows: G result arrays
    become ONE fetched array, so the drain pays one device-to-host
    transfer per group instead of per batch."""
    global _concat_jit
    if _concat_jit is None:
        import jax
        import jax.numpy as jnp

        _concat_jit = jax.jit(lambda *ys: jnp.concatenate(ys, axis=0))
    return _concat_jit(*xs)


def cmd_scan(args) -> int:
    """The fused scan: one pass over allele windows computing π,
    Tajima's D per panel and Hudson/3-π Fst per panel pair — the work of all
    seven reference drivers in a single device program per batch, with a
    result journal for idempotent resume (the reference restarts from
    scratch, SURVEY.md §5)."""
    import jax

    from impop_tpu.io.panels import expand_population
    from impop_tpu.runtime.journal import ResultJournal

    from impop_tpu.parallel.distributed import host_window_range
    from impop_tpu.runtime.profiling import StageTimers, device_trace

    # main() has already run jax.distributed.initialize for --distributed
    proc_idx, proc_count = jax.process_index(), jax.process_count()
    timers = StageTimers()
    # everything before the batch loop (index/PAF open, panel reads,
    # journal replay) is one-time setup — timed as its own stage so the
    # breakdown accounts for all elapsed time
    _setup_stage = timers.stage("setup")
    _setup_stage.__enter__()

    with timers.stage("setup.bed"):
        regions = read_bed(args.bed)
    if proc_count > 1:
        lo, hi = host_window_range(len(regions), proc_idx, proc_count)
        regions = regions[lo:hi]
        for attr in ("output", "journal", "afs", "timing_json"):
            if getattr(args, attr, None):
                setattr(args, attr, f"{getattr(args, attr)}.part{proc_idx}")
    geno_src = (GenoSource(args.geno_dir) if args.geno_dir
                else GfaDirSource(args.gfa_dir) if getattr(args, "gfa_dir", None)
                else None)
    with timers.stage("setup.open"):
        fasta_store = _resolve_fasta(args)
        extractor = (_open_extractor(args.paf, fasta_store)
                     if args.paf and fasta_store else None)
    if geno_src is None and extractor is None:
        raise SystemExit("error: provide --geno-dir, --gfa-dir, "
                         "--paf + --fasta, or --paf + --agc")

    with timers.stage("setup.panels"):
        panel_files = sorted(args.panel or [])
        panel_names = [_panel_label(p) for p in panel_files]
        panel_lists = [read_panel_file(p) for p in panel_files]
    p_count = max(1, len(panel_lists))
    pair_list = [(i, j) for i in range(len(panel_lists))
                 for j in range(i + 1, len(panel_lists))]

    with timers.stage("setup.journal"):
        journal = ResultJournal(args.journal)

    # window row names are identical across a contiguous scan — memoise the
    # panel prefix matching (it was re-run per window per panel)
    import functools as _functools

    @_functools.lru_cache(maxsize=64)
    def _masks_for_stems(stems_key: tuple) -> np.ndarray:
        masks = np.zeros((p_count, len(stems_key)), dtype=bool)
        for pi_idx, plist in enumerate(panel_lists):
            matched, _ = expand_population(plist, list(stems_key))
            for k, nm in enumerate(stems_key):
                if nm in matched:
                    masks[pi_idx, k] = True
        return masks

    def panel_masks_for(names_key: tuple) -> np.ndarray:
        # Extracted sequence names carry per-window ``:start-end`` range
        # suffixes, so caching on the raw tuple misses every window and
        # re-runs the O(panel entries x names) prefix match each time
        # (most of a scan's wall time before this cache).  Panel prefixes are
        # '#'-terminated assembly identifiers (h-fst.py:18-61) that never
        # reach into the range suffix, so match on the stems: one cache
        # entry serves the whole scan.
        return _masks_for_stems(
            tuple(n.split(":", 1)[0] for n in names_key)
        )

    want_ehh = bool(getattr(args, "ehh", False))

    header = ["REGION", "LENGTH", "SAMPLES", "SEGREGATING_SITES"]
    if panel_lists:
        for name in panel_names:
            header += [f"PI_{name}", f"TAJD_{name}"]
        for i, j in pair_list:
            header += [f"FST_{panel_names[i]}_{panel_names[j]}",
                       f"FSTG_{panel_names[i]}_{panel_names[j]}",
                       f"FST3_{panel_names[i]}_{panel_names[j]}"]
    else:
        header += ["PI", "TAJIMAS_D"]
    if want_ehh:
        header += ["EHH_FOCAL", "EHH_AREA_REF", "EHH_CARR_REF",
                   "EHH_AREA_ALT", "EHH_CARR_ALT"]

    # host copies for the prefetch worker's disjointness check: a worker
    # thread never touches a device array (a fetch there would sync with
    # the device inside the build stage)
    pair_a_np = np.asarray([i for i, _ in pair_list] or [0], np.int32)
    pair_b_np = np.asarray([j for _, j in pair_list] or [0], np.int32)

    use_weights = getattr(args, "identity_mode", "events") == "columns"
    want_afs = bool(getattr(args, "afs", None))
    afs_bins = getattr(args, "afs_bins", 512)
    afs_folded = not getattr(args, "afs_unfolded", False)
    # --ehh-focal: "chrom pos" lines; a window containing a listed
    # position anchors its EHH focal there instead of the midpoint
    ehh_targets: Dict[str, list] = {}
    if want_ehh and getattr(args, "ehh_focal", None):
        with open(args.ehh_focal) as fh:
            for ln in fh:
                parts = ln.split()
                if len(parts) >= 2 and not ln.startswith("#"):
                    ehh_targets.setdefault(parts[0], []).append(
                        int(parts[1]))
    ehh_focal_pos: Dict[str, int] = {}  # rs -> genomic position used

    def _ehh_focal_index(reg, rs, pos_arr) -> int:
        """Focal column = variant nearest the target position (an
        --ehh-focal entry inside the window, else the midpoint).  The
        chosen genomic position is recorded for the output row."""
        if pos_arr is None or len(pos_arr) == 0:
            return 0
        target = (reg.start + reg.end) // 2
        for p in ehh_targets.get(reg.chrom, ()):
            if reg.start <= p < reg.end:
                target = p
                break
        pos_arr = np.asarray(pos_arr)
        fi = int(np.argmin(np.abs(pos_arr - target)))
        ehh_focal_pos[rs] = int(pos_arr[fi])
        return fi

    with_pairs = bool(pair_list)

    # packed-row layout (host-side unpack offsets)
    q_eff = max(1, len(pair_list))
    _o_pi = 0
    _o_d = p_count
    _o_fst = 2 * p_count
    _o_fstg = _o_fst + q_eff
    _o_f3 = _o_fstg + q_eff
    _o_s = _o_f3 + q_eff
    _o_n = _o_s + 1
    _o_risk = _o_n + 1
    _o_ehh = _o_risk + 1
    _o_afs = _o_ehh + (4 if want_ehh else 0)

    # shard the window batch over every LOCAL device; a single device
    # degenerates to plain placement.  Multi-device uses shard_map (not
    # bare GSPMD): each device executes its own shard of the vmapped
    # program, with no collective.  Hosts already partition the window
    # list (host_window_range), so each host's mesh spans only its own
    # devices — cross-host there is nothing to communicate but the output
    # files.
    local_devs = jax.local_devices()
    n_dev = len(local_devs)
    devs_key = tuple(local_devs)
    mesh = None
    if n_dev > 1:
        from impop_tpu.parallel.mesh import make_mesh, window_sharding

        mesh = make_mesh(data=n_dev, devices=local_devs)

    def step_for(pairs_disjoint: bool, cap_n: int, cap_s: int):
        """Compiled step per (shape, pair-disjointness) — disjoint panels
        skip 2Q masks in the fused grouping pass.  Programs are cached at
        module scope (_scan_step), so a resumed or repeated scan in the
        same process reuses the compiled executable."""
        return _scan_step(cap_n, cap_s, p_count, tuple(pair_list),
                          float(args.threshold), use_weights, want_afs,
                          afs_bins, afs_folded, pairs_disjoint, devs_key,
                          want_ehh)

    def step_is_new(pairs_disjoint: bool, cap_n: int, cap_s: int,
                    w: int) -> bool:
        """First dispatch of a program signature in this process carries
        the jit compile — timed under the 'compile' stage, not 'device'."""
        sig = (pairs_disjoint, cap_n, cap_s, p_count, tuple(pair_list),
               float(args.threshold), use_weights, want_afs, afs_bins,
               afs_folded, devs_key, w, want_ehh)
        if sig in _COMPILED_SIGS:
            return False
        _COMPILED_SIGS.add(sig)
        return True

    def put_flat(flat):
        if mesh is None:
            return (jax.device_put(flat),)
        w = flat.shape[0]
        w_pad = ((w + n_dev - 1) // n_dev) * n_dev
        if w_pad != w:
            # padding rows are all-zero: empty member/site masks -> inert
            flat = np.concatenate(
                [flat, np.zeros((w_pad - w, flat.shape[1]), np.uint8)],
                axis=0)
        return (jax.device_put(flat, window_sharding(mesh, flat.ndim)),)

    def put_batch(arrays):
        geno, member, smask, panels, lengths, wts, focals = arrays
        flat = pack_scan_batch(geno, member, smask, panels, lengths, wts,
                               use_weights, focals)
        return put_flat(flat)

    afs_total = (np.zeros((p_count, afs_bins + 1), np.int64)
                 if want_afs else None)

    _setup_stage.__exit__(None, None, None)
    out = _out_stream(args.output)
    try:
        print("\t".join(header), file=out)
        pending: List[Tuple[Region, str]] = []
        for reg in regions:
            rs = reg.region_string(args.prefix)
            rec = journal.get(rs)
            if rec is not None and "row" in rec:
                print(rec["row"], file=out)
                if want_afs:
                    sparse = rec.get("afs")
                    if sparse is None:
                        _warn(f"Warning: journal row for {rs} predates "
                              "--afs; spectrum will miss it")
                    else:
                        for pk, c in sparse.items():
                            pi_idx, k = map(int, pk.split(":"))
                            afs_total[pi_idx, k] += int(c)
                continue
            pending.append((reg, rs))

        batch_size = args.batch
        trace_ctx = device_trace(args.profile_dir)
        trace_ctx.__enter__()

        def load_chunk(chunk):
            tiles, kept, failures = [], [], []
            for reg, rs in chunk:
                try:
                    if geno_src is not None:
                        g, names, keys = geno_src.load(rs)
                        # scan wire is 2-bit: normalise multiallelic
                        # columns to the extractor's per-alt convention
                        g, keys = split_multiallelic(
                            np.asarray(g, np.int8), keys)
                    else:
                        wm = extractor.extract(rs.rsplit(":", 1)[0],
                                               reg.start, reg.end)
                        g, names, keys = wm.geno, wm.names, wm.site_keys
                except Exception as e:
                    failures.append((rs, str(e)))
                    continue
                order = np.argsort(names)
                tiles.append((np.asarray(g, np.int8)[order],
                              [names[i] for i in order], keys))
                kept.append((reg, rs))
            return tiles, kept, failures

        cap_hint = [64, 128]  # [n, s] compile-shape floors, grown per chunk

        def extract_native(chunk):
            """Extraction-stage worker: ONE C++ call per target-contiguous
            window group (sorted non-overlapping groups take the range
            walker inside — one CIGAR walk per PAF record per BATCH, not
            per window).  Returns OPEN native batch handles; the build
            worker wire-packs them straight from C++ memory."""
            with timers.stage("extract"):
                groups: List[Tuple[str, list]] = []
                for reg, rs in chunk:
                    tgt = rs.rsplit(":", 1)[0]
                    if groups and groups[-1][0] == tgt:
                        groups[-1][1].append((reg, rs))
                    else:
                        groups.append((tgt, [(reg, rs)]))
                batches = [
                    extractor.extract_batch_open(
                        tgt, [(reg.start, reg.end) for reg, _ in items])
                    for tgt, items in groups
                ]
            return groups, batches

        def prepare_chunk_native(extracted, chunk, n_chunks):
            """Build-stage worker: wire-pack + H2D for one extracted batch.

            The 2-bit/bitmask/weight segments of the fused buffer are
            written by ONE parallel C call straight from the native
            batch's memory (ix_batch_pack_all) — no intermediate padded
            int8 tiles and no numpy bit-packing passes on this
            CPU-starved host; Python contributes only the panel bitmasks
            and window lengths (host metadata the library cannot know)."""
            groups, batches = extracted
            with timers.stage("build"):
                failures: List[Tuple[str, str]] = []
                kept: List[Tuple[Region, str]] = []
                rows = []  # (group_idx, window_idx_within_group)
                for gi, ((tgt, items), nb) in enumerate(zip(groups, batches)):
                    for k, (reg, rs) in enumerate(items):
                        if nb.errors[k]:
                            failures.append((rs, nb.errors[k]))
                        else:
                            kept.append((reg, rs))
                            rows.append((gi, k))
                if not kept:
                    for nb in batches:
                        nb.close()
                    return None, kept, failures, False, (0, 0)
                n_max = max(max((n for n, _ in nb.dims), default=1)
                            for nb in batches)
                s_max = max(max((s for _, s in nb.dims), default=1)
                            for nb in batches)
                cap_n = _capacity_for([max(cap_hint[0], n_max)])
                cap_s = ((max(cap_hint[1], s_max, 128) + 127) // 128) * 128
                cap_hint[0] = max(cap_hint[0], cap_n)
                cap_hint[1] = max(cap_hint[1], cap_s)
                w = batch_size if n_chunks > 1 else len(kept)
                lay = _scan_buf_layout(cap_n, cap_s, p_count, use_weights,
                                       want_ehh)
                flat = np.zeros((w, lay["total"]), np.uint8)
                row_of = {key: wi for wi, key in enumerate(rows)}
                with timers.stage("build.pack"):
                    for gi, nb in enumerate(batches):
                        nb.pack_into(
                            flat, [row_of.get((gi, k), -1)
                                   for k in range(nb.count)],
                            cap_n, cap_s, lay["m"], lay["sm"],
                            lay["w"] if use_weights else -1)
                panels = np.zeros((w, p_count, cap_n), bool)
                focals = np.zeros(w, np.uint32) if want_ehh else None
                lengths = np.fromiter(
                    (reg.length for reg, _ in kept), np.uint32,
                    count=len(kept))
                if len(kept) < w:
                    lengths = np.concatenate(
                        [lengths, np.zeros(w - len(kept), np.uint32)])
                # contiguous windows share one name set, so panel masks
                # bulk-assign per distinct mask instead of per window
                # (within steal-noise on this host — the loop's residual
                # cost is the per-window names() blob lookup)
                mask_rows: dict = {}
                mask_vals: dict = {}
                for wi, ((gi, k), (reg, rs)) in enumerate(zip(rows, kept)):
                    nm = batches[gi].names(k)
                    if want_ehh:
                        focals[wi] = _ehh_focal_index(
                            reg, rs, batches[gi].site_pos(k))
                    key = id(nm)
                    if key not in mask_vals:
                        mask_vals[key] = (
                            panel_masks_for(tuple(nm)) if panel_lists
                            else len(nm))
                    mask_rows.setdefault(key, []).append(wi)
                for key, wis in mask_rows.items():
                    m = mask_vals[key]
                    if panel_lists:
                        panels[np.asarray(wis), :, :m.shape[1]] = m
                    else:
                        panels[np.asarray(wis), 0, :m] = True
                for nb in batches:
                    nb.close()
                flat[:, lay["p"]:lay["l"]] = np.packbits(
                    panels, axis=-1, bitorder="little").reshape(w, -1)
                flat[:, lay["l"]:lay["l"] + 4] = (
                    np.ascontiguousarray(lengths.astype("<u4"))
                    .view(np.uint8).reshape(w, 4))
                if want_ehh:
                    flat[:, lay["f"]:lay["f"] + 4] = (
                        np.ascontiguousarray(focals.astype("<u4"))
                        .view(np.uint8).reshape(w, 4))
                disjoint = bool(with_pairs) and not bool(
                    (panels[:, pair_a_np] & panels[:, pair_b_np]).any()
                )
            with timers.stage("h2d"):
                dev_args = put_flat(flat)
            return dev_args, kept, failures, disjoint, (cap_n, cap_s)

        native_path = (geno_src is None and extractor is not None
                       and hasattr(extractor, "extract_batch_open"))

        def extract_stage(chunk):
            """Extraction-stage worker (either path)."""
            if native_path:
                return extract_native(chunk)
            with timers.stage("extract"):
                return load_chunk(chunk)

        def prepare_chunk(extracted, chunk, n_chunks):
            """Build-stage worker: pad + fused pack + H2D for one batch.

            Build/pack/put of batch k overlap BOTH the extraction of batch
            k+1 (separate worker) and the device compute of batch k-1
            (device_put is async and thread-safe); stage timers therefore
            overlap each other and sum to more than elapsed.
            """
            if native_path:
                return prepare_chunk_native(extracted, chunk, n_chunks)
            tiles, kept, failures = extracted
            if not tiles:
                return None, kept, failures, False, (0, 0)
            with timers.stage("build"):
                cap_n = _capacity_for([t0.shape[0] for t0, *_ in tiles])
                cap_s = max(128, max(t0.shape[1] for t0, *_ in tiles))
                cap_s = ((cap_s + 127) // 128) * 128
                # pad a short final batch to the full batch size so it
                # reuses the compiled program (a fresh shape costs a
                # 15-25 s compile)
                w = batch_size if n_chunks > 1 else len(tiles)
                geno = np.full((w, cap_n, cap_s), -1, dtype=np.int8)
                member = np.zeros((w, cap_n), bool)
                smask = np.zeros((w, cap_s), bool)
                panels = np.zeros((w, p_count, cap_n), bool)
                lengths = np.zeros(w, np.float32)
                wts = np.ones((w, cap_s), np.float32)
                focals = np.zeros(w, np.uint32) if want_ehh else None
                for wi, ((g, names, keys), (reg, rs)) in enumerate(
                        zip(tiles, kept)):
                    n, s = g.shape
                    geno[wi, :n, :s] = g
                    member[wi, :n] = True
                    smask[wi, :s] = True
                    lengths[wi] = reg.length
                    if use_weights and keys is not None:
                        from impop_tpu.extract import site_weights_from_keys

                        wts[wi, :s] = site_weights_from_keys(keys)
                    if want_ehh:
                        pos = ([int(k.split(":", 1)[0]) for k in keys]
                               if keys is not None else None)
                        focals[wi] = _ehh_focal_index(reg, rs, pos)
                    if panel_lists:
                        panels[wi, :, :n] = panel_masks_for(tuple(names))
                    else:
                        panels[wi, 0, :n] = True
                # host-side disjointness check selects the cheaper fused
                # program (panel lists rarely overlap; both variants cached)
                disjoint = bool(with_pairs) and not bool(
                    (panels[:, pair_a_np] & panels[:, pair_b_np]).any()
                )
            with timers.stage("h2d"):
                dev_args = put_batch((geno, member, smask, panels, lengths,
                                      wts, focals))
            return dev_args, kept, failures, disjoint, (cap_n, cap_s)

        # two-stage worker pipeline: chunk k+1's C++ extraction runs on one
        # worker while chunk k's numpy build/pack/H2D runs on another and
        # the device computes chunk k-1 (the reference is fully sequential
        # per window); at most 2 prepared batches are in flight so prefetch
        # cannot outrun HBM.  The build worker blocks on its extraction
        # future (separate pools — no deadlock).
        import collections as _coll
        import concurrent.futures as _fut

        chunks = [pending[lo:lo + batch_size]
                  for lo in range(0, len(pending), batch_size)]
        pool_x = _fut.ThreadPoolExecutor(max_workers=1)
        pool_b = _fut.ThreadPoolExecutor(max_workers=1)
        inflight = _coll.deque()
        next_submit = 0

        def _chained(fx, chunk, n_chunks):
            return prepare_chunk(fx.result(), chunk, n_chunks)

        def _top_up():
            nonlocal next_submit
            while next_submit < len(chunks) and len(inflight) < 2:
                chunk = chunks[next_submit]
                fx = pool_x.submit(extract_stage, chunk)
                inflight.append(
                    pool_b.submit(_chained, fx, chunk, len(chunks)))
                next_submit += 1

        _top_up()
        n_done = n_failed = 0

        def emit_rows(packed, kept):
            nonlocal n_done
            pi_v = packed[:, _o_pi:_o_d]
            d_v = packed[:, _o_d:_o_fst]
            fst_v = packed[:, _o_fst:_o_fstg]
            fstg_v = packed[:, _o_fstg:_o_f3]
            f3_v = packed[:, _o_f3:_o_s]
            s_v = packed[:, _o_s]
            n_v = packed[:, _o_n]
            ehh_v = packed[:, _o_ehh:_o_afs]
            afs_v = packed[:, _o_afs:].reshape(packed.shape[0], p_count, -1)
            timers.add_windows(len(kept))
            for wi, (reg, rs) in enumerate(kept):
                cells = [rs, str(reg.length), str(int(n_v[wi])),
                         str(int(s_v[wi]))]
                for pi_idx in range(p_count):
                    pi_site = float(pi_v[wi, pi_idx]) / reg.length
                    d_val = float(d_v[wi, pi_idx])
                    cells += [f"{pi_site:.8f}",
                              "NA" if np.isnan(d_val) else f"{d_val:.6f}"]
                if panel_lists:
                    for qi in range(len(pair_list)):
                        f_val = float(fst_v[wi, qi])
                        fg_val = float(fstg_v[wi, qi])
                        f3_val = float(f3_v[wi, qi])
                        cells += [
                            f"{f_val:.8f}",
                            f"{fg_val:.8f}",
                            "NA" if np.isnan(f3_val) else f"{f3_val:.8f}",
                        ]
                if want_ehh:
                    # [area_ref, area_alt, carriers_ref, carriers_alt]
                    fp = ehh_focal_pos.get(rs)
                    cells += [
                        "NA" if fp is None else str(fp),
                        f"{float(ehh_v[wi, 0]):.6f}",
                        str(int(ehh_v[wi, 2])),
                        f"{float(ehh_v[wi, 1]):.6f}",
                        str(int(ehh_v[wi, 3])),
                    ]
                row = "\t".join(cells)
                if args.log_dir:
                    payload = {
                        "region": rs, "length": reg.length,
                        "threshold": args.threshold,
                        "n": int(n_v[wi]), "segregating_sites": int(s_v[wi]),
                    }
                    for pi_idx, pname in enumerate(panel_names or ["ALL"]):
                        payload[f"pi_{pname}"] = (
                            float(pi_v[wi, pi_idx]) / reg.length)
                        dv = float(d_v[wi, pi_idx])
                        payload[f"tajd_{pname}"] = ("NA" if np.isnan(dv)
                                                    else dv)
                    for qi, (i, j) in enumerate(pair_list):
                        tag = f"{panel_names[i]}_{panel_names[j]}"
                        payload[f"fst_{tag}"] = float(fst_v[wi, qi])
                        payload[f"fstg_{tag}"] = float(fstg_v[wi, qi])
                        f3v = float(f3_v[wi, qi])
                        payload[f"fst3_{tag}"] = ("NA" if np.isnan(f3v)
                                                  else f3v)
                    _write_window_log(args.log_dir, rs,
                                      "Fused Scan Window", payload)
                rec = {"row": row}
                if want_afs:
                    # journal the window's spectrum sparsely so a resumed
                    # scan still merges it (allele count 0 = monomorphic
                    # padding, never meaningful)
                    sparse = {}
                    for pi_idx in range(p_count):
                        hist = afs_v[wi, pi_idx]
                        for k in np.nonzero(hist)[0]:
                            if k == 0:
                                continue
                            sparse[f"{pi_idx}:{int(k)}"] = int(hist[k])
                            afs_total[pi_idx, k] += int(hist[k])
                    rec["afs"] = sparse
                journal.record(rs, rec)
                print(row, file=out)
                n_done += 1

        # software-pipelined consume with grouped drains: dispatch batches
        # continuously; every `drain_group` outputs are concatenated ON
        # DEVICE and fetched as one array (one device-to-host transfer per
        # group), one group behind the dispatch front so the device
        # computes while the host drains + emits.  First dispatches of a
        # program signature carry the jit compile and are timed under the
        # 'compile' stage (bench.py subtracts that stage for steady-state).
        drain_group = max(1, int(getattr(args, "drain_group", 4) or 4))
        group: List[tuple] = []   # [(out_dev, kept, dev_args, caps)]
        pending_out = None        # (cout_dev, [(kept, dev_args, caps)...], [w...])

        def _exact_fstg(packed_b, kept_b, dev_args_b, caps_b):
            """Presence-triggered exact FSTG: windows flagged seed_risk by
            the fused step (partial coverage breaking the seed-
            representative premise) re-run through the exact first-found-
            pair program and have their FSTG columns replaced.  Never
            fires on coverage-overlapping windows, so the common path
            pays only the one packed flag column."""
            if not with_pairs:
                return packed_b
            risk = packed_b[:len(kept_b), _o_risk] > 0
            if not risk.any():
                return packed_b
            sig = ("fstg_exact", caps_b, dev_args_b[0].shape[0])
            fresh = sig not in _COMPILED_SIGS
            _COMPILED_SIGS.add(sig)
            step = _scan_step_fstg_exact(
                caps_b[0], caps_b[1], p_count, tuple(pair_list),
                float(args.threshold), use_weights, devs_key)
            with timers.stage("compile" if fresh else "device"):
                exact = np.asarray(step(*dev_args_b))
            packed_b = packed_b.copy()
            rows = np.nonzero(risk)[0]
            packed_b[rows, _o_fstg:_o_f3] = exact[rows]
            return packed_b

        def _drain_group(cout_dev, metas, sizes):
            with timers.stage("fetch"):
                # the device-to-host fetch is also the barrier: device
                # time not yet waited for lands in this stage
                packed_all = np.asarray(cout_dev)
            off = 0
            for (kept_b, dev_args_b, caps_b), w_b in zip(metas, sizes):
                packed_b = _exact_fstg(packed_all[off:off + w_b], kept_b,
                                       dev_args_b, caps_b)
                with timers.stage("emit"):
                    emit_rows(packed_b, kept_b)
                off += w_b

        def _flush_group():
            nonlocal pending_out, group
            if not group:
                return
            if len(group) == 1:
                cout = group[0][0]
            else:
                sig = ("concat", len(group), tuple(group[0][0].shape))
                fresh = sig not in _COMPILED_SIGS
                _COMPILED_SIGS.add(sig)
                with timers.stage("compile" if fresh else "device"):
                    cout = _concat_outputs(*[o for o, *_ in group])
            if pending_out is not None:
                _drain_group(*pending_out)
            pending_out = (cout, [(k, d, c) for _, k, d, c in group],
                           [o.shape[0] for o, *_ in group])
            group = []

        while inflight:
            with timers.stage("wait_input"):
                (dev_args, kept, failures, disjoint,
                 caps) = inflight.popleft().result()
            _top_up()
            for rs, err in failures:
                _warn(f"Warning: {rs}: {err}; recording NA")
                journal.record_failure(rs, err)
                n_failed += 1
            if dev_args is None:
                continue
            fresh = step_is_new(disjoint, caps[0], caps[1],
                                dev_args[0].shape[0])
            with timers.stage("compile" if fresh else "device"):
                out_dev = step_for(disjoint, caps[0], caps[1])(*dev_args)
            group.append((out_dev, kept, dev_args, caps))
            if len(group) >= drain_group:
                _flush_group()
        _flush_group()
        if pending_out is not None:
            _drain_group(*pending_out)
        pool_x.shutdown(wait=False)
        pool_b.shutdown(wait=False)
        trace_ctx.__exit__(None, None, None)
        _print_counters(n_done, n_failed)
    finally:
        if out is not sys.stdout:
            out.close()
    if want_afs:
        with open(args.afs, "w") as fh:
            names_hdr = panel_names or ["ALL"]
            fh.write("ALLELE_COUNT\t" +
                     "\t".join(f"SITES_{n}" for n in names_hdr) + "\n")
            for k in range(1, afs_bins + 1):
                if afs_total[:, k].any():
                    fh.write(f"{k}\t" + "\t".join(
                        str(int(afs_total[pi_idx, k]))
                        for pi_idx in range(p_count)) + "\n")
        _warn(f"wrote genome-wide spectrum -> {args.afs}")
    if args.verbose_timing:
        _warn(timers.report())
    if getattr(args, "timing_json", None):
        import json

        with open(args.timing_json, "w") as fh:
            json.dump(timers.to_json(), fh)
    return 0


# --------------------------------------------------------------- sfs


def cmd_sfs(args) -> int:
    """Site-frequency spectrum straight from allele tiles — the tile-native
    capability the reference approximates with text-table post-processing
    (wip/op-afs.py:26-45): per-window per-panel histograms of derived (or
    folded minor) allele counts, merged into a genome-wide spectrum on
    device.  One batched program computes every (window, panel) histogram.
    """
    import jax
    import jax.numpy as jnp

    from impop_tpu.io.panels import expand_population
    from impop_tpu.stats.allele import panel_afs

    regions = read_bed(args.bed)
    geno_src = (GenoSource(args.geno_dir) if args.geno_dir
                else GfaDirSource(args.gfa_dir) if args.gfa_dir else None)
    fasta_store = _resolve_fasta(args)
    extractor = (_open_extractor(args.paf, fasta_store)
                 if args.paf and fasta_store else None)
    if geno_src is None and extractor is None:
        raise SystemExit("error: provide --geno-dir, --gfa-dir, "
                         "--paf + --fasta, or --paf + --agc")

    panel_files = sorted(args.panel or [])
    panel_names = [_panel_label(p) for p in panel_files] or ["ALL"]
    panel_lists = [read_panel_file(p) for p in panel_files]
    p_count = len(panel_names)

    kept, tiles = [], []
    for reg in regions:
        rs = reg.region_string(args.prefix)
        try:
            if geno_src is not None:
                g, names, _keys = geno_src.load(rs)
            else:
                wm = extractor.extract(rs.rsplit(":", 1)[0],
                                       reg.start, reg.end)
                g, names = wm.geno, wm.names
        except Exception as e:
            _warn(f"Warning: {rs}: {e}; skipping window")
            continue
        order = np.argsort(names)
        tiles.append((np.asarray(g, np.int8)[order],
                      [names[i] for i in order]))
        kept.append((reg, rs))

    out = _out_stream(args.output)
    try:
        if not kept:
            _warn("Warning: no windows could be processed")
            print("ALLELE_COUNT\t" +
                  "\t".join(f"SITES_{n}" for n in panel_names), file=out)
            return 0
        cap_n = _capacity_for([t[0].shape[0] for t in tiles])
        cap_s = max(8, ((max(t[0].shape[1] for t in tiles) + 127) // 128)
                    * 128)
        w = len(tiles)
        geno = np.full((w, cap_n, cap_s), -1, dtype=np.int8)
        member = np.zeros((w, cap_n), bool)
        smask = np.zeros((w, cap_s), bool)
        panels = np.zeros((w, p_count, cap_n), bool)
        for wi, (g, names) in enumerate(tiles):
            n, s = g.shape
            geno[wi, :n, :s] = g
            member[wi, :n] = True
            smask[wi, :s] = True
            if not panel_lists:
                panels[wi, 0, :n] = True
            else:
                for pi_idx, plist in enumerate(panel_lists):
                    matched, _ = expand_population(plist, names)
                    for k, nm in enumerate(names):
                        if nm in matched:
                            panels[wi, pi_idx, k] = True

        max_n = args.max_n or cap_n
        folded = not args.unfolded

        @jax.jit
        def run(g, m, sm, p):
            per_win = jax.vmap(
                lambda g1, m1, s1, p1: panel_afs(g1, m1, s1, p1, max_n,
                                                 folded)
            )(g, m, sm, p)  # [W, P, K]
            return per_win, jnp.sum(per_win, axis=0)

        per_win, merged = run(jnp.asarray(geno), jnp.asarray(member),
                              jnp.asarray(smask), jnp.asarray(panels))
        per_win = np.asarray(per_win)
        merged = np.asarray(merged)  # [P, K]

        print("ALLELE_COUNT\t" +
              "\t".join(f"SITES_{n}" for n in panel_names), file=out)
        top = max_n // 2 if folded else max_n
        for k in range(1, top + 1):
            if merged[:, k].any() or k <= (args.max_n or 0):
                print(f"{k}\t" + "\t".join(str(int(merged[pi, k]))
                                           for pi in range(p_count)),
                      file=out)
    finally:
        if out is not sys.stdout:
            out.close()

    if args.per_window:
        with open(args.per_window, "w") as fh:
            fh.write("REGION\tPANEL\tALLELE_COUNT\tSITES\n")
            for wi, (reg, rs) in enumerate(kept):
                for pi_idx, pname in enumerate(panel_names):
                    hist = per_win[wi, pi_idx]
                    for k in np.nonzero(hist)[0]:
                        if k == 0:
                            continue
                        fh.write(f"{rs}\t{pname}\t{k}\t{int(hist[k])}\n")
    return 0


# --------------------------------------------------------------- ehh


def _ehh_from_tiles(args) -> int:
    """EHH fed from the engine's own data path (extraction / allele tiles).

    The reference prototype reads pre-built text matrices only
    (wip/ehhgfa.py:47-69); this mode selects focal sites by GENOMIC
    position: each ``--focal P`` picks the BED window containing P and the
    nearest variant column inside its allele tile, then every (window,
    allele) task runs in ONE batched device program.  Tiles are re-centred
    host-side so all tasks share a single static focal index (and thus one
    compiled shape).  Output row:
    ``region focal_pos site_pos site_key allele REF|ALT carriers area``
    (allele 0 = reference allele of the variant column).
    """
    import jax.numpy as jnp

    from impop_tpu.stats.ehh import ehh_area_batch

    if not args.bed or not args.focal:
        raise SystemExit("error: extraction mode needs -b and --focal "
                         "(or pass -i for matrix mode)")
    regions = read_bed(args.bed)
    geno_src = GenoSource(args.geno_dir) if args.geno_dir else None
    extractor = None
    if geno_src is None:
        fasta_store = _resolve_fasta(args)
        if args.paf and fasta_store:
            extractor = _open_extractor(args.paf, fasta_store)
    if geno_src is None and extractor is None:
        raise SystemExit("error: provide --geno-dir or --paf + "
                         "--fasta/--agc")

    tasks = []
    for fp in args.focal:
        reg = next((r for r in regions if r.start <= fp < r.end), None)
        if reg is None:
            _warn(f"Warning: no BED window contains focal {fp}; skipping")
            continue
        tasks.append((reg, reg.region_string(args.prefix), fp))

    tiles, kept = [], []
    for reg, rs, fp in tasks:
        try:
            if geno_src is not None:
                g, names, keys = geno_src.load(rs)
                if keys is None:
                    raise WindowError("allele tile has no site_keys — "
                                      "positions unavailable")
                pos = np.asarray([int(k.split(":", 1)[0]) for k in keys])
            else:
                wm = extractor.extract(rs.rsplit(":", 1)[0],
                                      reg.start, reg.end)
                g, pos, keys = wm.geno, np.asarray(wm.site_pos), wm.site_keys
        except Exception as e:
            _warn(f"Warning: skipping focal {fp} ({rs}): {e}")
            continue
        if len(pos) == 0:
            _warn(f"Warning: no variants in {rs}; skipping focal {fp}")
            continue
        fi = int(np.argmin(np.abs(pos - fp)))
        kept.append((rs, fp, int(pos[fi]), keys[fi]))
        # alt carrier = 1; reference call and uncovered both binarise to 0
        # (the prototype binarises every entry, ehhgfa.py:51)
        tiles.append(((np.asarray(g) == 1).astype(np.int8), fi))
    out = _out_stream(args.output)
    try:
        if kept:
            center = max(fi for _, fi in tiles)
            max_right = max(t.shape[1] - fi - 1 for t, fi in tiles)
            cap_s = center + 1 + max_right
            n_cap = max(t.shape[0] for t, _ in tiles)
            w = len(tiles)
            geno = np.zeros((w, n_cap, cap_s), np.int8)
            smask = np.zeros((w, cap_s), bool)
            member = np.zeros((w, n_cap), bool)
            for row, (t, fi) in enumerate(tiles):
                n, s = t.shape
                lo = center - fi
                geno[row, :n, lo:lo + s] = t
                smask[row, lo:lo + s] = True
                member[row, :n] = True
            alleles = jnp.asarray([0, 1], jnp.int32)
            area, carriers = ehh_area_batch(
                jnp.asarray(geno), jnp.asarray(member), jnp.asarray(smask),
                center, alleles,
                compat_right_for_left=bool(args.compat_ehhgfa),
            )
            area = np.asarray(area)
            carriers = np.asarray(carriers)
            for row, (rs, fp, used_pos, key) in enumerate(kept):
                for ai, al in enumerate((0, 1)):
                    if carriers[row, ai] == 0:
                        continue
                    typeal = "REF" if al == 0 else "ALT"
                    print(rs, fp, used_pos, key, al, typeal,
                          int(carriers[row, ai]), float(area[row, ai]),
                          file=out, flush=True)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def cmd_ehh(args) -> int:
    """EHH decay around a focal SNP — the capability of wip/ehhgfa.py.

    Reads a whitespace-separated haplotype matrix (no header), binarises
    non-zero entries (ehhgfa.py:51), slides fixed-width windows, and for each
    allele at the focal position prints
    ``window colstart colend allele REF|ALT area``.

    All (window, allele) tasks run in ONE batched device program
    (stats/ehh.ehh_area_batch): windows pad to a fixed width and carriers
    are boolean masks, so a whole scan costs a single compile — a naive
    port recompiles per (carrier count, suffix length) pair.

    Note: the reference script uses the right half for BOTH decay directions
    (ehhgfa.py:58-62 assigns ``a`` but never uses it); ``--compat-ehhgfa``
    reproduces that behaviour, the default uses the left prefix as intended.
    """
    import jax.numpy as jnp

    from impop_tpu.stats.ehh import ehh_area_batch

    if not args.input:
        return _ehh_from_tiles(args)
    if args.position is None or args.window is None:
        raise SystemExit("error: matrix mode needs -i, -p and -w")
    whole = np.loadtxt(args.input)
    if whole.ndim == 1:
        whole = whole[None, :]
    whole = (whole != 0).astype(np.int8)
    n, total_sites = whole.shape
    test_snp = args.position - 1
    wsize = args.window

    # stack the sliding windows, padding the ragged tail with masked sites
    starts = list(range(0, total_sites, wsize))
    keep = [(wi, cs) for wi, cs in enumerate(starts)
            if min(cs + wsize, total_sites) - cs > test_snp]
    out = _out_stream(args.output)
    try:
        if keep:
            w = len(keep)
            geno = np.zeros((w, n, wsize), np.int8)
            smask = np.zeros((w, wsize), bool)
            member = np.ones((w, n), bool)
            for row, (_, cs) in enumerate(keep):
                ce = min(cs + wsize, total_sites)
                geno[row, :, :ce - cs] = whole[:, cs:ce]
                smask[row, :ce - cs] = True
            alleles = jnp.asarray([0, 1], jnp.int32)
            area, carriers = ehh_area_batch(
                jnp.asarray(geno), jnp.asarray(member), jnp.asarray(smask),
                test_snp, alleles,
                compat_right_for_left=bool(args.compat_ehhgfa),
            )
            area = np.asarray(area)
            carriers = np.asarray(carriers)
            for row, (wi, cs) in enumerate(keep):
                ce = min(cs + wsize, total_sites)
                ref_allele = int(whole[args.refpos - 1, cs + test_snp])
                for ai, al in enumerate((0, 1)):
                    if carriers[row, ai] == 0:
                        continue  # allele absent at the focal site
                    typeal = "REF" if al == ref_allele else "ALT"
                    print(wi + 1, cs, ce, al, typeal,
                          float(area[row, ai]), file=out, flush=True)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


# --------------------------------------------------------------- spectrum


def cmd_spectrum(args) -> int:
    """Allele-frequency spectrum from a site-by-haplotype table — the
    capability of wip/op-afs.py: per polymorphic site, allele counts and
    frequencies, plus histogram panels saved as PNGs.

    The input is a TSV with a header whose columns from ``--first-site-col``
    onward are sites (op-afs.py:112 uses columns[3:]); rows are haplotypes.
    By default every allele at a site contributes; ``--compat-first-allele``
    reproduces the reference's quirk of recording only the first allele
    encountered per site (op-afs.py:40-44).
    """
    rows = []
    with open(args.input) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        for line in fh:
            parts = line.rstrip("\n").split("\t")
            if len(parts) == len(header):
                rows.append(parts)
    site_cols = list(range(args.first_site_col, len(header)))
    counts_by_allele: Dict[str, List[int]] = {}
    freqs_by_allele: Dict[str, List[float]] = {}
    table_rows = []
    for c in site_cols:
        values = [r[c] for r in rows]
        if not values or all(v == values[0] for v in values):
            continue  # monomorphic sites skipped (op-afs.py:32-35)
        total = len(values)
        tally: Dict[str, int] = {}
        for v in values:
            tally[v] = tally.get(v, 0) + 1
        items = list(tally.items())
        if args.compat_first_allele:
            items = items[:1]
        for allele, count in items:
            freq = count / total
            counts_by_allele.setdefault(allele, []).append(count)
            freqs_by_allele.setdefault(allele, []).append(freq)
            table_rows.append((header[c], allele, count, freq))

    out = _out_stream(args.output)
    try:
        print("site\tallele\tcount\tfrequency", file=out)
        for site, allele, count, freq in table_rows:
            print(f"{site}\t{allele}\t{count}\t{freq:.6f}", file=out)
    finally:
        if out is not sys.stdout:
            out.close()

    if not args.no_plots and counts_by_allele:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        for data, path, label in (
            (counts_by_allele, args.counts_png, "counts"),
            (freqs_by_allele, args.freqs_png, "frequencies"),
        ):
            fig, axes = plt.subplots(len(data), 1,
                                     figsize=(8, 4 * len(data)), squeeze=False)
            for ax, (allele, vec) in zip(axes[:, 0], sorted(data.items())):
                ax.hist(vec, bins="auto")
                ax.set_title(f"allele {allele}")
                ax.set_xlabel(label)
                ax.set_ylabel("sites")
            fig.tight_layout()
            fig.savefig(path, dpi=120)
            plt.close(fig)
            _warn(f"wrote {path}")
    return 0


# --------------------------------------------------------------- extract


def _write_window_vcf(path: str, chrom: str, wm) -> None:
    """Window variants as minimal VCF — the consumable the reference gets
    from ``povu gfa2vcf --stdout`` (run_tajd.sh:148): one record per variant
    key; the non-header line count is the segregating-site count S.  Adds
    per-haplotype GT columns (0 ref / 1 alt / . uncovered), which povu does
    not provide."""
    import contextlib

    ctx = (open(path, "w") if isinstance(path, str)
           else contextlib.nullcontext(path))
    with ctx as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write("##source=impop-tpu extract\n")
        cols = "\t".join(n.replace("\t", "_") for n in wm.names)
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                 + cols + "\n")
        for c, key in enumerate(wm.site_keys):
            pos_s, rest = key.split(":", 1)
            ref, alt = rest.split(">", 1)
            ref_out = ref if ref else "N"
            alt_out = alt if alt else "<DEL>"
            gts = []
            for row in range(len(wm.names)):
                val = wm.geno[row, c]
                gts.append("." if val < 0 else str(int(val)))
            fh.write(
                f"{chrom}\t{int(pos_s) + 1}\t.\t{ref_out}\t{alt_out}\t.\t"
                f".\tNS={sum(g != '.' for g in gts)}\tGT\t" + "\t".join(gts)
                + "\n"
            )


def cmd_extract(args) -> int:
    """PAF + FASTA → per-window allele tiles (.npz), the native replacement
    for the reference's per-window impg/odgi/povu invocations."""
    from impop_tpu.extract import split_window_matrix

    regions = read_bed(args.bed)
    os.makedirs(args.out_dir, exist_ok=True)
    fasta_store = _resolve_fasta(args)
    if not fasta_store:
        raise SystemExit("error: provide --fasta or --agc")
    extractor = _open_extractor(args.paf, fasta_store,
                                use_native=not args.python)
    if args.split:
        # one CIGAR walk per BED row, then column-slice per window (the
        # reference runs one impg process per window)
        expanded = []
        for reg in regions:
            rs = reg.region_string(args.prefix)
            try:
                wm_range = extractor.extract(rs.rsplit(":", 1)[0],
                                             reg.start, reg.end)
            except Exception as e:
                _warn(f"Warning: extraction failed for {rs}: {e}")
                continue
            wins = make_windows(reg.chrom, reg.start, reg.end, args.split)
            parts = split_window_matrix(
                wm_range, [(w.start, w.end) for w in wins]
            )
            expanded.extend(zip(wins, parts))
        window_iter = expanded
    else:
        window_iter = None
    n_ok = n_err = 0
    for item in (window_iter if window_iter is not None else regions):
        if window_iter is not None:
            reg, wm = item
            rs = reg.region_string(args.prefix)
        else:
            reg = item
            rs = reg.region_string(args.prefix)
            try:
                wm = extractor.extract(
                    rs.rsplit(":", 1)[0], reg.start, reg.end
                )
            except Exception as e:
                _warn(f"Warning: extraction failed for {rs}: {e}")
                n_err += 1
                continue
        out = os.path.join(args.out_dir, f"{_sanitize(rs)}.npz")
        np.savez_compressed(
            out,
            geno=wm.geno,
            names=np.asarray(wm.names),
            site_pos=np.asarray(wm.site_pos),
            site_keys=np.asarray(wm.site_keys),
        )
        if args.vcf:
            _write_window_vcf(
                os.path.join(args.out_dir, f"{_sanitize(rs)}.vcf"),
                rs.rsplit(":", 1)[0], wm,
            )
        if args.gfa:
            from impop_tpu.extract.gfa import window_to_gfa
            from impop_tpu.extract.pyfallback import fetch_fasta_window

            target = rs.rsplit(":", 1)[0]
            ref_seq = fetch_fasta_window(fasta_store, target, reg.start,
                                         reg.end)
            with open(os.path.join(args.out_dir,
                                   f"{_sanitize(rs)}.gfa"), "w") as fh:
                fh.write(window_to_gfa(wm, ref_seq, reg.start, target))
        n_ok += 1
    _warn(f"extracted {n_ok} windows ({n_err} failed) -> {args.out_dir}")
    return 0 if n_ok or not n_err else 1


def cmd_gfasim(args) -> int:
    """Variation-graph path similarity — the ``odgi similarity`` capability
    (run_pica2_odgi.sh:96): emit a TSV of length-weighted overlap metrics
    for every path pair, with the ``group.a/group.b/estimated.identity``
    columns pica2 requires (pica2.py:22-27), so ``gfasim | pi --sim-dir``
    reproduces the reference's graph-path π pipeline."""
    from impop_tpu.extract.gfa import read_gfa, similarity_from_gfa

    header, rows = similarity_from_gfa(read_gfa(args.gfa))
    fh = _out_stream(args.output)
    fh.write("\t".join(header) + "\n")
    for row in rows:
        fh.write("\t".join(row) + "\n")
    if args.output:
        fh.close()
    return 0


def cmd_gfa2vcf(args) -> int:
    """Variation graph → VCF — the ``povu gfa2vcf --stdout <ref>``
    capability (run_tajd.sh:148): bubbles vs the reference path become VCF
    records; the non-header line count is the segregating-site count S."""
    from impop_tpu.extract.gfa import alleles_from_gfa, read_gfa

    wm, ref_name = alleles_from_gfa(read_gfa(args.gfa), ref_path=args.ref)
    chrom = ref_name.rsplit(":", 1)[0] if ":" in ref_name else ref_name
    _write_window_vcf(args.output or sys.stdout, chrom, wm)
    if args.npz:
        np.savez_compressed(args.npz, geno=wm.geno,
                            names=np.asarray(wm.names),
                            site_pos=np.asarray(wm.site_pos),
                            site_keys=np.asarray(wm.site_keys))
    return 0


# --------------------------------------------------------------- utilities


def cmd_import_agc(args) -> int:
    """AGC archive → random-access BGZF FASTA store (extract/agc.py).

    The one-command replacement for the reference's reliance on passing
    ``--sequence-files *.agc`` to impg per window
    (run_pica2_impg.sh:162-168): convert once, then every driver runs
    natively from the store."""
    from impop_tpu.extract.agc import convert_agc, list_samples

    if args.list:
        for name in list_samples(args.archive, args.agc_bin):
            print(name)
        return 0
    samples = read_panel_file(args.samples) if args.samples else None
    out = args.output or (args.archive + ".impop.fa.gz")
    convert_agc(args.archive, out, samples=samples, agc_bin=args.agc_bin,
                prefix_sample=args.prefix_sample)
    if args.verify:
        if args.prefix_sample:
            raise SystemExit("error: --verify compares original record "
                             "names; rerun without --prefix-sample")
        from impop_tpu.extract.agc import verify_store

        n_checked = verify_store(args.archive, out, agc_bin=args.agc_bin,
                                 samples=samples)
        _warn(f"verified {n_checked} sequences against the archive "
              "(md5 round-trip)")
    if args.index:
        # force .fai/.gzi creation now (otherwise built on first use)
        try:
            from impop_tpu.extract import load_library

            lib = load_library()
            # open with an empty PAF to trigger FastaReader indexing
            empty_paf = out + ".noalign.paf"
            with open(empty_paf, "w"):
                pass
            h = lib.ix_open(empty_paf.encode(), out.encode())
            err = lib.ix_error(h)
            lib.ix_close(h)
            os.remove(empty_paf)
            if err:
                raise RuntimeError(err.decode())
        except Exception as e:
            _warn(f"Warning: indexing deferred to first use ({e})")
    _warn(f"wrote {out}")
    return 0


def cmd_merge_parts(args) -> int:
    """Merge the per-process ``<file>.partK`` outputs of a distributed scan
    into one file.  Hosts own contiguous window ranges (host_window_range),
    so concatenating tables in part order reproduces the single-process row
    order exactly; AFS spectra merge by summing counts per allele-count bin
    (``--sum``)."""
    import glob as _glob

    base = args.output
    parts = sorted(
        _glob.glob(f"{base}.part*"),
        key=lambda p: int(p.rsplit("part", 1)[1]),
    )
    if not parts:
        raise SystemExit(f"error: no {base}.part* files found")
    if args.sum:
        totals: Dict[int, List[int]] = {}
        header = None
        for path in parts:
            with open(path) as fh:
                header = fh.readline().rstrip("\n")
                for line in fh:
                    cells = line.rstrip("\n").split("\t")
                    k = int(cells[0])
                    vals = [int(x) for x in cells[1:]]
                    if k in totals:
                        totals[k] = [a + b for a, b in zip(totals[k], vals)]
                    else:
                        totals[k] = vals
        with open(base, "w") as out:
            out.write((header or "") + "\n")
            for k in sorted(totals):
                out.write(f"{k}\t" + "\t".join(map(str, totals[k])) + "\n")
    else:
        with open(base, "w") as out:
            for idx, path in enumerate(parts):
                with open(path) as fh:
                    header = fh.readline()
                    if idx == 0:
                        out.write(header)
                    for line in fh:
                        out.write(line)
    if args.remove:
        for path in parts:
            os.remove(path)
    _warn(f"merged {len(parts)} parts -> {base}")
    return 0


def cmd_makewindows(args) -> int:
    out = _out_stream(args.output)
    try:
        if args.bed:
            base = read_bed(args.bed)
        else:
            chrom, start, end = args.region.split(args.sep)
            base = [Region(chrom, int(start), int(end))]
        for reg in base:
            for win in make_windows(reg.chrom, reg.start, reg.end, args.window):
                print(f"{win.chrom}\t{win.start}\t{win.end}", file=out)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def cmd_plot(args) -> int:
    from impop_tpu.report.plots import plot_trend

    return plot_trend(args)


# --------------------------------------------------------------- parser


def _add_sim_args(p):
    p.add_argument("--sim-dir", help="directory of per-window similarity TSVs")
    p.add_argument("--geno-dir", help="directory of per-window allele tiles "
                                      "(.npz) to derive identities from")
    p.add_argument("--paf", help="PAF alignment file")
    p.add_argument("--fasta", help="FASTA sequence store "
                                   "(native extraction with --paf)")
    p.add_argument("--agc", help="AGC archive; auto-converted once to a "
                                 "cached BGZF FASTA store for native "
                                 "extraction (see import-agc)")
    p.add_argument("--agc-bin", default="agc",
                   help="agc binary used for the one-time conversion")
    p.add_argument("--use-impg", action="store_true",
                   help="with --paf + --agc: shell out to external impg per "
                        "window (reference compat) instead of converting")
    p.add_argument("--gfa-dir", help="directory of per-window variation "
                                     "graphs (<region>.gfa) to ingest")
    p.add_argument("--identity-mode", choices=["events", "columns"],
                   default="events",
                   help="native identity deviation spec (doc/how_stats.md): "
                        "'events' counts 1 per variant record; 'columns' "
                        "weighs indels by base length (alignment-column "
                        "semantics, closest to impg similarity)")


def _add_common(p):
    p.add_argument("-b", "--bed", required=True, help="BED file of windows")
    p.add_argument("-P", "--prefix", default="CHM13#0#",
                   help="region prefix (default: CHM13#0#)")
    p.add_argument("-o", "--output", help="output TSV (default: stdout)")
    p.add_argument("-t", "--threshold", type=float, default=0.999)
    p.add_argument("-r", "--round", type=int, default=None,
                   help="round similarities to N decimal places")
    p.add_argument("-d", "--log-dir", default=None,
                   help="directory for per-window debug logs")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="impop-tpu",
        description="JAX population-genomics engine "
                    "(pi / Hudson Fst / Tajima's D / AFS / EHH)",
    )
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("pi", help="nucleotide diversity window scan")
    _add_common(p); _add_sim_args(p)
    p.add_argument("-u", "--subset", help="panel list file (like agc.EUR)")
    p.add_argument("-l", "--length", type=int,
                   help="override per-site normalisation length")
    p.set_defaults(func=cmd_pi)

    for name, fn in (("hfst", cmd_hfst), ("hud", cmd_hud),
                     ("fst3pi", cmd_fst3pi)):
        p = sub.add_parser(name)
        _add_common(p); _add_sim_args(p)
        p.add_argument("-A", "--pop-a", required=True)
        p.add_argument("-B", "--pop-b", required=True)
        p.add_argument("--exact-names", action="store_true",
                       help="panel lists contain exact sequence names "
                            "(hud.py matching) instead of assembly ids "
                            "(h-fst.py prefix matching)")
        if name == "hud":
            p.add_argument("-m", "--method", choices=["direct", "grouped"],
                           default="direct")
        if name in ("hfst", "hud"):
            p.add_argument("--pair-shard", choices=["auto", "on", "off"],
                           default="auto",
                           help="shard the [N, N] pair space by row blocks "
                                "over local devices (direct method, allele "
                                "sources only); auto = when N >= 1024 and "
                                "more than one device is attached")
        p.set_defaults(func=fn)

    p = sub.add_parser("tajd", help="segregating sites + pi + Tajima's D")
    _add_common(p)
    p.add_argument("--geno-dir",
                   help="directory of per-window allele tiles (.npz)")
    p.add_argument("--gfa-dir",
                   help="directory of per-window variation graphs (.gfa)")
    p.add_argument("-l", "--length", type=int)
    p.add_argument("-s", "--samples", help="sample list file")
    p.add_argument("--stream-npy",
                   help="single chromosome-scale window: memory-mapped "
                        "[N, S] int8 .npy allele matrix streamed through "
                        "the device in site chunks (no length cap; the "
                        "BED must contain exactly one row)")
    p.add_argument("--stream-names",
                   help="sequence names for --stream-npy rows (one per "
                        "line, required with -s panel filtering)")
    p.add_argument("--chunk-sites", type=int, default=4096,
                   help="site-chunk width for --stream-npy (default 4096)")
    p.set_defaults(func=cmd_tajd)

    p = sub.add_parser("afs", help="allele-class cluster frequencies (af.py)")
    p.add_argument("--input", default="loc.sim")
    p.add_argument("--threshold", type=float, default=1.0)
    p.add_argument("--output")
    p.add_argument("--details")
    p.set_defaults(func=cmd_afs)

    p = sub.add_parser("panels-hfst", help="all 10 continental pair Fst runs")
    _add_common(p); _add_sim_args(p)
    p.add_argument("--metadata-dir", required=True)
    p.add_argument("--exact-names", action="store_true")
    p.set_defaults(func=cmd_panels_hfst)

    p = sub.add_parser("panels-tajd", help="5 continental panel Tajima runs")
    _add_common(p)
    p.add_argument("--geno-dir")
    p.add_argument("--gfa-dir")
    p.add_argument("--metadata-dir", required=True)
    p.add_argument("-l", "--length", type=int)
    p.set_defaults(func=cmd_panels_tajd)

    p = sub.add_parser("spectrum",
                       help="allele-frequency spectrum from a "
                            "site-by-haplotype table (op-afs)")
    p.add_argument("--input", required=True)
    p.add_argument("--first-site-col", type=int, default=3,
                   help="0-based index of the first site column (default 3)")
    p.add_argument("-o", "--output")
    p.add_argument("--counts-png", default="counts.png")
    p.add_argument("--freqs-png", default="freqs.png")
    p.add_argument("--no-plots", action="store_true")
    p.add_argument("--compat-first-allele", action="store_true",
                   help="record only the first allele per site "
                        "(op-afs.py:40-44 behaviour)")
    p.set_defaults(func=cmd_spectrum)

    p = sub.add_parser("sfs", help="site-frequency spectrum from allele "
                                   "tiles (per-panel, genome-wide merge)")
    p.add_argument("-b", "--bed", required=True)
    p.add_argument("--geno-dir"); p.add_argument("--gfa-dir")
    p.add_argument("--paf"); p.add_argument("--fasta")
    p.add_argument("--agc"); p.add_argument("--agc-bin", default="agc")
    p.add_argument("--panel", action="append", default=[],
                   help="panel list file (repeatable); default: all rows")
    p.add_argument("-P", "--prefix", default="CHM13#0#")
    p.add_argument("-o", "--output")
    p.add_argument("--unfolded", action="store_true",
                   help="derived-allele spectrum (default: folded minor)")
    p.add_argument("--max-n", type=int, default=None,
                   help="histogram bins (default: haplotype capacity)")
    p.add_argument("--per-window",
                   help="also write per-window spectra to this TSV")
    p.set_defaults(func=cmd_sfs)

    p = sub.add_parser("scan", help="fused pi+Fst+TajD scan with resume")
    p.add_argument("-b", "--bed", required=True)
    p.add_argument("--geno-dir", help="directory of per-window .npz tiles")
    p.add_argument("--gfa-dir", help="directory of per-window .gfa graphs")
    p.add_argument("--paf"); p.add_argument("--fasta")
    p.add_argument("--agc", help="AGC archive (one-time cached conversion "
                                 "to a BGZF FASTA store)")
    p.add_argument("--agc-bin", default="agc")
    p.add_argument("--identity-mode", choices=["events", "columns"],
                   default="events",
                   help="identity deviation spec (doc/how_stats.md)")
    p.add_argument("--afs", help="also merge a genome-wide per-panel "
                                 "site-frequency spectrum into this TSV "
                                 "(journal-aware on resume)")
    p.add_argument("--afs-bins", type=int, default=512,
                   help="spectrum histogram bins (default 512)")
    p.add_argument("--ehh", action="store_true",
                   help="append bidirectional EHH decay areas + carrier "
                        "counts for both alleles at each window's focal "
                        "variant (nearest the midpoint, or an --ehh-focal "
                        "position) — the wip/ehhgfa.py capability inside "
                        "the fused scan")
    p.add_argument("--ehh-focal",
                   help="file of 'chrom pos' lines anchoring the EHH "
                        "focal site of the containing window")
    p.add_argument("--afs-unfolded", action="store_true",
                   help="derived-allele spectrum (default: folded minor)")
    p.add_argument("--panel", action="append", default=[],
                   help="panel list file (repeatable, e.g. metadata/agc.EUR)")
    p.add_argument("-P", "--prefix", default="CHM13#0#")
    p.add_argument("-t", "--threshold", type=float, default=0.999)
    p.add_argument("-o", "--output")
    p.add_argument("--journal", help="JSONL journal path for resume")
    p.add_argument("--batch", type=int, default=320,
                   help="windows per device step (larger batches raise "
                        "device throughput, but the host extract/build "
                        "pipeline wants several chunks in flight; smaller "
                        "batches recompile less and resume finer)")
    p.add_argument("--drain-group", type=int, default=4,
                   help="device batches concatenated per result fetch "
                        "(journal flush granularity = batch x this)")
    p.add_argument("--distributed", action="store_true",
                   help="multi-host: jax.distributed.initialize and shard "
                        "the window list across processes")
    p.add_argument("--profile-dir",
                   help="write a jax.profiler trace to this directory")
    p.add_argument("--verbose-timing", action="store_true",
                   help="print per-stage wall times to stderr")
    p.add_argument("--timing-json",
                   help="write the per-stage timing breakdown (with "
                        "per-call samples) to this JSON file")
    p.add_argument("-d", "--log-dir", default=None,
                   help="directory for per-window debug logs (two-channel "
                        "contract: TSV to stdout/-o, intermediates here)")
    p.set_defaults(func=cmd_scan)

    p = sub.add_parser("ehh", help="EHH decay around a focal SNP (ehhgfa)")
    p.add_argument("-i", "--input",
                   help="haplotype matrix file (whitespace, no header); "
                        "omit to feed from the engine's data path "
                        "(--geno-dir or --paf) with -b + --focal")
    p.add_argument("-p", "--position", type=int,
                   help="1-based focal SNP position within the window "
                        "(matrix mode)")
    p.add_argument("-w", "--window", type=int,
                   help="window width in sites (matrix mode)")
    p.add_argument("--refpos", type=int, default=1,
                   help="1-based reference haplotype row (matrix mode)")
    p.add_argument("-b", "--bed", help="window BED (extraction mode)")
    p.add_argument("-P", "--prefix", default="CHM13#0#")
    p.add_argument("--geno-dir",
                   help="directory of per-window allele tiles (.npz)")
    p.add_argument("--paf")
    p.add_argument("--fasta")
    p.add_argument("--agc", help="AGC archive (one-time cached conversion)")
    p.add_argument("--agc-bin", default="agc")
    p.add_argument("--focal", type=int, action="append",
                   help="genomic focal position (repeatable; extraction "
                        "mode picks the window containing it and the "
                        "nearest variant column)")
    p.add_argument("-o", "--output")
    p.add_argument("--compat-ehhgfa", action="store_true",
                   help="reproduce wip/ehhgfa.py's use of the right half "
                        "for both directions")
    p.set_defaults(func=cmd_ehh)

    p = sub.add_parser("extract",
                       help="PAF+FASTA -> per-window allele tiles (.npz)")
    p.add_argument("-b", "--bed", required=True)
    p.add_argument("--paf", required=True)
    p.add_argument("--fasta")
    p.add_argument("--agc", help="AGC archive (one-time cached conversion)")
    p.add_argument("--agc-bin", default="agc")
    p.add_argument("--out-dir", required=True)
    p.add_argument("-P", "--prefix", default="CHM13#0#")
    p.add_argument("--python", action="store_true",
                   help="force the Python fallback extractor")
    p.add_argument("--vcf", action="store_true",
                   help="also write per-window VCFs (povu gfa2vcf "
                        "capability; non-header line count == S)")
    p.add_argument("--gfa", action="store_true",
                   help="also write per-window variation-graph GFAs "
                        "(impg query -o gfa capability)")
    p.add_argument("--split", type=int, default=None,
                   help="extract each BED row once and split into windows "
                        "of this many bp (one CIGAR walk per row)")
    p.set_defaults(func=cmd_extract)

    p = sub.add_parser("gfasim",
                       help="path similarity TSV from a variation graph "
                            "(odgi similarity capability)")
    p.add_argument("gfa", help="GFA v1/v1.1 file")
    p.add_argument("-o", "--output", help="output TSV (default: stdout)")
    p.set_defaults(func=cmd_gfasim)

    p = sub.add_parser("gfa2vcf",
                       help="variants vs reference path from a variation "
                            "graph (povu gfa2vcf capability)")
    p.add_argument("gfa", help="GFA v1/v1.1 file")
    p.add_argument("--ref", help="reference path name (default: "
                                 "CHM13-prefixed or coordinate-named path)")
    p.add_argument("-o", "--output", help="output VCF (default: stdout)")
    p.add_argument("--npz", help="also write the allele tile as .npz")
    p.set_defaults(func=cmd_gfa2vcf)

    p = sub.add_parser("merge-parts",
                       help="merge <file>.partK outputs of a distributed "
                            "scan into one file")
    p.add_argument("output", help="base output path (parts are "
                                  "<output>.part0, .part1, ...)")
    p.add_argument("--sum", action="store_true",
                   help="numeric merge for AFS spectra (sum counts per "
                        "allele-count bin) instead of row concatenation")
    p.add_argument("--remove", action="store_true",
                   help="delete the part files after merging")
    p.set_defaults(func=cmd_merge_parts)

    p = sub.add_parser("import-agc",
                       help="AGC archive -> random-access BGZF FASTA store")
    p.add_argument("archive", help="input .agc archive")
    p.add_argument("-o", "--output",
                   help="output store (default: <archive>.impop.fa.gz)")
    p.add_argument("--samples", help="panel list file: convert only these "
                                     "assemblies")
    p.add_argument("--prefix-sample", action="store_true",
                   help="prefix contig names with '<sample>#' (for archives "
                        "whose contig names collide across assemblies)")
    p.add_argument("--agc-bin", default="agc")
    p.add_argument("--list", action="store_true",
                   help="list assemblies in the archive and exit")
    p.add_argument("--index", action="store_true",
                   help="build the .fai/.gzi indexes immediately")
    p.add_argument("--verify", action="store_true",
                   help="after converting, stream every sample back out of "
                        "the archive and md5-compare each sequence against "
                        "the store (checksum round-trip)")
    p.set_defaults(func=cmd_import_agc)

    p = sub.add_parser("makewindows", help="fixed-width windows from a region")
    p.add_argument("--bed", help="BED of base intervals")
    p.add_argument("--region", help="chrom<sep>start<sep>end string")
    p.add_argument("--sep", default=":")
    p.add_argument("-w", "--window", type=int, required=True)
    p.add_argument("-o", "--output")
    p.set_defaults(func=cmd_makewindows)

    p = sub.add_parser("plot", help="trend plots from result tables")
    p.add_argument("kind", choices=["pi", "fst", "tajd"])
    p.add_argument("--input", action="append", default=[],
                   help="[LABEL=]table.tsv (repeatable)")
    p.add_argument("--input-dir", help="plot every file in a directory")
    p.add_argument("--output", default=None)
    p.add_argument("--title", default=None)
    p.add_argument("--dpi", type=int, default=150)
    p.add_argument("--highlight", action="append", default=[],
                   help="chrom:start-end intervals to shade (repeatable)")
    p.add_argument("--highlight-bed")
    p.add_argument("--linear-y", action="store_true",
                   help="linear y axis for pi (default: log10)")
    p.set_defaults(func=cmd_plot)

    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if getattr(args, "distributed", False):
        # before anything initialises the backends
        from impop_tpu.parallel.distributed import maybe_initialize

        maybe_initialize(True)
    from impop_tpu.runtime.compile_cache import configure_compile_cache

    configure_compile_cache()
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
