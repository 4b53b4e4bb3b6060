"""Smoke test of the main path on NVIDIA GPUs, checked against references.

    python chip_smoke.py          # one card: phases 1-6 below
    python chip_smoke.py --four   # four cards: the multi-device paths only

Run from the root of a checkout.  Every phase compares what the card
computed with the repository's plain references (tests/oracle.py, the f64
numpy oracle of the reference scripts' semantics) and any miss fails the
run; nothing is caught and passed over.  Phases on one card:

1. rebuild the native extraction library from the tracked sources;
2. the headline device program (bench.device_pipeline) and the scan step,
   compiled ahead of time at full width, then 8 windows against the oracle;
3. the `scan` CLI end to end on a simulated 466-haplotype pangenome, cold
   then warm, 16 windows against the oracle on `extract` tiles;
4. `scan --ehh` with overlapping panels on the same data, against the
   oracle and the numpy EHH reference;
5. long-window identity through the chosen route, bit-exact against f32;
6. the card-only tests (`pytest -m gpu`), in this process.

The card's name and power limit come first; the last line of standard
output is {"ok": true, "device": {"platform": "gpu", "kind": ..., "count":
N}}.  Without a GPU, or without the rest of the repository, it exits
non-zero and prints no result.  Scratch data goes to .smoke_work/ in the
checkout and is removed at the end.
"""
from __future__ import annotations

import argparse
import faulthandler
import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
THRESHOLD = 0.999
# 5 panels at HPRC proportions (haplotype counts, bench.PANEL_SIZES)
PANELS = {"AFR": 140, "AMR": 88, "EAS": 100, "EUR": 60, "SAS": 72}
PI_RTOL = 1e-5     # π, dxy: f32 sums of exact counts
FST_ATOL = 2e-3    # Fst ratios: f32 cancellation budget


def log(msg: str) -> None:
    print(msg, flush=True)


class Mismatch(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise Mismatch(what)


def close_rel(got: float, want: float, rtol: float, what: str) -> float:
    err = abs(got - want) / max(abs(want), 1e-30)
    check(err <= rtol or got == want, f"{what}: got {got!r}, want {want!r}")
    return err


def close_abs(got: float, want: float, atol: float, what: str) -> float:
    err = abs(got - want)
    check(err <= atol, f"{what}: got {got!r}, want {want!r}")
    return err


# ------------------------------------------------------------------ oracle


def window_oracle(geno, names, panel_rows, pairs, length, threshold,
                  pairs_only_direct=False, sim_dtype="float32"):
    """Reference statistics of one window from its allele tile.

    geno [n, s] int8 (-1 uncovered), names sorted; panel_rows: {panel:
    row indices}; pairs: [(panel_a, panel_b)].  Similarities are the
    device's f32 values 1 - diff/length over mutually covered sites (so
    strict > threshold decisions match; ``sim_dtype="float64"`` for
    programs that never round a similarity to f32); pairs with no common
    site are absent.  Returns per-panel π (raw), groups, and per-pair
    direct and grouped Hudson and 3-π Fst.
    """
    import numpy as np

    import oracle

    g = np.asarray(geno)
    valid = (g >= 0).astype(np.int32)
    alt = (g == 1).astype(np.int32)
    ref = valid - alt
    diff = alt @ ref.T + ref @ alt.T
    both = valid @ valid.T
    dt = np.dtype(sim_dtype)
    sim = dt.type(1.0) - diff.astype(dt) / dt.type(length)
    # the device compares f32 similarities with an f32 threshold
    threshold = float(dt.type(threshold))
    n = len(names)
    sd = {(names[i], names[j]): float(sim[i, j])
          for i in range(n) for j in range(i + 1, n) if both[i, j] > 0}
    col_ok = valid.sum(0) > 0
    alt_any = (alt.sum(0) > 0)
    ref_any = (ref.sum(0) > 0)
    out = {"s": int((col_ok & alt_any & ref_any).sum()), "n": n,
           "panel": {}, "pair": {}}
    members = {p: [names[i] for i in rows] for p, rows in panel_rows.items()}
    for p, mem in members.items():
        if pairs_only_direct:
            break
        pi, _ = oracle.pica2_pi(sd, mem, threshold)
        groups = oracle.greedy_groups(sd, mem, threshold)
        out["panel"][p] = {"pi": pi, "n": len(mem), "groups": groups}
    for a, b in pairs:
        direct = oracle.hudson_fst_direct(sd, members[a], members[b])
        rec = {"fst": direct["fst"], "dxy": direct["dxy"]}
        if not pairs_only_direct:
            grouped = oracle.hudson_fst_grouped(sd, members[a], members[b],
                                                threshold)
            union = sorted(set(members[a]) | set(members[b]))
            pi_c, _ = oracle.pica2_pi(sd, union, threshold)
            pi_ab = 0.5 * (out["panel"][a]["pi"] + out["panel"][b]["pi"])
            rec.update(fstg=grouped["fst"], pi_c=pi_c,
                       f3=(pi_c - pi_ab) / pi_c if pi_c != 0 else math.nan)
        out["pair"][(a, b)] = rec
    return out


# ------------------------------------------------------------------ phases


def phase_native_library() -> None:
    t0 = time.perf_counter()
    subprocess.run(["make", "-C", os.path.join(ROOT, "cpp"), "-s", "clean",
                    "all"], check=True)
    from impop_tpu.extract import load_library

    load_library()
    log(f"[1] native library rebuilt from cpp/ sources in "
        f"{time.perf_counter() - t0:.1f} s")


def phase_headline(n_check: int = 8) -> None:
    import jax
    import numpy as np

    import bench as B
    from impop_tpu.cli import _scan_buf_layout, _scan_step

    w = B.W_BATCH
    batch = headline_batch(w)
    step = B.device_pipeline()
    specs = [jax.ShapeDtypeStruct(a.shape, a.dtype) for a in batch]
    t0 = time.perf_counter()
    compiled = step.lower(*specs).compile()
    log(f"[2] headline program [{w}, {B.CAP_N}, {B.CAP_S}] compiled in "
        f"{time.perf_counter() - t0:.1f} s; memory_analysis: "
        f"{_memory(compiled)}")

    pair_key = tuple((i, j) for i in range(len(PANELS))
                     for j in range(i + 1, len(PANELS)))
    scan_w = B.E2E_BATCH
    k = _scan_buf_layout(B.CAP_N, B.CAP_S, len(PANELS), False)["total"]
    scan_fn = _scan_step(B.CAP_N, B.CAP_S, len(PANELS), pair_key, THRESHOLD,
                         False, False, 512, True, True,
                         tuple(jax.local_devices()), False)
    t0 = time.perf_counter()
    scan_c = scan_fn.lower(
        jax.ShapeDtypeStruct((scan_w, k), np.uint8)).compile()
    log(f"[2] scan step [{scan_w}, {k}] compiled in "
        f"{time.perf_counter() - t0:.1f} s; memory_analysis: "
        f"{_memory(scan_c)}")

    args = tuple(jax.device_put(a) for a in batch)
    jax.block_until_ready(compiled(*args))
    t0 = time.perf_counter()
    for _ in range(3):
        out = compiled(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / 3
    log(f"[2] headline step {dt * 1e3:.1f} ms / {w} windows = "
        f"{w / dt:.1f} windows/s = {w / dt / B.UNIT_WINDOWS:.2f} "
        f"200kb-units/s ({_card()})")
    check_headline(n_check, w, run=compiled)


def headline_batch(w):
    import numpy as np

    import bench as B

    return B.synth_batch(np.random.default_rng(SEED), w=w)


def check_headline(n_check, batch, run=None) -> None:
    """The headline program (bench.device_pipeline, or its compiled form
    ``run``) on ``batch`` windows; the first ``n_check`` against the
    oracle, with dxy, counts and group ids from the same library calls."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench as B
    from impop_tpu.stats.allele import identity_from_alleles
    from impop_tpu.stats.grouping import greedy_group_panels
    from impop_tpu.stats.panelstats import (fused_window_stats,
                                            panel_mask_stack)

    geno, member, smask, panels, lengths = headline_batch(batch)
    out = (run or B.device_pipeline())(geno, member, smask, panels, lengths)
    pi_d, _d, fst_d, fstg_d, f3_d, s_d = (np.asarray(x) for x in out)

    # the same library calls, unwrapped, for the fields the bench step
    # does not return: dxy, counts and the group ids
    names = list(PANELS)
    pa = jnp.asarray([names.index(a) for a, _ in B.PAIRS], jnp.int32)
    pb = jnp.asarray([names.index(b) for _, b in B.PAIRS], jnp.int32)

    @jax.jit
    def detail(g, m, sm, p1, ln):
        def one(g1, m1, sm1, ps, l1):
            _s, _p, _sc, res = fused_window_stats(
                g1, m1, sm1, l1, ps, pa, pb, jnp.float32(THRESHOLD),
                pairs_disjoint=True, return_matrices=False)
            sim, present = identity_from_alleles(g1, m1, sm1, l1)
            masks, _, _ = panel_mask_stack(ps, m1, pa, pb, True)
            gid = greedy_group_panels(sim, present, m1, masks,
                                      jnp.float32(THRESHOLD))
            return (res.hudson.dxy, res.n, res.num_groups, res.pairs_used,
                    gid)
        return jax.vmap(one)(g, m, sm, p1, ln)

    dxy_d, n_d, ng_d, pu_d, gid_d = (np.asarray(x) for x in detail(
        *(a[:n_check] for a in (geno, member, smask, panels, lengths))))
    worst = {"pi": 0.0, "dxy": 0.0, "fst": 0.0}
    for wi in range(n_check):
        rows = np.nonzero(member[wi])[0]
        g = geno[wi][rows][:, smask[wi]]
        wnames = [f"h{i:04d}" for i in range(len(rows))]
        prow = {p: list(np.nonzero(panels[wi, pi, rows])[0])
                for pi, p in enumerate(names)}
        L = float(lengths[wi])
        ref = window_oracle(g, wnames, prow, B.PAIRS, L, THRESHOLD)
        check(int(s_d[wi]) == ref["s"], f"w{wi} S {s_d[wi]} != {ref['s']}")
        for pi, p in enumerate(names):
            want = ref["panel"][p]
            worst["pi"] = max(worst["pi"], close_rel(
                float(pi_d[wi, pi]) * L, want["pi"], PI_RTOL,
                f"w{wi} pi {p}"))
            check(int(n_d[wi, pi]) == want["n"], f"w{wi} n {p}")
            check(int(ng_d[wi, pi]) == len(want["groups"]),
                  f"w{wi} num_groups {p}")
            ng = len(want["groups"])
            check(int(pu_d[wi, pi]) == ng * (ng - 1) // 2,
                  f"w{wi} pairs_used {p}")
            seed_of = np.full(B.CAP_N, B.CAP_N)
            for grp in want["groups"]:
                for nm in grp:
                    seed_of[rows[wnames.index(nm)]] = rows[
                        wnames.index(grp[0])]
            check(np.array_equal(gid_d[wi, pi], seed_of), f"w{wi} gid {p}")
        for qi, pr in enumerate(B.PAIRS):
            want = ref["pair"][pr]
            worst["dxy"] = max(worst["dxy"], close_rel(
                float(dxy_d[wi, qi]), want["dxy"], PI_RTOL,
                f"w{wi} dxy {pr}"))
            for key, got in (("fst", fst_d), ("fstg", fstg_d),
                             ("f3", f3_d)):
                worst["fst"] = max(worst["fst"], close_abs(
                    float(got[wi, qi]), want[key], FST_ATOL,
                    f"w{wi} {key} {pr}"))
    log(f"[2] headline vs f64 oracle OK over {n_check} windows x 5 panels "
        f"x 10 pairs (S, n, num_groups, pairs_used, gid exact); worst "
        f"pi rel {worst['pi']:.2e}, dxy rel {worst['dxy']:.2e}, "
        f"Fst abs {worst['fst']:.2e}")


def _memory(compiled) -> str:
    m = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    return ", ".join(f"{f.replace('_size_in_bytes', '')} "
                     f"{getattr(m, f) / 2**30:.3f} GiB" for f in fields)


def _card() -> str:
    import jax

    import bench

    return (f"{jax.devices()[0].device_kind}, power limit "
            f"{bench.nvidia_smi_line().split(',')[-1].strip()}")


def simulate_pangenome(work, ref_len, n_haps):
    """Simulated pangenome (n_haps + CHM13) and the 5 panels' lists."""
    from impop_tpu.extract.simulate import simulate

    sim = simulate(os.path.join(work, "pan"), ref_len=ref_len,
                   n_haps=n_haps, site_pool=ref_len // 60, seed=SEED % 1000,
                   span=(0, ref_len))
    return sim, write_panels(work, sim, overlap=False)


def write_panels(work, sim, overlap):
    """Panel lists of PANELS' sizes in the reference's panel-list
    convention (SAMPLE_hapN, h-fst.py:18-61); ``overlap`` makes each panel
    also take the last quarter of the previous one's haplotypes.
    Returns {panel: list path}."""
    ents = [f"{h.name.split('#')[0]}_hap{h.name.split('#')[1]}"
            for h in sim.haplotypes]
    files, start = {}, 0
    tag = "ov" if overlap else "dj"
    for p, size in PANELS.items():
        lo = max(0, start - size // 4) if overlap else start
        path = os.path.join(work, f"{tag}.{p}")
        with open(path, "w") as fh:
            fh.write("\n".join(ents[lo:start + size]) + "\n")
        files[p] = path
        start += size
    return files


def write_bed(path, windows):
    with open(path, "w") as fh:
        for lo, hi in windows:
            fh.write(f"chr1\t{lo}\t{hi}\n")


def run_scan(sim, bed, panel_files, out, batch, extra=()):
    """The `scan` CLI; returns (rows, timing) and checks the extractor."""
    import impop_tpu.cli as cli
    from impop_tpu.extract import NativeExtractor

    used = []
    real_open = cli._open_extractor

    def recording_open(*a, **kw):
        ext = real_open(*a, **kw)
        used.append(type(ext))
        return ext

    timing = out + ".timing.json"
    argv = ["scan", "-b", bed, "--paf", sim.paf_path, "--fasta",
            sim.fasta_path, "-P", "CHM13#0#", "-o", out, "--batch",
            str(batch), "--timing-json", timing, *extra]
    for p in sorted(panel_files.values()):
        argv += ["--panel", p]
    cli._open_extractor = recording_open
    try:
        check(cli.main(argv) == 0, "scan exit code")
    finally:
        cli._open_extractor = real_open
    check(used == [NativeExtractor],
          f"scan must use the native extractor, used {used}")
    with open(out) as fh:
        rows = [ln.rstrip("\n").split("\t") for ln in fh if ln.strip()]
    with open(timing) as fh:
        return rows, json.load(fh)


def check_rows_finite(rows, n_windows):
    hdr = rows[0]
    check(len(rows) == n_windows + 1,
          f"{len(rows) - 1} rows for {n_windows} windows")
    for r in rows[1:]:
        check(len(r) == len(hdr), f"row width {r[0]}")
        for name, cell in zip(hdr[1:], r[1:]):
            if cell == "NA":
                # Tajima's D without segregating sites, 3-π Fst with a
                # zero union π: the reference's own NA cases
                check(name.startswith(("TAJD_", "FST3_", "EHH_FOCAL")),
                      f"{r[0]} {name} is NA")
                continue
            check(math.isfinite(float(cell)), f"{r[0]} {name}={cell}")


def extract_tiles(sim, bed, work, tag):
    import impop_tpu.cli as cli

    out_dir = os.path.join(work, f"tiles_{tag}")
    check(cli.main(["extract", "-b", bed, "--paf", sim.paf_path, "--fasta",
                    sim.fasta_path, "-P", "CHM13#0#", "--out-dir", out_dir])
          == 0, "extract exit code")
    return out_dir


def load_tile(out_dir, region):
    import numpy as np

    from impop_tpu.cli import _sanitize

    d = np.load(os.path.join(out_dir, f"{_sanitize(region)}.npz"))
    names = [str(x) for x in d["names"]]
    order = np.argsort(names)
    return (d["geno"].astype(np.int8)[order], [names[i] for i in order],
            np.asarray(d["site_pos"]))


def panel_rows_for(names, panel_files):
    from impop_tpu.io.panels import expand_population, read_panel_file

    stems = [n.split(":", 1)[0] for n in names]
    rows = {}
    for p, path in panel_files.items():
        matched, _ = expand_population(read_panel_file(path), stems)
        rows[p] = [i for i, s in enumerate(stems) if s in matched]
    return rows


def compare_scan_logs(log_dir, tiles, regions, panel_files, lengths,
                      tag, ehh_rows=None):
    """Scan window logs (full f32 values) against the oracle on tiles."""
    import numpy as np

    import oracle
    from impop_tpu.cli import _sanitize

    names_p = sorted(panel_files)
    pairs = [(a, b) for i, a in enumerate(names_p) for b in names_p[i + 1:]]
    worst = {"pi": 0.0, "fst": 0.0, "ehh": 0.0}
    for rs, length in zip(regions, lengths):
        with open(os.path.join(log_dir, f"{_sanitize(rs)}.log")) as fh:
            got = json.loads(fh.read().strip().splitlines()[-1])
        geno, names, site_pos = load_tile(tiles, rs)
        prow = panel_rows_for(names, panel_files)
        ref = window_oracle(geno, names, prow, pairs, length, THRESHOLD)
        check(got["n"] == ref["n"], f"{rs} n")
        check(got["segregating_sites"] == ref["s"], f"{rs} S")
        for p in names_p:
            worst["pi"] = max(worst["pi"], close_rel(
                got[f"pi_{p}"] * length, ref["panel"][p]["pi"], PI_RTOL,
                f"{rs} pi {p}"))
        for a, b in pairs:
            want = ref["pair"][(a, b)]
            for key in ("fst", "fstg"):
                worst["fst"] = max(worst["fst"], close_abs(
                    got[f"{key}_{a}_{b}"], want[key], FST_ATOL,
                    f"{rs} {key} {a}_{b}"))
            f3 = got[f"fst3_{a}_{b}"]
            if f3 == "NA":
                check(math.isnan(want["f3"]), f"{rs} fst3 {a}_{b} NA")
            else:
                worst["fst"] = max(worst["fst"], close_abs(
                    f3, want["f3"], FST_ATOL, f"{rs} fst3 {a}_{b}"))
        if ehh_rows is not None:
            row = ehh_rows[rs]
            if len(site_pos) == 0:
                check(row["EHH_FOCAL"] == "NA", f"{rs} EHH focal")
                continue
            mid = int(rs.rsplit(":", 1)[1].split("-")[0]) + length // 2
            fi = int(np.argmin(np.abs(site_pos - mid)))
            check(row["EHH_FOCAL"] == str(int(site_pos[fi])),
                  f"{rs} EHH focal")
            areas, carr = oracle.ehh_areas((geno == 1).astype(np.int8), fi)
            check([int(row["EHH_CARR_REF"]), int(row["EHH_CARR_ALT"])]
                  == list(carr), f"{rs} EHH carriers")
            for key, want in zip(("EHH_AREA_REF", "EHH_AREA_ALT"), areas):
                # the TSV prints 6 decimals: half a unit of the last digit
                worst["ehh"] = max(worst["ehh"], close_abs(
                    float(row[key]), want, 1e-6 * abs(want) + 5e-7,
                    f"{rs} {key}"))
    log(f"[{tag}] scan vs f64 oracle OK over {len(regions)} windows on "
        f"extract tiles (n, S exact); worst pi rel {worst['pi']:.2e}, "
        f"Fst abs {worst['fst']:.2e}"
        + (f", EHH area abs {worst['ehh']:.2e}" if ehh_rows else ""))


def phase_scan(work, ref_len=3_200_000, n_haps=465, batch=320,
               n_check=16, tag="3"):
    """Phases 3 and 4 on one simulated pangenome of 5 kb windows."""
    win = 5000
    t0 = time.perf_counter()
    sim, panels = simulate_pangenome(work, ref_len, n_haps)
    log(f"[{tag}] simulated {n_haps} haplotypes + CHM13 over {ref_len} bp "
        f"in {time.perf_counter() - t0:.1f} s")
    windows = [(lo, lo + win) for lo in range(0, ref_len, win)]
    bed = os.path.join(work, "all.bed")
    write_bed(bed, windows)
    logs = os.path.join(work, "logs_cold")
    log(f"[{tag}] scan of {len(windows)} windows, cold")
    rows, t_cold = run_scan(sim, bed, panels, os.path.join(work, "cold.tsv"),
                            batch, ("--log-dir", logs))
    check_rows_finite(rows, len(windows))
    rows_w, t_warm = run_scan(sim, bed, panels,
                              os.path.join(work, "warm.tsv"), batch)
    check(rows_w == rows, "warm scan output differs from cold")
    comp = t_cold["stages"].get("compile", {}).get("total_sec", 0.0)
    log(f"[{tag}] scan {len(windows)} windows --batch {batch}: cold "
        f"{t_cold['elapsed_sec']:.1f} s (compile {comp:.1f} s), warm "
        f"{t_warm['elapsed_sec']:.1f} s = "
        f"{len(windows) / t_warm['elapsed_sec']:.1f} windows/s; warm "
        f"stages " + json.dumps({k: round(v["total_sec"], 3) for k, v in
                                 t_warm["stages"].items()})
        + f" ({_card()})")

    step = max(1, len(windows) // n_check)
    picked = windows[::step][:n_check]
    regions = [f"CHM13#0#chr1:{lo}-{hi}" for lo, hi in picked]
    bed_p = os.path.join(work, "picked.bed")
    write_bed(bed_p, picked)
    tiles = extract_tiles(sim, bed_p, work, tag)
    lengths = [float(hi - lo) for lo, hi in picked]
    compare_scan_logs(logs, tiles, regions, panels, lengths, tag)

    # phase 4: --ehh and overlapping panels on the same data
    tag4 = str(int(tag) + 1) if tag.isdigit() else tag + "+ehh"
    ov = write_panels(work, sim, overlap=True)
    logs4 = os.path.join(work, "logs_ehh")
    rows4, _t = run_scan(sim, bed_p, ov, os.path.join(work, "ehh.tsv"),
                         len(picked), ("--ehh", "--log-dir", logs4))
    check_rows_finite(rows4, len(picked))
    hdr = rows4[0]
    ehh_rows = {r[0]: dict(zip(hdr, r)) for r in rows4[1:]}
    compare_scan_logs(logs4, tiles, regions, ov, lengths, tag4, ehh_rows)


def phase_long_window(n=512, s=8192, w=64, n_check=2) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from impop_tpu.stats.allele import (identity_from_alleles,
                                        identity_route, pairwise_identity_f32)

    route = identity_route(jax.default_backend(), False)
    rng = np.random.default_rng(SEED + 5)
    classes = rng.integers(0, 2, size=(16, s)).astype(np.int8)
    g = classes[rng.integers(0, 16, size=(w, n))]
    g = np.where(rng.random((w, n, s)) < 0.001, 1 - g, g).astype(np.int8)
    g[rng.random((w, n, s)) < 0.01] = -1
    g[:, 466:] = -1
    member = np.zeros((w, n), bool)
    member[:, :466] = True
    smask = rng.random((w, s)) < 0.98
    length = jnp.float32(500000.0)
    chosen = jax.jit(jax.vmap(
        lambda a, b, c: identity_from_alleles(a, b, c, length)))
    ref = jax.jit(jax.vmap(
        lambda a, b, c: pairwise_identity_f32(a, b, c, length)))
    args = tuple(jax.device_put(a) for a in (g, member, smask))
    sim, pres = jax.block_until_ready(chosen(*args))
    t0 = time.perf_counter()
    for _ in range(3):
        out = chosen(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / 3
    sim_r, pres_r = ref(*(a[:n_check] for a in args))
    check(np.array_equal(np.asarray(pres[:n_check]), np.asarray(pres_r)),
          "long-window present differs from the f32 route")
    check(np.array_equal(np.asarray(sim[:n_check]), np.asarray(sim_r)),
          "long-window sim differs from the f32 route")
    log(f"[5] long window [{n}, {s}] x {w} via the {route} route: "
        f"{dt * 1e3:.1f} ms/batch = {n * n * s * w / dt / 1e12:.1f} "
        f"Tcells/s ({_card()}); sim/present bit-exact vs f32 on "
        f"{n_check} windows")


class _Outcomes:
    """pytest plugin counting test outcomes."""

    def __init__(self):
        self.counts = {"passed": 0, "failed": 0, "skipped": 0}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] += 1


def phase_gpu_tests() -> None:
    import pytest

    # conftest forces the CPU only when no platform is named
    os.environ.setdefault("JAX_PLATFORMS", "cuda")
    counter = _Outcomes()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_gpu.py")],
                     plugins=[counter])
    c = counter.counts
    check(rc == 0 and c["failed"] == 0 and c["skipped"] == 0
          and c["passed"] > 0, f"pytest -m gpu: rc {rc}, {c}")
    log(f"[6] pytest -m gpu: {c['passed']} passed")


# ----------------------------------------------------------- four cards


def four_cards(work, ref_len=400_000, n_haps=465, batch=40,
               n_pair=1024, long_s=8192) -> None:
    """The three multi-device paths, each against the oracle."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import impop_tpu.cli as cli
    from impop_tpu.parallel.longwindow import site_sharded_window_stats
    from impop_tpu.parallel.mesh import make_mesh

    n_dev = len(jax.local_devices())
    # (a) window-parallel scan over every local device (shard_map, data)
    t0 = time.perf_counter()
    phase_scan(work, ref_len=ref_len, n_haps=n_haps, batch=batch,
                     n_check=8, tag="4a")
    log(f"[4a] window-parallel scan over {n_dev} devices OK in "
        f"{time.perf_counter() - t0:.1f} s")

    # (b) hfst --pair-shard: [N, N] row blocks over `data`, psum
    rng = np.random.default_rng(SEED + 7)
    s = 256
    classes = rng.integers(0, 2, size=(24, s)).astype(np.int8)
    geno = classes[rng.integers(0, 24, size=n_pair)]
    geno = np.where(rng.random((n_pair, s)) < 0.01, 1 - geno, geno)
    geno[rng.random((n_pair, s)) < 0.02] = -1
    names = [f"HG{i // 2:05d}#{i % 2 + 1}#c{i}" for i in range(n_pair)]
    gdir = os.path.join(work, "pairshard")
    os.makedirs(gdir, exist_ok=True)
    np.savez(os.path.join(gdir, "chr1:0-5000.npz"), geno=geno.astype(np.int8),
             names=np.asarray(names))
    bed = os.path.join(work, "ps.bed")
    write_bed(bed, [(0, 5000)])
    pa = os.path.join(work, "ps.A")
    pb = os.path.join(work, "ps.B")
    with open(pa, "w") as fh:
        fh.write("\n".join(f"HG{i:05d}" for i in range(0, 260)) + "\n")
    with open(pb, "w") as fh:
        fh.write("\n".join(f"HG{i:05d}" for i in range(240, 512)) + "\n")
    logd = os.path.join(work, "ps_logs")
    t0 = time.perf_counter()
    check(cli.main(["hfst", "-b", bed, "-P", "", "--geno-dir", gdir,
                    "-A", pa, "-B", pb, "--pair-shard", "on",
                    "-d", logd, "-o", os.path.join(work, "ps.tsv")]) == 0,
          "hfst --pair-shard exit code")
    with open(os.path.join(logd, f"{cli._sanitize('chr1:0-5000')}.log")) as fh:
        got = json.loads(fh.read().strip().splitlines()[-1])
    check(got["devices"] == n_dev, f"pair-shard devices {got['devices']}")
    order = np.argsort(names)
    snames = [names[i] for i in order]
    rows = {"A": [i for i, nm in enumerate(snames)
                  if int(nm[2:7]) < 260],
            "B": [i for i, nm in enumerate(snames)
                  if int(nm[2:7]) >= 240]}
    # the pair-sharded sums divide counts by the length directly, with no
    # f32 similarity in between: an f64 oracle
    ref = window_oracle(geno[order], snames, rows, [("A", "B")], 5000.0,
                        THRESHOLD, pairs_only_direct=True,
                        sim_dtype="float64")
    want = ref["pair"][("A", "B")]
    e_dxy = close_rel(got["dxy"], want["dxy"], PI_RTOL, "pair-shard dxy")
    e_fst = close_abs(got["fst"], want["fst"], FST_ATOL, "pair-shard fst")
    log(f"[4b] hfst --pair-shard N={n_pair} over {n_dev} devices vs "
        f"oracle OK in {time.perf_counter() - t0:.1f} s: dxy rel "
        f"{e_dxy:.2e}, Fst abs {e_fst:.2e}")

    # (c) site-sharded long window: psum over `site`
    mesh = make_mesh(data=1, site=n_dev)
    w, n = 2, 512
    classes = rng.integers(0, 2, size=(16, long_s)).astype(np.int8)
    g = classes[rng.integers(0, 16, size=(w, n))]
    g = np.where(rng.random((w, n, long_s)) < 0.001, 1 - g, g)
    g = g.astype(np.int8)
    g[:, 466:] = -1
    member = np.zeros((w, n), bool)
    member[:, :466] = True
    smask = np.ones((w, long_s), bool)
    lengths = np.full(w, 500000.0, np.float32)
    f = site_sharded_window_stats(mesh, max_n=n)
    t0 = time.perf_counter()
    with mesh:
        pi_site, s_count, _d = (np.asarray(x) for x in f(
            g, member, smask, lengths, jnp.float32(THRESHOLD)))
    worst = 0.0
    for wi in range(w):
        nm = [f"h{i:04d}" for i in range(466)]
        ref = window_oracle(g[wi, :466], nm, {"all": list(range(466))}, [],
                            float(lengths[wi]), THRESHOLD)
        check(int(s_count[wi]) == ref["s"], f"site-shard S w{wi}")
        worst = max(worst, close_rel(
            float(pi_site[wi]) * float(lengths[wi]),
            ref["panel"]["all"]["pi"], PI_RTOL, f"site-shard pi w{wi}"))
    log(f"[4c] site-sharded long window [{n}, {long_s}] over {n_dev} "
        f"devices vs oracle OK in {time.perf_counter() - t0:.1f} s: pi "
        f"rel {worst:.2e}, S exact")


# ------------------------------------------------------------------ main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-device paths, on 4 cards")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"error: needs a GPU; JAX found {devs[0].platform}",
              file=sys.stderr)
        return 1
    want = 4 if args.four else 1
    if len(devs) < want:
        print(f"error: needs {want} GPUs; JAX found {len(devs)}",
              file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import bench
    from impop_tpu.runtime.compile_cache import configure_compile_cache

    log(bench.nvidia_smi_line())

    log(f"compile cache: {configure_compile_cache()}")
    work = os.path.join(ROOT, ".smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        if args.four:
            phase_native_library()
            four_cards(work)
        else:
            phase_native_library()
            phase_headline()
            phase_scan(work)
            phase_long_window()
            phase_gpu_tests()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    # a crash in native code still names the Python frames of every thread
    faulthandler.enable()
    sys.exit(main())
