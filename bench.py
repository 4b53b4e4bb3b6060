"""Benchmark: 200kb-windows/sec/chip for the full π + Fst + Tajima's D panel
workload (BASELINE.json north-star metric), in three regimes:

1. **device** (headline `value`): the fused per-window-batch device program
   on device-resident synthetic HPRC-shaped tiles — per 5 kb window with 466
   haplotypes: pica2-grouped π for the 5 continental panels
   (run_tajd_panels.sh:60-66), Hudson Fst direct AND grouped for all 10
   panel pairs (run_h_fst_panels.sh:60-71, hud.py -m grouped), 3-π Fst for
   all 10 pairs (run_fst_impg.sh), S + Tajima's D (run_tajd.sh).  One
   "200kb unit" = 40 such windows (doc/how_h-fst.md:5).
2. **e2e** (`e2e_units_per_sec`): the real `scan` CLI on a simulated
   PAF+FASTA pangenome — native C++ extraction + H2D + device + table emit,
   steady-state (the first device call's jit compile is excluded via the
   per-call timing samples; everything else, including the threaded
   extraction pipeline, is included).
3. **long-window** (`long_window`): the site-streaming regime the reference
   cannot reach (its impg caps windows at 10 kb, doc/how_pi.md:40) — the
   pairwise-identity route (stats/allele.identity_route) + S on
   [512, 8192] tiles (~500 kb of variation at HPRC density), reported as
   windows/sec and Gcells/sec (N·N·S cells per window), and as a share of
   the device's peak for the operand type its route runs.

``vs_baseline``: the same statistics semantics timed through the pure-Python
reference path (tests/oracle.py — the dict-based algorithms of
pica2.py/h-fst.py/tj_d.py) on one window of regime 1, extrapolated.  The
reference's impg extraction cost is excluded from both sides (it is
replaced, not ported).

Prints the card's name and power limit, then ONE json line; `value` is the
regime-1 headline and `device` names the platform, kind and device count
every number was measured on.  Any failing regime fails the run.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _HERE)
sys.path.insert(0, os.path.join(_HERE, "tests"))

N_HAP = 466          # HPRC r2 assemblies + CHM13 (doc/where_hprc_data.md)
CAP_N = 512
CAP_S = 128          # segregating-site capacity per 5 kb window
WIN_BP = 5000.0
W_BATCH = int(os.environ.get("IMPOP_BENCH_BATCH", 2240))
                     # 56 200kb units per device step
ITERS = int(os.environ.get("IMPOP_BENCH_ITERS", 32))
E2E_BATCH = int(os.environ.get("IMPOP_BENCH_E2E_BATCH", 320))
                     # the e2e scan keeps smaller batches: its two-stage
                     # host pipeline (extract worker / build worker) needs
                     # several chunks in flight to overlap, and 2000
                     # windows at 960/batch would be only 3 pipeline fills
UNIT_WINDOWS = 40
THRESHOLD = 0.999

# panel haplotype counts ~ 2x the HPRC sample counts (doc/where_hprc_data.md:4-10)
PANEL_SIZES = {"AFR": 140, "AMR": 88, "EAS": 100, "EUR": 60, "SAS": 72}
PAIRS = [(a, b) for i, a in enumerate(PANEL_SIZES) for b in list(PANEL_SIZES)[i + 1:]]

# Dense peak rates by jax device_kind (NVIDIA H100 data sheet, SXM part,
# without sparsity; at the full 700 W power limit): TFLOP/s (TOP/s for
# int8) per operand type of a matmul, and HBM TB/s.  "f32" is the rate
# outside the tensor cores, where HIGHEST-precision f32 dots run.  A kind
# missing here is an error, never a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16": 989.0, "int8": 1979.0, "f32": 67.0, "hbm_tb_s": 3.35,
    },
}


def peak_for(kind: str) -> dict:
    """The PEAKS row of a device kind; KeyError for an unknown kind."""
    if kind not in PEAKS:
        raise KeyError(f"no peak rates for device kind {kind!r}; add its "
                       "data-sheet row to bench.PEAKS")
    return PEAKS[kind]


def nvidia_smi_line() -> str:
    """`name, power.limit` of the card(s), as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def synth_batch(rng, w=W_BATCH):
    """HPRC-shaped synthetic windows: few distinct haplotype classes with
    class-structured variation (realistic for identity thresholds)."""
    geno = np.full((w, CAP_N, CAP_S), -1, dtype=np.int8)
    member = np.zeros((w, CAP_N), dtype=bool)
    site_mask = np.zeros((w, CAP_S), dtype=bool)
    for wi in range(w):
        n_classes = int(rng.integers(3, 12))
        n_sites = int(rng.integers(20, CAP_S))
        classes = rng.integers(0, 2, size=(n_classes, n_sites)).astype(np.int8)
        assign = rng.integers(0, n_classes, size=N_HAP)
        g = classes[assign]
        noise = rng.random((N_HAP, n_sites)) < 0.001
        g = np.where(noise, 1 - g, g)
        geno[wi, :N_HAP, :n_sites] = g
        member[wi, :N_HAP] = True
        site_mask[wi, :n_sites] = True
    panels = np.zeros((w, len(PANEL_SIZES), CAP_N), dtype=bool)
    start = 0
    for pi, size in enumerate(PANEL_SIZES.values()):
        panels[:, pi, start:start + size] = True
        start += size
    lengths = np.full((w,), WIN_BP, dtype=np.float32)
    return geno, member, site_mask, panels, lengths


def device_pipeline():
    import jax
    import jax.numpy as jnp

    from impop_tpu.stats.panelstats import fused_window_stats
    from impop_tpu.stats.tajima import tajimas_d

    pair_a = jnp.asarray(
        [list(PANEL_SIZES).index(a) for a, _ in PAIRS], jnp.int32
    )
    pair_b = jnp.asarray(
        [list(PANEL_SIZES).index(b) for _, b in PAIRS], jnp.int32
    )
    t = jnp.float32(THRESHOLD)

    def one_window(g, m, smask, panels1, length):
        # the entire per-window program — identity + shared grouping +
        # group-size weights + the stacked panel reduction + S (the
        # reference runs 35 impg+pica2/h-fst process pairs for the same
        # work); bench panels are disjoint by construction
        _sim, _present, s_countf, res = fused_window_stats(
            g, m, smask, length, panels1, pair_a, pair_b, t,
            pairs_disjoint=True, return_matrices=False)
        p_count = panels1.shape[0]
        pi_panel = res.pi[:p_count]
        pi_c = res.pi[p_count:]
        d = tajimas_d(res.n[:p_count], s_countf, pi_panel / length)
        hud = res.hudson.fst
        # grouped-method Hudson (hud.py -m grouped) for the same 10 pairs —
        # seed-representative weight rows inside the same fused reduction
        hudg = res.hudson_grouped.fst
        pi_ab = 0.5 * (pi_panel[pair_a] + pi_panel[pair_b])
        f3 = jnp.where(
            pi_c != 0, (pi_c - pi_ab) / jnp.where(pi_c != 0, pi_c, 1.0), jnp.nan
        )
        return pi_panel / length, d, hud, hudg, f3, s_countf

    step = jax.jit(jax.vmap(one_window, in_axes=(0, 0, 0, 0, 0)))
    return step


def bench_device(step, batch, iters=ITERS):
    import jax

    # device-resident inputs: window tiles are prefetched/pipelined by the
    # scan runtime in production (the e2e regime includes the transfer)
    batch = tuple(jax.device_put(a) for a in batch)
    jax.block_until_ready(step(*batch))  # compile + warm
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step(*batch)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    windows_per_sec = W_BATCH * iters / dt
    return windows_per_sec, out


def bench_long_window(iters=max(ITERS // 2, 2), n=512, s=8192, wbatch=64):
    """Long-window regime: identity (stats/allele.identity_route) + S on
    [n, s] tiles.

    s=8192 variant sites ≈ 500 kb of HPRC-density variation — 50-100x the
    reference's 10 kb window cap.  ``wbatch`` windows run per dispatch
    (vmap), matching how the scan feeds the device."""
    import jax
    import jax.numpy as jnp

    from impop_tpu.stats.allele import (identity_from_alleles,
                                        identity_route, segregating_sites)

    rng = np.random.default_rng(7)
    classes = rng.integers(0, 2, size=(16, s)).astype(np.int8)
    g = classes[rng.integers(0, 16, size=(wbatch, n))]
    g = np.where(rng.random((wbatch, n, s)) < 0.001, 1 - g, g).astype(np.int8)
    g[:, N_HAP:] = -1
    member = np.zeros((wbatch, n), bool); member[:, :N_HAP] = True
    smask = np.ones((wbatch, s), bool)
    length = jnp.float32(500000.0)

    @jax.jit
    def step(g, m, sm):
        def one(g1, m1, sm1):
            sim, present = identity_from_alleles(g1, m1, sm1, length)
            return jnp.sum(sim), segregating_sites(g1, m1, sm1)

        return jax.vmap(one)(g, m, sm)

    g_d = jax.device_put(jnp.asarray(g))
    m_d = jax.device_put(jnp.asarray(member))
    sm_d = jax.device_put(jnp.asarray(smask))
    jax.block_until_ready(step(g_d, m_d, sm_d))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step(g_d, m_d, sm_d)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    per_win = dt / (iters * wbatch)
    gcells = n * n * s / 1e9
    # operation rate at the full-product cost model (4 ops/cell: the z/v
    # formulation's two Grams over all N² cells; the f32 route runs three
    # Grams, so its share is conservative) against the peak of the
    # operand type the route runs (int8 on the GPU)
    route = identity_route(jax.default_backend(), False)
    peak = peak_for(jax.devices()[0].device_kind)[route]
    tops = gcells * 4.0 / per_win / 1e3
    return {
        "n": n, "s": s, "wbatch": wbatch, "route": route,
        "windows_per_sec": round(iters * wbatch / dt, 3),
        "gcells_per_sec": round(gcells / per_win, 2),
        "tops": round(tops, 2),
        "peak_share_pct": round(100.0 * tops / peak, 2),
    }


def bench_ehh(iters=8, w=64, n=CAP_N, s=CAP_S):
    """EHH regime: batched bidirectional decay areas for both alleles at
    the focal site of every window (wip/ehhgfa.py:47-69 capability) — one
    compiled program for the whole window batch, vs the reference's
    per-(carriers, suffix) numpy loops."""
    import jax
    import jax.numpy as jnp

    from impop_tpu.stats.ehh import ehh_area_batch

    rng = np.random.default_rng(13)
    classes = rng.integers(0, 2, size=(8, s)).astype(np.int8)
    g = classes[rng.integers(0, 8, size=(w, n))]
    member = np.zeros((w, n), bool)
    member[:, :N_HAP] = True
    smask = np.ones((w, s), bool)
    alleles = jnp.asarray([0, 1], jnp.int8)

    g_d = jax.device_put(jnp.asarray(g))
    m_d = jax.device_put(jnp.asarray(member))
    sm_d = jax.device_put(jnp.asarray(smask))
    jax.block_until_ready(ehh_area_batch(g_d, m_d, sm_d, s // 2, alleles))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = ehh_area_batch(g_d, m_d, sm_d, s // 2, alleles)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    return {"windows_per_sec": round(w * iters / dt, 1),
            "units_per_sec": round(w * iters / dt / UNIT_WINDOWS, 2)}


def bench_ehh_fused(iters=8, w=E2E_BATCH):
    """EHH inside the fused scan (`scan --ehh`): the full panel workload
    PLUS bidirectional decay areas/carriers for both alleles at a
    per-window focal column, one device program (the dynamic-focal
    formulation, stats/ehh.ehh_area_dynamic)."""
    import jax
    import jax.numpy as jnp

    from impop_tpu.stats.ehh import ehh_area_dynamic
    from impop_tpu.stats.panelstats import fused_window_stats

    rng = np.random.default_rng(17)
    geno, member, smask, panels, lengths = synth_batch(rng, w=w)
    focals = rng.integers(0, 20, size=w).astype(np.int32)  # always active

    pair_a = jnp.asarray(
        [list(PANEL_SIZES).index(a) for a, _ in PAIRS], jnp.int32)
    pair_b = jnp.asarray(
        [list(PANEL_SIZES).index(b) for _, b in PAIRS], jnp.int32)
    t = jnp.float32(THRESHOLD)

    def one_window(g, m, sm, p1, ln, fi):
        _s, _p, s_countf, res = fused_window_stats(
            g, m, sm, ln, p1, pair_a, pair_b, t,
            pairs_disjoint=True, return_matrices=False)
        xb = (g == 1).astype(jnp.int8)
        area, carr = ehh_area_dynamic(xb, m, sm, fi, alleles=(0, 1))
        return jnp.concatenate([
            res.pi, res.hudson.fst, res.hudson_grouped.fst,
            area, carr.astype(jnp.float32), s_countf.reshape(1)])

    step = jax.jit(jax.vmap(one_window))
    batch = tuple(jax.device_put(jnp.asarray(a))
                  for a in (geno, member, smask, panels, lengths, focals))
    jax.block_until_ready(step(*batch))
    t0 = time.perf_counter()
    for _i in range(iters):
        out = step(*batch)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    return {"windows_per_sec": round(w * iters / dt, 1),
            "units_per_sec": round(w * iters / dt / UNIT_WINDOWS, 2)}


def bench_e2e_scan():
    """Honest end-to-end: the scan CLI on a simulated chromosome-scale
    PAF+FASTA pangenome — native extraction + H2D + device + fetch + emit.
    Chromosome scale (IMPOP_BENCH_E2E_MB megabases, default 10 -> 2000
    windows) so steady state rests on dozens of batches.

    Two runs of the SAME CLI entry point over the same data:
    - cold: first run in the process; `units_per_sec_cold` excludes the
      scan's own 'compile' stage (the one-time jit compiles) but includes
      everything else (setup/index open, extraction, H2D, device, fetch,
      emit).
    - warm: second run with the module-level program cache populated — a
      resumed or long-lived engine.  `units_per_sec` is that run's FULL
      wall time with no exclusions at all.
    """
    from impop_tpu.cli import main
    from impop_tpu.extract.simulate import simulate

    tmp = tempfile.mkdtemp(prefix="impop_bench_")
    try:
        ref_len = int(float(os.environ.get("IMPOP_BENCH_E2E_MB", 10))
                      * 1_000_000)
        sim = simulate(tmp, ref_len=ref_len, n_haps=N_HAP - 1,
                       site_pool=ref_len // 60, seed=11,
                       span=(0, ref_len))
        bed = os.path.join(tmp, "w.bed")
        with open(bed, "w") as fh:
            for lo in range(0, ref_len, int(WIN_BP)):
                fh.write(f"chr1\t{lo}\t{lo + int(WIN_BP)}\n")
        # 5 panels in the reference's panel-list convention
        # (SAMPLE_hapN entries, h-fst.py:18-61) so the masks actually
        # match the extracted row names — full contig names canonicalize
        # to nothing and would silently yield empty panels
        ents = [f"{h.name.split('#')[0]}_hap{h.name.split('#')[1]}"
                for h in sim.haplotypes]
        panel_args = []
        start = 0
        for pname, size in PANEL_SIZES.items():
            take = ents[start:start + size]
            start += size
            pfile = os.path.join(tmp, f"agc.{pname}")
            with open(pfile, "w") as fh:
                fh.write("\n".join(take) + "\n")
            panel_args += ["--panel", pfile]

        # settle the ~5 GB of dirty pages simulate just wrote: background
        # writeback otherwise steals CPU/IO from the timed scans
        os.sync()

        def run(tag):
            timing = os.path.join(tmp, f"timing_{tag}.json")
            argv = ["scan", "-b", bed, "--paf", sim.paf_path,
                    "--fasta", sim.fasta_path, "-P", "CHM13#0#",
                    "-o", os.path.join(tmp, f"out_{tag}.tsv"),
                    "--batch", str(E2E_BATCH), "--timing-json", timing]
            main(argv + panel_args)
            with open(timing) as fh:
                return json.load(fh)

        t_cold = run("cold")
        # best of three warm passes: host-bound passes swing with the
        # shared host's CPU load
        warms = [run("warm1"), run("warm2"), run("warm3")]
        t_warm = min(warms, key=lambda t: t["elapsed_sec"])
        windows = t_warm["windows"]
        compile_cold = (t_cold["stages"].get("compile", {})
                        .get("total_sec", 0.0))
        cold_steady = max(t_cold["elapsed_sec"] - compile_cold, 1e-9)
        warm_full = max(t_warm["elapsed_sec"], 1e-9)
        return {
            "windows": windows,
            "units_per_sec": round(windows / UNIT_WINDOWS / warm_full, 3),
            "units_per_sec_cold": round(
                windows / UNIT_WINDOWS / cold_steady, 3),
            "compile_sec_cold": round(compile_cold, 3),
            "stages_sec": {k: round(v["total_sec"], 3)
                           for k, v in t_warm["stages"].items()},
        }
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def bench_python_reference(batch, n_windows=1):
    """Reference-semantics Python path (oracle) on the same data, one window."""
    import oracle

    geno, member, site_mask, panels, lengths = batch
    times = []
    panel_names = list(PANEL_SIZES)
    for wi in range(n_windows):
        g = geno[wi][member[wi]][:, site_mask[wi]]
        n, s = g.shape
        names = [f"h{i:04d}" for i in range(n)]
        # the numpy pairwise-hamming identity build IS timed (both sides
        # compute identity from alleles; vectorised numpy is far cheaper
        # than impg's real alignment product, so this is conservative)
        t0 = time.perf_counter()
        diff = (g[:, None, :] != g[None, :, :]).sum(-1)
        sim_mat = 1.0 - diff / WIN_BP
        sim_dict = {
            (names[i], names[j]): float(sim_mat[i, j])
            for i in range(n) for j in range(i + 1, n)
        }
        s_count = int(((g.max(0) != g.min(0))).sum())
        pis = {}
        for pi_idx, pname in enumerate(panel_names):
            mask = panels[wi, pi_idx][member[wi]]
            sub = [names[i] for i in range(n) if mask[i]]
            subd = {k: v for k, v in sim_dict.items()
                    if k[0] in set(sub) and k[1] in set(sub)}
            pval, _ = oracle.pica2_pi(subd, sub, THRESHOLD)
            pis[pname] = pval
            oracle.tajimas_d(len(sub), float(s_count), pval / WIN_BP)
        for a, b in PAIRS:
            ia, ib = panel_names.index(a), panel_names.index(b)
            mask_a = panels[wi, ia][member[wi]]
            mask_b = panels[wi, ib][member[wi]]
            pa = [names[i] for i in range(n) if mask_a[i]]
            pb = [names[i] for i in range(n) if mask_b[i]]
            oracle.hudson_fst_direct(sim_dict, pa, pb)
            oracle.hudson_fst_grouped(sim_dict, pa, pb, THRESHOLD)
            un = sorted(set(pa) | set(pb))
            und = {k: v for k, v in sim_dict.items()
                   if k[0] in set(un) and k[1] in set(un)}
            oracle.pica2_pi(und, un, THRESHOLD)
        times.append(time.perf_counter() - t0)
    return 1.0 / float(np.mean(times))


def main():
    import jax

    from impop_tpu.runtime.compile_cache import configure_compile_cache

    configure_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        # device rates come from the card only; never from a fallback
        raise SystemExit(f"bench.py measures a GPU; JAX found "
                         f"{dev.platform} ({dev.device_kind})")
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    smi = nvidia_smi_line()
    print(smi, flush=True)

    rng = np.random.default_rng(42)
    batch = synth_batch(rng)
    step = device_pipeline()
    windows_per_sec, _ = bench_device(step, batch)
    units_per_sec = windows_per_sec / UNIT_WINDOWS

    # 10 windows per pass, best of 3 passes: the BEST python rate gives
    # the SMALLEST — most conservative — multiplier; the spread is
    # reported alongside
    rates = [bench_python_reference(batch, n_windows=10) for _ in range(3)]
    py_best = max(rates)
    vs_baseline = windows_per_sec / py_best
    vs_detail = {
        "windows": 10, "best_of": 3,
        "spread_pct": round(
            100.0 * (max(rates) - min(rates)) / max(rates), 1),
        "py_windows_per_sec": [round(r, 2) for r in rates],
    }

    print(json.dumps({
        "metric": "200kb-windows/sec/chip for pi+Fst(direct+grouped)+TajD",
        "value": round(units_per_sec, 4),
        "unit": "200kb-units/sec/chip",
        "device": dict(device, power_limit=smi),
        "vs_baseline": round(vs_baseline, 2),
        "vs_baseline_detail": vs_detail,
        "e2e": bench_e2e_scan(),
        "long_window": bench_long_window(),
        "ehh": bench_ehh(),
        "ehh_fused": bench_ehh_fused(),
    }))


if __name__ == "__main__":
    main()
