"""Stage times of the headline device step, and the identity-route A/B.

Each stage is timed as a cumulative prefix of the per-window program, jitted
and vmapped over the bench's HPRC-shaped batch (bench.synth_batch: 466
haplotypes in a 512-row tile, 128 site columns, 5 panels, 10 pairs):

  identity      identity_from_alleles + segregating_sites
  grouping      + greedy_group_panels over the panel and pair-union masks
  panel_reduce  + the rest of fused_window_stats (weights, the stacked
                  HIGHEST reduction, Hudson rows, seed_risk)
  ehh           + ehh_area_dynamic at a per-window focal column

A stage's time is its prefix's time minus the previous prefix's.  The
first three run at the headline batch; ehh runs at the scan's batch
(``--ehh-batch``, as `scan --ehh` does), with the panel_reduce prefix
timed again there as its base: at 2240 windows its per-block [N, N]
intermediates do not fit in 80 GB.  Then the two identity formulations
of stats/allele.identity_route are timed at [512, 128] x 320 and
[512, 8192] x 64 windows.

    python tools/bench_stages.py [--batch 2240] [--ehh-batch 320] [--iters 8]

Needs a GPU.  Prints the card's name and power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)


def _time(fn, args, iters):
    """(compile s, mean s per call) of a jitted fn on device inputs."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return compile_s, (time.perf_counter() - t0) / iters


def stage_times(batch_size: int, ehh_batch: int, iters: int) -> dict:
    import jax
    import jax.numpy as jnp

    import bench as B
    from impop_tpu.stats.allele import (identity_from_alleles,
                                        segregating_sites)
    from impop_tpu.stats.ehh import ehh_area_dynamic
    from impop_tpu.stats.grouping import greedy_group_panels
    from impop_tpu.stats.panelstats import (fused_window_stats,
                                            panel_mask_stack)

    rng = np.random.default_rng(42)
    geno, member, smask, panels, lengths = B.synth_batch(rng, w=batch_size)
    focals = rng.integers(0, 20, size=batch_size).astype(np.int32)
    batch = (geno, member, smask, panels, lengths, focals)
    names = list(B.PANEL_SIZES)
    pair_a = jnp.asarray([names.index(a) for a, _ in B.PAIRS], jnp.int32)
    pair_b = jnp.asarray([names.index(b) for _, b in B.PAIRS], jnp.int32)
    t = jnp.float32(B.THRESHOLD)

    def identity(g, m, sm, p1, ln, fi):
        sim, present = identity_from_alleles(g, m, sm, ln)
        s = segregating_sites(g, m, sm)
        return jnp.sum(jnp.where(present, sim, 0.0)) + s

    def grouping(g, m, sm, p1, ln, fi):
        sim, present = identity_from_alleles(g, m, sm, ln)
        s = segregating_sites(g, m, sm)
        masks, _, _ = panel_mask_stack(p1, m, pair_a, pair_b, True)
        gid = greedy_group_panels(sim, present, m, masks, t)
        return jnp.sum(gid) + s

    def panel_reduce(g, m, sm, p1, ln, fi):
        _s, _p, s, res = fused_window_stats(
            g, m, sm, ln, p1, pair_a, pair_b, t, pairs_disjoint=True,
            return_matrices=False)
        return jnp.concatenate([res.pi, res.hudson.fst,
                                res.hudson_grouped.fst, s.reshape(1)])

    def ehh(g, m, sm, p1, ln, fi):
        head = panel_reduce(g, m, sm, p1, ln, fi)
        area, carr = ehh_area_dynamic((g == 1).astype(jnp.int8), m, sm, fi,
                                      alleles=(0, 1))
        return jnp.concatenate([head, area, carr.astype(jnp.float32)])

    stages = {"identity": identity, "grouping": grouping,
              "panel_reduce": panel_reduce, "ehh": ehh}

    # (batch, prefixes timed in order, prefixes reported); the EHH group
    # times panel_reduce again only as its base
    groups = ((batch_size, ("identity", "grouping", "panel_reduce"),
               ("identity", "grouping", "panel_reduce")),
              (ehh_batch, ("panel_reduce", "ehh"), ("ehh",)))
    out = {}
    for w, names, report in groups:
        args = tuple(jax.device_put(a[:w]) for a in batch)
        prev = 0.0
        for name in names:
            fn = stages[name]
            compile_s, sec = _time(jax.jit(jax.vmap(fn)), args, iters)
            print(f"prefix {name} at {w} windows: {sec / w * 1e6:.3f} "
                  f"us/window", file=sys.stderr, flush=True)
            if name in report:
                out[name] = {
                    "batch": w,
                    "prefix_us_per_window": sec / w * 1e6,
                    "stage_us_per_window": (sec - prev) / w * 1e6,
                    "prefix_compile_sec": compile_s,
                }
            prev = sec
    return out


def identity_routes(iters: int) -> dict:
    import jax
    import jax.numpy as jnp

    import bench as B
    from impop_tpu.stats.allele import (pairwise_identity_f32,
                                        pairwise_identity_int8)

    peaks = B.peak_for(jax.devices()[0].device_kind)
    routes = {"f32": pairwise_identity_f32, "int8": pairwise_identity_int8}
    out = {}
    for n, s, w in ((512, 128, 320), (512, 8192, 64)):
        rng = np.random.default_rng(7)
        classes = rng.integers(0, 2, size=(16, s)).astype(np.int8)
        g = classes[rng.integers(0, 16, size=(w, n))]
        g = np.where(rng.random((w, n, s)) < 0.001, 1 - g, g).astype(np.int8)
        g[:, B.N_HAP:] = -1
        member = np.zeros((w, n), bool)
        member[:, :B.N_HAP] = True
        smask = np.ones((w, s), bool)
        args = tuple(jax.device_put(a) for a in (g, member, smask))
        cell = {}
        for name, fn in routes.items():
            def one(g1, m1, sm1, fn=fn):
                sim, present = fn(g1, m1, sm1, jnp.float32(5000.0))
                return jnp.sum(jnp.where(present, sim, 0.0))

            compile_s, sec = _time(jax.jit(jax.vmap(one)), args, iters)
            print(f"identity route {name} at [{n}, {s}] x {w}: "
                  f"{sec / w * 1e6:.3f} us/window", file=sys.stderr,
                  flush=True)
            tops = 4.0 * n * n * s * w / sec / 1e12
            cell[name] = {"us_per_window": sec / w * 1e6,
                          "tops": tops,
                          "peak_share_pct": 100.0 * tops / peaks[name],
                          "compile_sec": compile_s}
        out[f"[{n}, {s}] x {w}"] = cell
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=2240)
    ap.add_argument("--ehh-batch", type=int, default=320)
    ap.add_argument("--iters", type=int, default=8)
    args = ap.parse_args(argv)

    import jax

    import bench as B
    from impop_tpu.runtime.compile_cache import configure_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX found {dev.platform}")
    configure_compile_cache()
    smi = B.nvidia_smi_line()
    print(smi, flush=True)
    print(json.dumps({
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "power_limit": smi},
        "stages": stage_times(args.batch, args.ehh_batch, args.iters),
        "identity_routes": identity_routes(args.iters),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
