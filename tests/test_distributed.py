"""Multi-host proof: a REAL 2-process `scan --distributed` on CPU.

Two subprocesses connect through jax.distributed (coordinator on a local
port), each owns its contiguous half of the window list
(parallel/distributed.host_window_range), writes `.partK` outputs, and
`merge-parts` reassembles them — asserted equal to the single-process scan.
This is the one parallelism claim that cannot be tested in-process
(SURVEY.md §2.3 collectives row, §5 distributed backend).
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from impop_tpu.cli import main
from impop_tpu.extract.simulate import simulate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def dataset(tmp_path):
    sim = simulate(str(tmp_path), ref_len=4000, n_haps=8, n_snps=12,
                   seed=29, span=(0, 4000))
    bed = tmp_path / "w.bed"
    bed.write_text("".join(f"chr1\t{i * 1000}\t{(i + 1) * 1000}\n"
                           for i in range(4)))
    tiles = tmp_path / "tiles"
    main(["extract", "-b", str(bed), "--paf", sim.paf_path,
          "--fasta", sim.fasta_path, "--out-dir", str(tiles),
          "-P", "CHM13#0#", "--python"])
    return sim, bed, tiles


def test_host_window_range_partition():
    from impop_tpu.parallel.distributed import host_window_range

    for n in (1, 4, 7, 100):
        for k in (1, 2, 3, 8):
            covered = []
            for p in range(k):
                lo, hi = host_window_range(n, p, k)
                covered.extend(range(lo, hi))
            assert covered == list(range(n)), (n, k)


def test_two_process_scan_and_merge(dataset, tmp_path):
    sim, bed, tiles = dataset
    single = tmp_path / "single.tsv"
    main(["scan", "-b", str(bed), "--geno-dir", str(tiles), "-P", "CHM13#0#",
          "-o", str(single), "--afs", str(tmp_path / "single.afs")])

    port = _free_port()
    out = tmp_path / "dist.tsv"
    procs = []
    for pid in range(2):
        env = dict(
            os.environ,
            JAX_PLATFORMS="cpu",
            JAX_COORDINATOR=f"127.0.0.1:{port}",
            JAX_NUM_PROCESSES="2",
            JAX_PROCESS_ID=str(pid),
        )
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "impop_tpu.cli", "scan",
             "-b", str(bed), "--geno-dir", str(tiles), "-P", "CHM13#0#",
             "-o", str(out), "--afs", str(tmp_path / "dist.afs"),
             "--distributed"],
            cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    for p in procs:
        try:
            _, errs = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed scan timed out")
        assert p.returncode == 0, errs

    assert os.path.exists(str(out) + ".part0")
    assert os.path.exists(str(out) + ".part1")
    main(["merge-parts", str(out)])
    assert out.read_text() == single.read_text()

    # genome-wide AFS parts merge by summation
    main(["merge-parts", str(tmp_path / "dist.afs"), "--sum"])
    assert ((tmp_path / "dist.afs").read_text()
            == (tmp_path / "single.afs").read_text())
