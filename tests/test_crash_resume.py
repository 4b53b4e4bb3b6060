"""Kill-mid-scan recovery: SIGKILL a running scan between journal flushes
and assert the resumed scan reproduces the clean run exactly (idempotent
recompute from the journal; torn tail lines ignored — SURVEY.md §5
checkpoint/resume, replacing the reference's restart-from-scratch)."""
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from impop_tpu.cli import main


def _write_inputs(tmp_path, n_windows=8):
    from impop_tpu.extract.simulate import simulate

    sim = simulate(str(tmp_path), ref_len=n_windows * 1000, n_haps=10,
                   seed=23, site_pool=60, span=(0, n_windows * 1000))
    bed = tmp_path / "w.bed"
    bed.write_text("".join(f"chr1\t{i*1000}\t{(i+1)*1000}\n"
                           for i in range(n_windows)))
    (tmp_path / "agc.P1").write_text("HG00900\nHG00901\nHG00902\n")
    (tmp_path / "agc.P2").write_text("HG00903\nHG00904\n")
    return sim, bed


def _argv(tmp_path, sim, bed, out, journal):
    return ["scan", "-b", str(bed), "--paf", sim.paf_path,
            "--fasta", sim.fasta_path, "-P", "CHM13#0#",
            "--panel", str(tmp_path / "agc.P1"),
            "--panel", str(tmp_path / "agc.P2"),
            "--batch", "2", "--journal", str(journal), "-o", str(out),
            # per-batch journal flushes so the SIGKILL lands between them
            # (the default drain group coalesces 4 batches per fetch)
            "--drain-group", "1"]


def test_sigkill_mid_scan_then_resume(tmp_path):
    sim, bed = _write_inputs(tmp_path)
    # clean reference run
    out_clean = tmp_path / "clean.tsv"
    main(_argv(tmp_path, sim, bed, out_clean, tmp_path / "clean.jsonl"))

    # crashed run: SIGKILL as soon as the journal holds a partial batch
    journal = tmp_path / "crash.jsonl"
    out_crash = tmp_path / "crash.tsv"
    code = ("import sys; sys.path.insert(0, %r); "
            "from impop_tpu.cli import main; main(%r)") % (
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        _argv(tmp_path, sim, bed, out_crash, journal),
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    deadline = time.time() + 120
    killed = False
    while time.time() < deadline:
        if journal.exists() and journal.stat().st_size > 0:
            lines = journal.read_text().splitlines()
            if len(lines) >= 8:
                break  # all windows journaled -> too late to kill mid-scan
            if len(lines) >= 2 and proc.poll() is None:
                os.kill(proc.pid, signal.SIGKILL)
                killed = True
                break
        if proc.poll() is not None:
            break
        time.sleep(0.01)
    proc.wait(timeout=60)
    if not killed:
        pytest.skip("scan finished before the kill window (machine too "
                    "fast for --batch 2?)")
    # simulate a torn tail write from the kill
    with open(journal, "a") as fh:
        fh.write('{"region": "CHM13#0#chr1:tor')

    n_before = len([l for l in journal.read_text().splitlines()
                    if l.strip()])
    out_resume = tmp_path / "resume.tsv"
    main(_argv(tmp_path, sim, bed, out_resume, journal))
    clean_rows = out_clean.read_text().splitlines()
    resume_rows = out_resume.read_text().splitlines()
    assert resume_rows == clean_rows
    # resume recomputed only the missing windows (journal grew, and the
    # replayed rows came from it, not from recompute)
    n_after = len([l for l in journal.read_text().splitlines()
                   if l.strip()])
    assert n_after >= 8 and n_before < n_after
