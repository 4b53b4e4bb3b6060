"""chip_smoke.py and bench.py refuse to report device numbers off the card."""
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402
import chip_smoke  # noqa: E402


def test_chip_smoke_fails_without_gpu(capsys):
    """On the CPU the smoke exits non-zero and prints no result line."""
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok": true' not in out
    for line in out.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def test_peak_lookup_raises_on_unknown_device_kind():
    assert bench.peak_for("NVIDIA H100 80GB HBM3")["int8"] == 1979.0
    with pytest.raises(KeyError, match="no peak rates"):
        bench.peak_for("cpu")
