"""The command as the benchmark's users run it: without a card it exits
with another code than 0 and prints no result; on a card (the ``cuda``
marker) a short traced run of the edge cell is correct and reads the
device."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


def command(workload, seconds, trace):
    return [sys.executable, "perfbench/run.py", "--workload", workload,
            "--seed", str(2 ** 31 + 4099), "--seconds", str(seconds),
            "--trace", str(trace)]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run(command("student.edge.b16", 1, 0), cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


@pytest.mark.cuda
def test_short_traced_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(command("student.edge.b16", 3, 1), cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
    assert "k1_roofline_pct.edge" in result["metrics"]
