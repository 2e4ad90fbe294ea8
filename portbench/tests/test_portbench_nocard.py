"""Without the card a cell asks for, the runner fails and prints no
result: it never falls back to the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("trace", ["0", "1"])
def test_no_card_no_result(trace):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "gpt2_serve_chat64", "--seed", str(2**31 + 5), "--seconds", "1",
         "--trace", trace], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "cuda" in proc.stderr.lower()


def test_an_unknown_cell_is_refused():
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "no_such_cell",
         "--seed", "1", "--seconds", "1"], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 2 and proc.stdout == ""


@pytest.mark.gpu
def test_a_cell_runs_on_the_card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "gpt2_train_b12s1024", "--seed", "17", "--seconds", "2",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=1200)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert '"correct": true' in proc.stdout.splitlines()[-1]
