"""A run that finds no CUDA device exits non-zero and prints no result:
it never falls back to the CPU (decided here, in the test)."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def test_run_without_a_card_prints_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "pair_8k",
         "--seed", "7", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr
