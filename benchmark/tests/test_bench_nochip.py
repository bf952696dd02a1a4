"""Without a card a run fails and prints no result: no CPU fallback."""

import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("trace", ["0", "1"])
def test_no_card_no_result(trace):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "cornell-offline", "--seed", "3000000000", "--seconds", "1",
         "--trace", trace], cwd=ROOT, text=True, capture_output=True,
        timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CPU fallback" in p.stderr
