"""A short run of each cell on the card (skips without one)."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ("config5.chrom128",))
def test_short_run_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark measures only on a card")
    proc = subprocess.run(
        [sys.executable, os.path.join("benchmark", "run.py"), "--workload",
         cell, "--seed", "4242", "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, proc.stderr[-3000:]
    assert res["device"]["platform"] == "gpu"
    assert res["metrics"]["search_mbps"]["value"] > 0
