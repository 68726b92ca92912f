"""One short traced run of each cell on the card (``-m gpu``; skips without
one), each in a process of its own as the benchmark's runs are: a second
profile in one process can lose records."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import run as bench_run
from benchmark.tests.tiny import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", cell,
         "--seed", str(2 ** 31 + 99), "--seconds", "3", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"], out["check"]
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
    listed = bench_run.cell_metrics(
        BENCH, {w["name"]: w for w in BENCH["workloads"]}[cell], True)
    assert set(out["metrics"]) == set(listed)
    assert out["metrics"]["mfu_pct"]["value"] < 100
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")
