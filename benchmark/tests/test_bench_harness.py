"""The harness finds cells, configurations, traffic, drivers and metrics by
name, and refuses to run without a card."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from benchmark import run as bench_run
from benchmark.drivers import tryon_closed_loop as driver
from benchmark.tests.tiny import ROOT, tiny_root


def test_new_files_are_found_without_code(tmp_path):
    root, bench = tiny_root(tmp_path, "float32", batch=1)
    metrics = root / "benchmark" / "metrics"
    (metrics / "requests_done.py").write_text(
        "def read(rec):\n    return float(len(rec['latencies_ms']))\n")
    bench["end_to_end"].append({"name": "requests_done", "unit": "requests",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock", "workloads": ["tiny"]})
    bench["per_layer"].append({"name": "probe_count", "unit": "1",
                               "better": "higher", "source": "program_counter",
                               "layer": "device", "moves": "requests_done",
                               "workloads": ["tiny"]})
    (metrics / "probe_count.py").write_text(
        "def probe(ctx, rec):\n    return 42\n\n"
        "def read(rec):\n    return float(rec['probes']['probe_count'])\n")
    cell, config, traffic, driver = bench_run.cell_setup(bench, "tiny", root)
    assert config["name"] == "tiny" and traffic["batch"] == 1
    assert driver.__file__.startswith(str(root))
    rec, out = bench_run.execute(bench, "tiny", 11, 1.0, False, "cpu",
                                 root=root, log=lambda m: None)
    assert out["metrics"]["requests_done"]["value"] == out["attempted"] > 0
    assert set(out["metrics"]) >= {"setup_s", "img_per_s", "request_ms_p95"}
    assert list(out)[-1] == "check" and out["correct"]
    rec, out = bench_run.execute(bench, "tiny", 12, 1.0, True, "cpu",
                                 root=root, log=lambda m: None)
    assert out["metrics"]["probe_count"]["value"] == 42.0
    assert out["metrics"]["host_ms"]["value"] > 0
    # the device trace is the card's: a CPU run reports none of its metrics
    assert not {"upload_ms", "forward_ms", "device_idle_pct"} & set(out["metrics"])


def test_the_cells_metrics():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell in bench["workloads"]:
        e2e = bench_run.cell_metrics(bench, cell, False)
        per = bench_run.cell_metrics(bench, cell, True)
        assert {"setup_s", "img_per_s", "request_ms_p95", "peak_mem_gib"} == set(e2e)
        assert {"upload_ms", "host_ms", "forward_ms", "device_idle_pct",
                "mfu_pct"} <= set(per)
        assert ("unit_roofline" in per) == ("bf16" in cell["name"])


def test_run_without_a_card_refuses():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "tryon-bf16-b1",
         "--seed", str(2 ** 33), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA device" in proc.stderr


def test_forbidden_modules_are_seen(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert bench_run.forbidden_modules() == ["jax"]
    monkeypatch.delitem(sys.modules, "jax.numpy")
    monkeypatch.setitem(sys.modules, "hrviton_tpu_torch_x", object())
    assert "hrviton_tpu" not in bench_run.forbidden_modules()


@pytest.mark.parametrize("span, n, in_flight", [(8, 3, 2), (3, 3, 2), (40, 8, 1),
                                                (10, 4, 4)])
def test_sample_covers_every_slot(span, n, in_flight):
    for seed in range(50):
        got = driver.draw_sample(np.random.default_rng(seed), span, n, in_flight)
        assert len(set(got)) == n and got == sorted(got)
        assert all(0 <= i < span for i in got)
        assert {i % in_flight for i in got} == set(range(in_flight))


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_reduce_trace():
    # two requests: host ranges (us), the runtime calls inside them, and
    # the device work each launched (a graph's kernels share its launch's id)
    ev = []
    for r, t in enumerate((0, 1000)):
        c = 10 * r
        ev += [_ev("user_annotation", "to_device", t, 100),
               _ev("cuda_runtime", "cudaMemcpyAsync", t + 10, 80, c + 1),
               _ev("gpu_memcpy", "Memcpy HtoD", t + 20, 60, c + 1),
               _ev("user_annotation", "prepare_batch", t + 100, 50),
               _ev("cuda_runtime", "cudaGraphLaunch", t + 110, 10, c + 2),
               _ev("kernel", "expand", t + 120, 30, c + 2),
               _ev("user_annotation", "TryOnPipeline.__call__", t + 150, 300),
               _ev("cuda_runtime", "cudaGraphLaunch", t + 400, 20, c + 3),
               _ev("kernel", "conv", t + 430, 200, c + 3),
               _ev("kernel", "spade_unit_gb", t + 600, 100, c + 3),
               _ev("cuda_runtime", "cudaMemcpyAsync", t + 460, 5, c + 4),
               _ev("gpu_memcpy", "Memcpy DtoH", t + 710, 40, c + 4)]
    out = driver.reduce_trace(ev)
    assert out["requests"] == 2 and out["forward_kernels"] == [2, 2]
    # the forward's conv and unit overlap from 600 to 630
    assert out["layer_ms"] == {"upload": 0.09, "forward": 0.27}
    assert out["busy_s"] == 2 * (60 + 30 + 270 + 40) * 1e-6
    assert out["unit_kernel_records"] == 2 and out["kernel_records"] == 6
    # the longest gaps: the host's work before the graph's launch (150 to
    # 430), then from the first request's last copy (750) to the second's
    # upload (1020), inside no named range
    assert out["idle_gaps"][:3] == [["TryOnPipeline.__call__", 280e-6]] * 2 + [
        ["host idle", 270e-6]]
