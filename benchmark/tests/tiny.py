"""A copy of the benchmark in a temporary directory with one more cell,
``tiny``: the f32 configuration at 256x128 (condition 64x64, SPADE ngf 8),
batch ``batch``, for runs on the CPU."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def tiny_root(tmp, precision="float32", batch=1, in_flight=1, limits=None):
    """(root of the copy, its BENCHMARK.json as a dict)."""
    root = Path(tmp)
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    name = {"float32": "hrviton-1024-f32", "bfloat16": "hrviton-1024-bf16"}[precision]
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg["name"] = "tiny"
    cfg["pipeline"].update(fine_height=256, fine_width=128, cond_height=64,
                           cond_width=64)
    cfg["generator"]["ngf"] = 8
    if limits is not None:
        cfg["limits"] = limits
    (root / "benchmark" / "configs" / "tiny.json").write_text(json.dumps(cfg))
    traffic = {"driver": "tryon_closed_loop", "batch": batch,
               "in_flight": in_flight, "pool": 3, "sample": 2,
               "profile_requests": 2}
    (root / "benchmark" / "traffic" / "tiny.json").write_text(json.dumps(traffic))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "tiny",
                             "file": "benchmark/configs/tiny.json",
                             "reduced": [], "why": "tiny"})
    bench["workloads"].append({"name": "tiny", "config": "tiny",
                               "traffic": "tiny", "chips": 1, "why": "tiny"})
    for m in bench["per_layer"]:
        m["workloads"].append("tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, bench


def tiny_config(precision="float32"):
    name = {"float32": "hrviton-1024-f32", "bfloat16": "hrviton-1024-bf16"}[precision]
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg["pipeline"].update(fine_height=256, fine_width=128, cond_height=64,
                           cond_width=64)
    cfg["generator"]["ngf"] = 8
    return cfg
