"""One run of one benchmark cell of the port (``hrviton_tpu_torch``) on the
card, from the root of a checkout::

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one cell is found by name: the cell in
``BENCHMARK.json``'s ``workloads``; its configuration in the file its entry
in ``configs`` names; its traffic in ``benchmark/traffic/<traffic>.json``,
whose ``driver`` names ``benchmark/drivers/<driver>.py``; each metric in
``benchmark/metrics/<metric>.py``. A driver's ``run(ctx)`` builds the
program, sets up, measures for ``--seconds`` and checks the sampled outputs
against the plain reference; it returns a record. Each metric module's
``read(record)`` gives its number, or None where the run had nothing for
it (the metric is then left out); a per-layer metric may also have
``probe(ctx, record)``, run after the window of a traced run, whose result
the driver keeps under ``record["probes"][<metric>]``.

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics. The last line of standard output is the result, a JSON
object; the last lines of standard error are the numbers compared, each
beside its limit. The run refuses (exit code 2, no result) without as many
CUDA devices as the cell asks for, and fails (exit code 3, no result) if
JAX, flax, optax or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()    # the set-up is timed from here

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "hrviton_tpu")


def load_module(path: Path):
    """A module of the benchmark's own found by file name."""
    spec = importlib.util.spec_from_file_location(
        f"benchmark._found.{path.parent.name}.{path.stem}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_setup(bench: dict, name: str, root: Path = ROOT):
    """(cell, configuration, traffic, driver module) of workload ``name``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r}; the cells: {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(root / "benchmark" / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    driver = load_module(root / "benchmark" / "drivers" / f"{traffic['driver']}.py")
    return cell, config, traffic, driver


def cell_metrics(bench: dict, cell: dict, trace: bool, root: Path = ROOT):
    """{metric name: (entry, module)} the cell reports in this mode: its
    end-to-end metrics, or the per-layer metrics that list it."""
    if trace:
        chosen = [m for m in bench["per_layer"] if cell["name"] in m["workloads"]]
    else:
        chosen = [m for m in bench["end_to_end"]
                  if "workloads" not in m or cell["name"] in m["workloads"]]
    return {m["name"]: (m, load_module(root / "benchmark" / "metrics" /
                                       f"{m['name']}.py")) for m in chosen}


def forbidden_modules():
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def result_line(rec: dict, metrics: dict) -> dict:
    out = {"correct": bool(rec["check"]["correct"]),
           "attempted": rec["attempted"], "failed": rec["failed"],
           "metrics": {}, "device": rec["device"]}
    for name, (entry, mod) in metrics.items():
        value = mod.read(rec)
        if value is not None:
            out["metrics"][name] = {"value": value, "unit": entry["unit"]}
    if "breakdown" in rec:
        out["breakdown"] = rec["breakdown"]
    nums, limits = rec["check"]["numbers"], rec["check"]["limits"]
    out["check"] = {k: {"value": nums[k], "limit": limits[k]} for k in nums}
    return out


def execute(bench: dict, name: str, seed: int, seconds: float, trace: bool,
            device: str, root: Path = ROOT, t0: float = T0, log=None):
    """The run of a cell after the look for a card: (record, result)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell, config, traffic, driver = cell_setup(bench, name, root)
    metrics = cell_metrics(bench, cell, trace, root)
    probes = {n: mod.probe for n, (_, mod) in metrics.items()
              if hasattr(mod, "probe")}
    ctx = SimpleNamespace(config=config, traffic=traffic, seed=seed,
                          seconds=seconds, trace=trace, device=device, t0=t0,
                          probes=probes, log=log, cell=cell)
    rec = driver.run(ctx)
    return rec, result_line(rec, metrics)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload, 1)

    os.environ.setdefault("USE_FLAX", "0")
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    rec, out = execute(bench, args.workload, args.seed, args.seconds,
                       bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        print(f"benchmark: loaded in the measuring process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for k, v in out["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
