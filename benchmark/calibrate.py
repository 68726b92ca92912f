"""The readings that the limits of ``correct`` are set from, on the card, at
a cell's own sizes (not run by the benchmark's runs)::

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--seconds 3]

For each of ``--seeds`` a short run of the cell through the driver, as a
benchmark run makes it (its numbers are the program's readings, the lower
ones). For each of ``--control-seeds`` the control: the reference put in
the program's place and computed in the next precision below the
configuration's (``CONTROL``: TF32 for float32, fp8 for bfloat16), on the
inputs of as many requests as a run compares, against the reference in
float32 (the upper readings). One JSON line a seed on standard output.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import check
from benchmark import run as bench_run

CONTROL = {"float32": "tf32", "bfloat16": "fp8"}
# margins (over the mean logit magnitude) at which the share of the pixels
# that the reference decides is printed
MARGINS = (0.05, 0.1, 0.2, 0.4, 0.8)


def _readings(got, want, config) -> dict:
    """Beside the numbers: the widest logit gap (``label_margin`` is set
    from the program's), and the share of the pixels the reference decides
    at ``label_margin`` and at each of ``MARGINS``."""
    share = lambda m: float(sum(check.decided(w[2], m).sum() for w in want)
                            / sum(w[3].numel() for w in want))
    return {"seg_max_gap": check.seg_max_gap(got, want),
            "decided_share": share(config["label_margin"]),
            "decided_at": {str(m): share(m) for m in MARGINS}}


def control_numbers(driver, config, traffic, seed: int, device) -> dict:
    """The control's numbers: the reference in ``CONTROL``'s precision in
    the program's place, against the reference in float32 fed the
    control's condition outputs, as a run holds the program."""
    seeds, weights, pool, order = driver.make_inputs(config, traffic, seed,
                                                     device)
    idx = list(range(traffic["sample"]))
    args = (config, pool, order, idx, weights, seeds["pipeline"] + 1, device)
    got = driver.reference_outputs(*args, mode=CONTROL[config["precision"]])
    want = driver.reference_outputs(*args, given=[(g[1], g[3]) for g in got])
    return {**check.numbers(got, want, config["label_margin"]),
            **_readings(got, want, config)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    with open(bench_run.ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    _, config, traffic, driver = bench_run.cell_setup(bench, args.workload)
    for seed in seeds:
        rec, _ = bench_run.execute(bench, args.workload, seed, args.seconds,
                                   False, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": "program", **rec["check"]["numbers"],
                          **_readings(*rec["check"]["outputs"], config)}),
              flush=True)
    device = torch.device("cuda")
    for seed in controls:
        nums = control_numbers(driver, config, traffic, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": "control", "mode": CONTROL[config["precision"]],
                          **nums}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
