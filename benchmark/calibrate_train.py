"""The readings that a training cell's limits of ``correct`` are set from, on
the card, at the cell's own sizes (not run by the benchmark's runs)::

    python3 -m benchmark.calibrate_train --workload train-stage2-b2 \\
        --seeds 1,2,3 [--steps 3,8,13,18]

For each seed the driver's loop runs the CLI's steps as a run does and keeps
``--steps`` (the window's first half of a 25 s run: steps 2 to 19), then,
with the program freed, each kept step gives two readings at the same
state: the program's numbers (the lower ones), and the control's, the
reference computed in the next precision below the configuration's
(``CONTROL``: fp8 e4m3 for bfloat16, TF32 for float32) put in the program's
place for that step, from the program's state before it, fed the program's
conditioning, so that both readings test the trained part (the upper
ones). Each reading carries ``check_train``'s details too. Both are held by ``check_train`` against the
reference in float32. One JSON line a step and side on standard output.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from benchmark import check_train
from benchmark import run as bench_run
from benchmark.reference import hrviton as ref_infer
from benchmark.reference import hrviton_train as ref

CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def _net(params, opt: ref.Opt):
    return {"params": params, "exp_avg": opt.exp_avg,
            "exp_avg_sq": opt.exp_avg_sq, "count": opt.count}


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


def _control_step(frozen, before, raw, fields_g, fields_d, cond, config,
                  device, mode: str):
    """The reference in ``mode`` in the program's place: one step from the
    state ``before`` ({'generator', 'discriminator'}: ``_net``'s layout),
    fed the conditioning ``cond`` (``check_train.conditioning_of``'s
    triples), in the layout of a sampled step."""
    gb, db = before["generator"], before["discriminator"]
    g = ref.g_step(frozen, gb["params"], check_train._opt(gb), db["params"],
                   raw, fields_g, config, device, mode, cond=cond)
    d = ref.d_step(frozen, g["params"], db["params"], check_train._opt(db), raw,
                   fields_d, config, device, mode, cond=g.pop("cond"))
    losses = {f"loss/gen/{k}": g["losses"][k] for k in ("GAN", "GAN_Feat", "VGG")}
    losses.update({f"loss/dis/{k}": d["losses"][k] for k in ("adv_fake", "adv_real")})
    return {"raw": raw, "losses": losses, "before": before,
            "after": {"generator": _net(g["params"], g["opt"]),
                      "discriminator": _net(d["params"], d["opt"])},
            "grads": {"generator": g["grads"], "discriminator": d["grads"]},
            "fields_g": fields_g, "fields_d": fields_d,
            "cond": {"x": _nhwc(torch.cat([c[0] for c in cond])),
                     "labels": torch.cat([c[2] for c in cond])},
            "fake": _nhwc(g["fake"]), "d_logits": [_nhwc(m) for m in d["logits"]]}


def control_taken(driver, config, traffic, seed: int, device, mode: str):
    """(the reference in ``mode`` in the program's place for a first step
    from the seed's weights, fed the float32 reference's conditioning; the
    frozen networks' weights): the layout ``check_train`` reads."""
    seeds, weights, pool, order = driver.make_inputs(config, traffic, seed,
                                                     device)
    raw = pool[order[0]]
    p, n = config["pipeline"], traffic["batch"]
    gen = torch.Generator(device=device).manual_seed(seeds["pipeline"] + 1)
    shapes = ref_infer.noise_shapes(config["generator"], n, p["fine_height"],
                                    p["fine_width"])
    draw = lambda: [torch.randn(s, generator=gen, device=device) for s in shapes]
    fields_g, fields_d = draw(), draw()

    def start(model):
        zeros = {k: torch.zeros_like(v) for k, v in weights[model].items()
                 if not k.endswith((".u", ".v"))}
        return _net(weights[model],
                    ref.Opt(zeros, {k: v.clone() for k, v in zeros.items()}, 0))
    frozen = {m: weights[m] for m in ("tocg", "vgg")}
    cond = [ref.conditioning(ref.Precision(), frozen["tocg"], config,
                             ref.expand(part, device)) for part in ref.samples(raw)]
    before = {"generator": start("generator"),
              "discriminator": start("discriminator")}
    taken = _control_step(frozen, before, raw, fields_g, fields_d, cond, config,
                          device, mode)
    return {"index": 0, **taken}, frozen


def control_of(taken, config, frozen, device, mode: str):
    """The control of a sampled step of the program: the reference in
    ``mode`` in the program's place, from the program's state before the
    step, its batch, noise and conditioning (so that it tests the trained
    part, and the conditioning is the program's in both readings)."""
    t = check_train.to_device({k: v for k, v in taken.items() if k != "raw"},
                              device)
    frozen = check_train.to_device(frozen, device)
    cond = check_train.conditioning_of(t["cond"], config)
    return {"index": taken["index"],
            **_control_step(frozen, t["before"], taken["raw"], t["fields_g"],
                            t["fields_d"], cond, config, device, mode)}


def paired_readings(driver, config, traffic, seed: int, steps, device):
    """[(step, the program's numbers, the control's numbers)] of the
    program's steps ``steps`` of a run from ``seed`` (module docstring)."""
    seeds, weights, pool, order = driver.make_inputs(config, traffic, seed,
                                                     device)
    built = driver.build(config, traffic, seeds["pipeline"], device.type)
    driver.load_weights(built, weights)
    frozen = {m: {k: v.cpu() for k, v in weights[m].items()}
              for m in ("tocg", "vgg")}
    del weights
    loop = driver.Loop(built, pool, order, device)
    loop.sample = set(steps)
    for i in range(max(steps) + 1):
        loop.step(i)
    taken = loop.taken
    del loop, built
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    mode = CONTROL[config["precision"]]
    out = []
    for t in taken:
        prog = check_train.numbers_of(t, config, frozen, device, detail=True)
        ctl = check_train.numbers_of(control_of(t, config, frozen, device, mode),
                                     config, frozen, device, detail=True)
        out.append((t["index"], prog, ctl))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def control_numbers(driver, config, traffic, seed: int, device, mode=None):
    mode = mode or CONTROL[config["precision"]]
    taken, frozen = control_taken(driver, config, traffic, seed, device, mode)
    return check_train.numbers([taken], config, frozen, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--steps", default="3,8,13,18")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate_train: needs a CUDA device", file=sys.stderr)
        return 2
    with open(bench_run.ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    _, config, traffic, driver = bench_run.cell_setup(bench, args.workload)
    steps = [int(s) for s in args.steps.split(",")]
    for seed in [int(s) for s in args.seeds.split(",")]:
        for step, prog, ctl in paired_readings(driver, config, traffic, seed,
                                               steps, torch.device("cuda")):
            for side, nums in (("program", prog), ("control", ctl)):
                print(json.dumps({"workload": args.workload, "seed": seed,
                                  "step": step, "side": side, **nums}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
