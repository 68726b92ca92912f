"""Closed loop of training steps through the stage-2 training CLI's step.

The program is built as the CLI builds it
(``hrviton_tpu_torch.cli.train_generator.build_training``, with the
configuration's flags; ``--bf16`` where it is bfloat16), the benchmark's
weights loaded into its generator, discriminator, tocg and VGG19, and each
step is the CLI's ``train_step`` on a compact batch of the pool: the copy to
the card, the expansion, the recorded step. One step is in flight, as the
CLI's loop runs them: a step ends when its losses are in host memory, and
its latency runs from the host's start of the copy to then.

The traffic file gives ``batch``, ``pool`` (distinct batches, cycled in an
order drawn from the seed), ``sample`` (steps of the window's first half,
drawn from the seed, compared with the reference) and ``profile_steps``
(steps under ``torch.profiler`` after the window of a traced run).

Set-up: the program built, the weights loaded, the pool made, two steps
(the first records the step's graph; the second replays it). The window
runs steps until ``seconds`` have passed and closes at the end of the step
that passes them (and not before the last sampled step). Around a sampled
step the driver copies to host memory what the check needs (the state
before and after, the gradients, the noise fields, and what the step's
graph wrote of its conditioning, G's output and D's logits:
``GeneratorTrainer.held``); the window's clock and that step's latency leave
those copies out, so ``window_s`` is the steps' own time. A traced run then profiles ``profile_steps`` more steps
(``tryon_closed_loop.reduce_trace``: the device's busy time, its top
operations and longest gaps) and runs the per-layer metrics' probes. Last,
with the program freed, the reference recomputes the sampled steps
(``benchmark/check_train.py``).
"""

from __future__ import annotations

import gc
import json
import os
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import check_train, inputs
from benchmark.drivers.tryon_closed_loop import (_draw_order, _power_limit,
                                                 draw_sample, reduce_trace)
from benchmark.reference import hrviton_train as ref

__all__ = ["run", "make_inputs", "build", "load_weights", "argv_of",
           "taps_per_step", "take_state", "Loop"]


def argv_of(config, traffic, seed: int, device: str) -> List[str]:
    """The stage-2 training CLI's flags for the configuration."""
    p, g, t = config["pipeline"], config["generator"], config["tocg"]
    d, tr = config["discriminator"], config["train"]
    argv = ["--name", "benchmark", "--device", device, "--seed", str(seed),
            "-b", str(traffic["batch"]),
            "--fine_height", str(p["fine_height"]), "--fine_width", str(p["fine_width"]),
            "--cond_height", str(p["cond_height"]), "--cond_width", str(p["cond_width"]),
            "--semantic_nc", str(p["semantic_nc"]),
            "--clothmask_composition", p["clothmask_composition"],
            "--ngf", str(g["ngf"]), "--gen_semantic_nc", str(g["gen_semantic_nc"]),
            "--num_upsampling_layers", g["num_upsampling_layers"],
            "--norm_G", g["norm_G"], "--warp_feature", t["warp_feature"],
            "--out_layer", t["out_layer"], "--ndf", str(d["ndf"]),
            "--n_layers_D", str(d["n_layers_D"]), "--num_D", str(d["num_D"]),
            "--norm_D", d["norm_D"], "--G_lr", repr(tr["G_lr"]),
            "--D_lr", repr(tr["D_lr"]), "--lambda_feat", repr(tr["lambda_feat"]),
            "--lambda_vgg", repr(tr["lambda_vgg"]),
            "--keep_step", str(tr["keep_step"]), "--decay_step", str(tr["decay_step"])]
    for on, flag in ((p["occlusion"], "--occlusion"),
                     (config["precision"] == "bfloat16", "--bf16"),
                     (g["fused_block"], "--fused_block"),
                     (not g["remat"], "--no_remat"),
                     (not tr["d_remat"], "--no_d_remat"),
                     (not tr["taps_wgrad"], "--no_taps_wgrad")):
        if on:
            argv.append(flag)
    return argv


def build(config, traffic, seed: int, device: str):
    """The CLI's training (``build_training``) for ``config``, its own random
    weights from ``seed`` (replaced by ``load_weights``). Raises where the
    CLI's trainer differs from the configuration."""
    from hrviton_tpu_torch.cli import train_generator as tgen
    from hrviton_tpu_torch.cli.common import expandable_segments, start_mesh
    opt = tgen.get_opt(argv_of(config, traffic, seed, device))
    mesh = start_mesh(opt)
    expandable_segments(mesh.device)
    built = tgen.build_training(opt, mesh)
    tr, g, t = config["train"], config["generator"], built.trainer.tcfg
    got = (built.trainer.gen_cfg.fused_block, built.trainer.gen_cfg.remat,
           t.taps_wgrad, t.d_remat, t.beta1, t.beta2, t.bf16, built.compact)
    want = (g["fused_block"], g["remat"], tr["taps_wgrad"], tr["d_remat"],
            tr["beta1"], tr["beta2"], config["precision"] == "bfloat16", True)
    if got != want:
        raise ValueError(f"the CLI's trainer {got} differs from the "
                         f"configuration's {want}")
    return built


def _modules(built):
    """The program's module of each model the benchmark gives weights."""
    return {"generator": built.state.g.module,
            "discriminator": built.state.d.module,
            "tocg": built.frozen["tocg"], "vgg": built.frozen["vgg"]}


def load_weights(built, weights) -> None:
    """Copy the benchmark's tensors into the program's modules, name by
    name; every tensor of each module must be given, at its shape."""
    for model, module in _modules(built).items():
        own = dict(module.named_parameters())
        own.update(module.named_buffers())
        given = weights[model]
        if set(own) != set(given):
            raise ValueError(f"{model}: tensors differ from the reference's: "
                             f"{sorted(set(own) ^ set(given))[:8]}")
        with torch.no_grad():
            for name, t in own.items():
                if tuple(t.shape) != tuple(given[name].shape):
                    raise ValueError(f"{model}.{name}: {tuple(t.shape)} against "
                                     f"{tuple(given[name].shape)}")
                t.copy_(given[name])


def taps_per_step(gen) -> int:
    """The tap-product weight gradients one G backward takes, counted from
    the generator: every 3x3 conv of its blocks, of the input pyramid's
    convs that a block reads (one a block), and ``conv_img`` (the fused
    unit, the kernels' gates and the space-to-depth tail off, as the CLI's
    trainer has them)."""
    convs = lambda m: sum(1 for c in m.modules()
                          if getattr(c, "weight", None) is not None
                          and tuple(c.weight.shape[-2:]) == (3, 3)
                          and c.weight.dim() == 4)
    blocks = gen.block_names
    return (sum(convs(getattr(gen, b)) for b in blocks) + len(blocks)
            + convs(gen.conv_img))


def _net(net_state) -> Dict:
    """A network's parameters (with its buffers), Adam moments and count,
    copied to host memory."""
    module, opt = net_state.module, net_state.opt
    names = {id(p): k for k, p in module.named_parameters()}
    host = lambda t: t.detach().to("cpu", copy=True)
    params = {k: host(t) for k, t in module.named_parameters()}
    params.update({k: host(t) for k, t in module.named_buffers()})
    state = {names[id(p)]: opt.opt.state[p] for p in opt.params}
    return {"params": params,
            "exp_avg": {k: host(s["exp_avg"]) for k, s in state.items()},
            "exp_avg_sq": {k: host(s["exp_avg_sq"]) for k, s in state.items()},
            "count": opt.count}


def take_state(state) -> Dict:
    return {"generator": _net(state.g), "discriminator": _net(state.d)}


def _grads(state) -> Dict:
    return {net: {k: p.grad.detach().to("cpu", copy=True)
                  for k, p in ns.module.named_parameters()}
            for net, ns in (("generator", state.g), ("discriminator", state.d))}


class Loop:
    """Runs the CLI's steps and keeps what the check needs of the sampled
    ones (module docstring)."""

    def __init__(self, built, pool, order, device):
        from hrviton_tpu_torch.cli import train_generator as tgen
        from hrviton_tpu_torch.ops.conv3x3 import wgrad_taps
        self.tgen, self.taps = tgen, wgrad_taps
        self.built, self.pool, self.order = built, pool, order
        self.state = built.state
        self.cuda = device.type == "cuda"
        self.sample = set()
        self.taken: List[Dict] = []
        self.excluded = 0.0     # seconds of the window spent on copies

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def step(self, i: int):
        """Step ``i`` (of the pool's order): (latency s, losses)."""
        b = self.built
        raw = self.pool[self.order[i % len(self.order)]]
        keep = i in self.sample
        if keep:
            t = time.perf_counter()
            self._sync()
            before = take_state(self.state)
            fields = []
            draw = b.trainer.noise_fields

            def kept(gen, noise, n):
                fields.append(draw(gen, noise, n))
                return fields[-1]
            b.trainer.noise_fields = kept
            self.excluded += time.perf_counter() - t
        try:
            t_sub = time.perf_counter()
            out = self.tgen.train_step(b.trainer, self.state, raw, b.noise,
                                       b.frozen, b.put)
            keys = list(out.metrics)
            vals = torch.stack([out.metrics[k].float() for k in keys]).cpu()
            lat = time.perf_counter() - t_sub
        finally:
            if keep:
                del b.trainer.noise_fields
        self.state = out.state
        losses = dict(zip(keys, vals.tolist()))
        if keep:
            t = time.perf_counter()
            self._sync()
            host = lambda v: v.detach().to("cpu", torch.float32, copy=True)
            held = b.trainer.held
            self.taken.append({
                "index": i, "raw": raw, "losses": losses, "before": before,
                "after": take_state(self.state), "grads": _grads(self.state),
                "fields_g": [host(f) for f in fields[0]],
                "fields_d": [host(f) for f in fields[1]],
                "cond": {"x": host(held["gen_in"]),
                         "labels": held["labels"].to("cpu", copy=True)},
                "fake": host(held["fake"]),
                "d_logits": [host(m) for m in held["d_logits"]]})
            self.excluded += time.perf_counter() - t
        return lat, losses


def make_inputs(config, traffic, seed: int, device):
    """(the run's sub-seeds, the weights, the pool, the order the pool is
    served in), all from ``seed``. The weights are float32: the program's
    parameters and Adam state are, whatever it computes in."""
    if traffic["batch"] != config["batch_size"]:
        raise ValueError(f"traffic batch {traffic['batch']} against the "
                         f"configuration's {config['batch_size']}")
    seeds = inputs.sub_seeds(seed)
    weights = inputs.make_weights(ref.param_specs(config), config["init"],
                                  seeds["weights"], device, torch.float32)
    p = config["pipeline"]
    pool = inputs.make_pool(traffic["pool"], traffic["batch"], p["fine_height"],
                            p["fine_width"], seeds["inputs"], device)
    return seeds, weights, pool, _draw_order(len(pool), seeds["inputs"])


def _profile(loop: Loop, first: int, count: int) -> Dict:
    """``count`` steps under torch.profiler, reduced by ``reduce_trace``,
    with the host seconds they took."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function("benchmark loop"):
            for i in range(first, first + count):
                loop.step(i)
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            out = reduce_trace(json.load(f)["traceEvents"])
    finally:
        os.remove(path)
    out["window_s"] = window_s
    return out


def run(ctx) -> Dict:
    """One run of the cell (``ctx``: config, traffic, seed, seconds, trace,
    device, t0, probes, log). Returns the record the metrics read."""
    # a program without the CLI's split step fails here, before any work
    from hrviton_tpu_torch.cli.train_generator import build_training  # noqa: F401
    config, traffic = ctx.config, ctx.traffic
    device = torch.device(ctx.device)
    seeds = inputs.sub_seeds(ctx.seed)
    built = build(config, traffic, seeds["pipeline"], ctx.device)
    _, weights, pool, order = make_inputs(config, traffic, ctx.seed, device)
    load_weights(built, weights)
    frozen = {m: {k: v.cpu() for k, v in weights[m].items()}
              for m in ("tocg", "vgg")}
    del weights
    if device.type == "cuda":
        torch.cuda.empty_cache()
    loop = Loop(built, pool, order, device)
    per_step = taps_per_step(built.state.g.module)

    # set-up: the first step records the step's graph, the second replays it
    loop.step(0)
    t_step, _ = loop.step(1)
    rng = np.random.default_rng(seeds["sample"])
    span = max(traffic["sample"], int(0.5 * ctx.seconds / max(t_step, 1e-3)))
    loop.sample = {2 + i for i in draw_sample(rng, span, traffic["sample"], 1)}
    taps0 = loop.taps.launches
    loop._sync()

    t_start = time.perf_counter()
    setup_s = t_start - ctx.t0
    lat, i = [], 2
    while True:
        lat.append(loop.step(i)[0])
        i += 1
        if (time.perf_counter() - t_start - loop.excluded >= ctx.seconds
                and i > max(loop.sample)):
            break
    window_wall_s = time.perf_counter() - t_start
    window_s = window_wall_s - loop.excluded
    steps = len(lat)
    taps = (loop.taps.launches - taps0) / steps
    rec = {"setup_s": setup_s, "window_s": window_s,
           "window_wall_s": window_wall_s, "config": config,
           "attempted": steps, "failed": 0,
           "images_in_window": traffic["batch"] * steps,
           "latencies_ms": [x * 1e3 for x in lat],
           "steps": steps, "wgrad_taps_per_step": taps,
           "wgrad_taps_model": per_step}
    ctx.log(f"window: {steps} steps in {window_s:.3f} s "
            f"({loop.excluded:.3f} s of copies left out); tap-product weight "
            f"gradients a step {taps} (the model's count {per_step})")
    if device.type == "cuda":
        rec["peak_reserved"] = torch.cuda.max_memory_reserved(device)
        rec["device"] = {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(device),
                         "count": 1, "memory_peak_bytes": rec["peak_reserved"]}
    else:
        rec["peak_reserved"] = 0
        rec["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                         "memory_peak_bytes": 0}
    if ctx.trace:
        if device.type == "cuda":
            loop.sample = set()
            prof = rec["profile"] = _profile(loop, i, traffic["profile_steps"])
            rec["device"]["busy_s"] = prof["busy_s"]
            rec["device"]["window_s"] = prof["window_s"]
            rec["breakdown"] = {"device_ops": prof["device_ops"],
                                "idle_gaps": prof["idle_gaps"]}
            ctx.log(f"profiler: {prof['kernel_records']} kernel records over "
                    f"{traffic['profile_steps']} steps, busy "
                    f"{prof['busy_s']:.4f} of {prof['window_s']:.4f} s")
        ctx.log(f"card and power limit: {_power_limit()}")
        rec["probes"] = {name: probe(ctx, rec) for name, probe in ctx.probes.items()}
    taken = loop.taken
    del loop, built
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    nums = check_train.numbers(taken, config, frozen, device)
    rec["check"] = {"numbers": nums, "limits": config["limits"],
                    "steps": [t["index"] for t in taken],
                    "correct": check_train.judge(nums, config["limits"])}
    ctx.log(f"reference: {len(taken)} sampled steps in "
            f"{time.perf_counter() - t_ref:.1f} s")
    return rec
