"""Closed loop of try-on requests through the inference CLI's step.

A request is one compact uint8 batch handed to
``hrviton_tpu_torch.cli.test_generator.tryon_step``, called as the CLI calls
it (unpaired, compact) on the CLI's ``TryOnPipeline``
(``build_pipeline``; ``--bf16`` where the configuration is bfloat16): the
copy to the card, the expansion graph, the try-on graph. It ends when its
rgb, as float32, is in host memory, as the CLI's writer needs it: the copy
runs on a side stream, so that with two requests in flight the next one is
submitted before the last one's rgb has come back.

The traffic file gives ``batch``, ``in_flight`` (requests submitted and not
yet returned), ``pool`` (distinct batches, cycled in an order drawn from the
seed), ``sample`` (timed requests compared with the reference) and
``profile_requests`` (requests under ``torch.profiler`` after the window of
a traced run).

Set-up: the pipeline built, the benchmark's weights loaded into it, the
pool made, two requests through the same path (the first records both
graphs; the second replays them). The window then runs for ``seconds``; the
requests in flight at its close are finished and counted in the latencies
but not in the images of the window. A traced run (``trace``) clocks the
host's part of each request in the window, then profiles
``profile_requests`` more on the card (``reduce_trace``: the device's busy
time, and the device time of each request's upload and forward), then runs
the per-layer metrics' probes. Last, with the program freed, the reference
runs on the sampled requests' inputs.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import json
import os
import subprocess
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import check, inputs
from benchmark.reference import hrviton as ref

__all__ = ["run", "make_inputs", "build_pipeline", "load_weights", "Loop",
           "reference_outputs", "reduce_trace", "draw_sample"]


def _argv(config, traffic, seed: int, device: str) -> List[str]:
    """The inference CLI's flags for the configuration."""
    p, g, t = config["pipeline"], config["generator"], config["tocg"]
    argv = ["--tocg_checkpoint", "", "--gen_checkpoint", "", "--device", device,
            "--seed", str(seed), "-b", str(traffic["batch"]),
            "--fine_height", str(p["fine_height"]), "--fine_width", str(p["fine_width"]),
            "--cond_height", str(p["cond_height"]), "--cond_width", str(p["cond_width"]),
            "--semantic_nc", str(p["semantic_nc"]),
            "--clothmask_composition", p["clothmask_composition"],
            "--ngf", str(g["ngf"]), "--gen_semantic_nc", str(g["gen_semantic_nc"]),
            "--num_upsampling_layers", g["num_upsampling_layers"],
            "--norm_G", g["norm_G"], "--warp_feature", t["warp_feature"],
            "--out_layer", t["out_layer"], "--upsample", t["upsample"]]
    if p["occlusion"]:
        argv.append("--occlusion")
    if config["precision"] == "bfloat16":
        argv.append("--bf16")
    return argv


def build_pipeline(config, traffic, seed: int, device: str):
    """The CLI's pipeline for ``config`` (its own random weights from
    ``seed``, replaced by ``load_weights``)."""
    from hrviton_tpu_torch.cli import test_generator as tg
    pipe = tg.build_pipeline(tg.get_opt(_argv(config, traffic, seed, device)))
    if pipe.tocg.cfg.ngf != config["tocg"]["ngf"]:
        raise ValueError(f"the CLI builds the tocg at ngf={pipe.tocg.cfg.ngf}")
    if pipe.generator.cfg.fused_block != config["generator"]["fused_block"]:
        raise ValueError("the CLI's fused_block differs from the configuration")
    if pipe.dtype != inputs.DTYPES[config["precision"]]:
        raise ValueError(f"the CLI's pipeline computes in {pipe.dtype}")
    return pipe


def load_weights(pipe, weights) -> None:
    """Copy the benchmark's tensors into the pipeline's modules, name by
    name; every tensor of each module must be given, at its shape."""
    for model, module in (("tocg", pipe.tocg), ("generator", pipe.generator)):
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


class _Named:
    """The pipeline as ``tryon_step`` sees it, its call named for the
    profiler (``LAYERS``)."""

    def __init__(self, pipe):
        self._pipe = pipe

    def __getattr__(self, name):
        return getattr(self._pipe, name)

    def __call__(self, batch, noise=None):
        with torch.profiler.record_function("TryOnPipeline.__call__"):
            return self._pipe(batch, noise)


def _named(fn, name):
    def call(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return call


class _Pending:
    __slots__ = ("index", "t_sub", "step", "host", "done", "host_s")


class Loop:
    """Submits requests and brings their rgb back (module docstring)."""

    def __init__(self, pipe, pool, order, traffic, semantic_nc, device):
        from hrviton_tpu_torch.cli import test_generator as tg
        self.tg = tg
        self.pipe, self.pool, self.order = pipe, pool, order
        self.in_flight = traffic["in_flight"]
        self.semantic_nc = semantic_nc
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.slots: list = [None] * self.in_flight
        self.trace = False      # host clocks a request
        self.annotate = False   # the request's parts named for the profiler
        self.shapes = None      # the condition outputs kept of a sample
        self.keep: Dict[int, tuple] = {}

    def plan_keep(self, indices) -> None:
        """Host buffers for the condition outputs of the requests
        ``indices`` (pinned on the card), made before the window from the
        shapes the warm-up saw."""
        pin = self.cuda
        self.keep = {i: tuple(torch.empty(shape, dtype=dtype, pin_memory=pin)
                              for shape, dtype in self.shapes) for i in indices}

    def submit(self, i: int) -> _Pending:
        p = _Pending()
        p.index, p.host_s = i, None
        raw = self.pool[self.order[i % len(self.order)]]
        pipe = self.pipe
        upload = [0.0]

        def clocked(to_device):
            def call(batch, device):
                t = time.perf_counter()
                out = to_device(batch, device)
                upload[0] = time.perf_counter() - t
                return out
            return call
        with contextlib.ExitStack() as stack:
            if self.trace:
                stack.enter_context(self._replaced("to_device", clocked))
            if self.annotate:
                pipe = _Named(pipe)
                for name in ("to_device", "prepare_batch"):
                    stack.enter_context(self._replaced(
                        name, lambda f, n=name: _named(f, n)))
                stack.enter_context(torch.profiler.record_function("tryon_step"))
            p.t_sub = time.perf_counter()
            p.step = self.tg.tryon_step(pipe, raw, datasetting="unpaired",
                                        compact=True,
                                        semantic_nc=self.semantic_nc)
        if self.trace:
            p.host_s = time.perf_counter() - p.t_sub - upload[0]
        out, cond = p.step.output, p.step.cond
        sample = (cond.warped_cloth, cond.fake_parse_gauss, cond.parse_labels)
        self.shapes = [(t.shape, t.dtype) for t in sample]
        slot = i % self.in_flight
        if self.slots[slot] is None or self.slots[slot].shape != out.shape:
            self.slots[slot] = torch.empty(out.shape, dtype=torch.float32,
                                           pin_memory=self.cuda)
        side = contextlib.nullcontext()
        if self.cuda:
            ready = torch.cuda.Event()
            ready.record()
            self.stream.wait_event(ready)
            side = torch.cuda.stream(self.stream)
        with side:
            self.slots[slot].copy_(out.float(), non_blocking=self.cuda)
            for buf, t in zip(self.keep.get(i, ()), sample):
                buf.copy_(t, non_blocking=self.cuda)
            p.done = None
            if self.cuda:
                p.done = torch.cuda.Event()
                p.done.record(self.stream)
        p.host = self.slots[slot]
        return p

    @contextlib.contextmanager
    def _replaced(self, name, wrap):
        """The CLI module's ``name`` replaced by ``wrap(it)`` for the block
        (``tryon_step`` looks it up there at each call)."""
        orig = getattr(self.tg, name)
        setattr(self.tg, name, wrap(orig))
        try:
            yield
        finally:
            setattr(self.tg, name, orig)

    def complete(self, p: _Pending):
        """Wait for the request's rgb on the host: (seconds since its
        submission, the rgb as numpy)."""
        if p.done is not None:
            with (torch.profiler.record_function("wait for the rgb")
                  if self.annotate else contextlib.nullcontext()):
                p.done.synchronize()
        return time.perf_counter() - p.t_sub, p.host.numpy()


def _draw_order(n: int, seed: int) -> List[int]:
    return [int(i) for i in np.random.default_rng(seed).permutation(n)]


def _serve(loop: Loop, first: int, until=None, count=None):
    """Requests from index ``first`` in a closed loop until the host clock
    passes ``until`` (or ``count`` have been submitted). Returns a list of
    (index, latency s, completed by ``until``, host s, end) and the
    outputs of the requests ``loop.keep`` names {index: (rgb, warped cloth,
    blurred logits, labels)} on the host."""
    done, kept = [], {}
    pending = collections.deque()
    i = first

    def finish(p):
        lat, rgb = loop.complete(p)
        t_end = p.t_sub + lat
        if p.index in loop.keep:
            kept[p.index] = (torch.from_numpy(rgb.copy()), *loop.keep[p.index])
        done.append((p.index, lat, until is None or t_end <= until, p.host_s,
                     t_end))

    while True:
        if count is not None and i - first >= count:
            break
        if until is not None and time.perf_counter() >= until:
            break
        pending.append(loop.submit(i))
        i += 1
        if len(pending) >= loop.in_flight:
            finish(pending.popleft())
    while pending:
        finish(pending.popleft())
    return done, kept


# the host ranges the harness names under the profiler, and the layer whose
# device work each one launches
LAYERS = {"to_device": "upload", "prepare_batch": "upload",
          "TryOnPipeline.__call__": "forward"}


def _union(spans) -> float:
    total, cur = 0.0, None
    for a, b in sorted(spans):
        if cur is None or a > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    return total + (cur[1] - cur[0] if cur is not None else 0.0)


def reduce_trace(events) -> Dict:
    """A chrome trace of ``torch.profiler`` (its ``traceEvents``) ->
    device busy seconds (the union of kernels, copies and sets), the device
    seconds a request of each of ``LAYERS``' layers (the union of the device
    operations that the runtime calls inside its ranges launched, found by
    their correlation ids; a graph's kernels carry its launch's), the
    kernels each forward launched (equal in every forward unless the
    profiler lost records), the top device operations, and the longest
    idle gaps named by the innermost host range open at their middle."""
    x = [e for e in events if e.get("ph") == "X"]
    dev = [e for e in x if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    host = [e for e in x if e.get("cat") in ("cpu_op", "user_annotation",
                                             "cuda_runtime", "python_function")]
    launched = {e["args"]["correlation"]: e["ts"] for e in x
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in x
                    if e.get("cat") == "user_annotation" and e["name"] in LAYERS)

    def range_of(t):
        inner = [r for r in ranges if r[0] <= t <= r[1]]
        return max(inner) if inner else None
    per_layer = collections.defaultdict(list)
    per_forward = collections.Counter()
    for e in dev:
        t = launched.get(e.get("args", {}).get("correlation"))
        r = range_of(t) if t is not None else None
        if r is None:
            continue
        per_layer[LAYERS[r[2]]].append((e["ts"], e["ts"] + e["dur"]))
        if LAYERS[r[2]] == "forward" and e["cat"] == "kernel":
            per_forward[r] += 1
    requests = sum(1 for r in ranges if r[2] == "to_device")
    forwards = [r for r in ranges if LAYERS[r[2]] == "forward"]
    layer_ms = ({k: 1e-3 * _union(v) / requests for k, v in per_layer.items()}
                if requests else {})

    by_name: Dict[str, float] = collections.Counter()
    for e in dev:
        by_name[e["name"]] += e["dur"] * 1e-6
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev)
    gaps, end = [], None
    for a, b in spans:
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    gaps.sort(key=lambda g: g[0] - g[1])

    def host_at(t):
        live = [e for e in host if e["ts"] <= t <= e["ts"] + e["dur"]]
        return max(live, key=lambda e: e["ts"])["name"] if live else "host idle"
    return {"busy_s": 1e-6 * _union(spans), "requests": requests,
            "layer_ms": layer_ms,
            "forward_kernels": [per_forward[r] for r in forwards],
            "device_ops": [[k, v] for k, v in by_name.most_common(10)],
            "idle_gaps": [[host_at((a + b) / 2), (b - a) * 1e-6]
                          for a, b in gaps[:10]],
            "kernel_records": sum(1 for e in dev if e["cat"] == "kernel"),
            "unit_kernel_records": sum(1 for e in dev
                                       if "spade_unit" in e["name"])}


def _profile(loop: Loop, first: int, count: int, counters) -> Dict:
    """``count`` requests under torch.profiler, reduced by
    ``reduce_trace``, with the traced window's host seconds and the launch
    counters' counts over it."""
    from torch.profiler import ProfilerActivity, profile
    before = {k: f.launches for k, f in counters.items()}
    loop.annotate = True
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function("benchmark loop"):
            _serve(loop, first, count=count)
        window_s = time.perf_counter() - t0
    loop.annotate = False
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            out = reduce_trace(json.load(f)["traceEvents"])
    finally:
        os.remove(path)
    out["window_s"] = window_s
    out["launches"] = {k: f.launches - before[k] for k, f in counters.items()}
    return out


def _counters():
    """The launch counters the metrics read (``core/graphs.register_counters``:
    replays count too)."""
    from hrviton_tpu_torch.ops.spade_block import spade_conv_unit
    return {"spade_conv_unit": spade_conv_unit}


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def draw_sample(rng, span: int, n: int, in_flight: int) -> List[int]:
    """``n`` distinct request indices below ``span`` drawn with ``rng``, at
    least one in each of the ``in_flight`` slots (index mod ``in_flight``),
    so that a fault of one slot's copies cannot escape the sample."""
    if not in_flight <= n <= span:
        raise ValueError(f"cannot draw {n} of {span} over {in_flight} slots")
    first = [int(rng.choice(np.arange(s, span, in_flight)))
             for s in range(in_flight)]
    rest = [i for i in range(span) if i not in first]
    return sorted(first + [int(i) for i in rng.permutation(rest)[:n - in_flight]])


def make_inputs(config, traffic, seed: int, device):
    """(the run's sub-seeds, the weights, the pool, the order the pool is
    served in), all from ``seed``."""
    seeds = inputs.sub_seeds(seed)
    weights = inputs.make_weights(ref.param_specs(config), config["init"],
                                  seeds["weights"], device,
                                  inputs.DTYPES[config["precision"]])
    p = config["pipeline"]
    pool = inputs.make_pool(traffic["pool"], traffic["batch"], p["fine_height"],
                            p["fine_width"], seeds["inputs"], device)
    return seeds, weights, pool, _draw_order(len(pool), seeds["inputs"])


def run(ctx) -> Dict:
    """One run of the cell (``ctx``: config, traffic, seed, seconds, trace,
    device, t0, probes, log). Returns the record the metrics read."""
    config, traffic = ctx.config, ctx.traffic
    device = torch.device(ctx.device)
    seeds, weights, pool, order = make_inputs(config, traffic, ctx.seed, device)
    pipe = build_pipeline(config, traffic, seeds["pipeline"], ctx.device)
    load_weights(pipe, weights)
    loop = Loop(pipe, pool, order, traffic, config["pipeline"]["semantic_nc"],
                device)
    counters = _counters()

    # set-up: the first request records both graphs, the second replays them
    warm, _ = _serve(loop, 0, count=2)
    t_req = warm[-1][1]
    rng = np.random.default_rng(seeds["sample"])
    span = max(traffic["sample"], int(0.5 * ctx.seconds / max(t_req, 1e-3)))
    loop.plan_keep(draw_sample(rng, span, traffic["sample"], loop.in_flight))
    loop.trace = bool(ctx.trace)
    before = {k: f.launches for k, f in counters.items()}
    if device.type == "cuda":
        torch.cuda.synchronize()

    t_start = time.perf_counter()
    setup_s = t_start - ctx.t0
    done, kept = _serve(loop, 0, until=t_start + ctx.seconds)
    loop.keep = {}
    window_s = ctx.seconds
    launches = {k: f.launches - before[k] for k, f in counters.items()}
    rec = {"setup_s": setup_s, "window_s": window_s, "config": config,
           "attempted": len(done), "failed": 0,
           "images_in_window": traffic["batch"] * sum(1 for d in done if d[2]),
           "latencies_ms": [d[1] * 1e3 for d in done],
           "launches": launches, "forwards": len(done)}
    if loop.trace:
        rec["host_ms"] = 1e3 * float(np.mean([d[3] for d in done]))
    loop.trace = False
    fifths = [traffic["batch"] * sum(
        1 for d in done if d[2] and k <= 5 * (d[4] - t_start) / window_s < k + 1)
        for k in range(5)]
    ctx.log(f"window: {rec['images_in_window']} images, by fifths {fifths}")
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
            prof = rec["profile"] = _profile(
                loop, len(done), traffic["profile_requests"], counters)
            rec["device"]["busy_s"] = prof["busy_s"]
            rec["device"]["window_s"] = prof["window_s"]
            rec["breakdown"] = {"device_ops": prof["device_ops"],
                                "idle_gaps": prof["idle_gaps"]}
            ctx.log(f"profiler: {prof['kernel_records']} kernel records, "
                    f"{prof['unit_kernel_records']} of the unit's kernels "
                    f"against {2 * prof['launches']['spade_conv_unit']} its "
                    f"launch counter gives, over {traffic['profile_requests']} "
                    f"requests; kernels a forward {sorted(set(prof['forward_kernels']))}")
        ctx.log(f"card and power limit: {_power_limit()}")
        rec["probes"] = {name: probe(ctx, rec) for name, probe in ctx.probes.items()}
    del done, loop, pipe, warm
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    rec["check"] = _check(config, pool, order, kept, weights,
                          seeds["pipeline"] + 1, device)
    ctx.log(f"reference: {rec['check']['images']} images of "
            f"{len(kept)} sampled requests in "
            f"{time.perf_counter() - t_ref:.1f} s")
    return rec


def reference_outputs(config, pool, order, indices, weights, noise_seed,
                      device, mode="f32", given=None):
    """The reference's outputs (``reference/hrviton.Outputs``) of the
    requests ``indices``, in ``mode``; ``given``: for each, the condition
    outputs (warped cloth, labels) its generator is fed."""
    return [ref.tryon(weights, config, pool[order[i % len(order)]], noise_seed,
                      device, mode=mode,
                      given=None if given is None else given[k])
            for k, i in enumerate(indices)]


def _check(config, pool, order, kept, weights, noise_seed, device) -> Dict:
    """The sampled requests against the reference (``benchmark/check.py``):
    its condition stage from the batches, its generator from the program's
    condition outputs."""
    got = [kept[i] for i in sorted(kept)]
    want = reference_outputs(config, pool, order, sorted(kept), weights,
                             noise_seed, device,
                             given=[(g[1], g[3]) for g in got])
    nums = check.numbers(got, want, config["label_margin"]) if got else dict.fromkeys(
        check.NUMBERS, float("inf"))
    return {"numbers": nums, "limits": config["limits"], "images": sum(
        g[0].shape[0] for g in got), "correct": check.judge(nums, config["limits"]),
        "outputs": (got, want)}
