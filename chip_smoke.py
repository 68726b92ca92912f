#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):
  1. device: the card's name and power limit (nvidia-smi), torch/CUDA versions;
  2. build: compile every hand-written kernel from the sources in the checkout;
  3. kernel check: the fused SPADE unit (hrviton_tpu_torch/ops/spade_block.py,
     csrc/spade_block.cu) against its plain PyTorch version at the six unit
     shapes of the main path (up_3 and up_4 x norm_s/norm_0/norm_1, batch 4),
     in bf16 and f32, with times beside the bound;
  4. main path: TryOnPipeline at full width (tocg ngf=96 at 256x192, SPADE
     ngf=64 'most' at 1024x768, bf16, random seeded weights) answers 3
     requests of batch 4; the unit kernel must launch exactly 6 times per
     request, the rgb must be finite in [-1, 1], and one request is compared
     with the same pipeline with the fused gate off (plain units on the card).

The second-to-last line is the {"kernels": [...]} JSON record and the last
line is {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

B = 4                       # batch of the kernel check and of each request
N_REQUESTS = 3
PEAK_BYTES = 3.35e12        # H100 SXM HBM3, bytes/s
PEAK_OPS = {torch.bfloat16: 989e12,    # dense bf16 tensor-core FLOP/s
            torch.float32: 67e12}      # f32 outside the tensor cores
SOURCE = "hrviton_tpu_torch/csrc/spade_block.cu"
REPLACES = "hrviton_tpu/ops/spade_block.py:337"   # pl.pallas_call of _kernel

# (name, h, w, c, cout, ksize, pre_act, residual): the units of up_3 / up_4
# at 1024x768, ngf=64 (spade.py: norm_s->conv_s, norm_0->conv_0,
# norm_1->conv_1 with the shortcut as residual)
UNITS = [
    ("up_3.norm_s", 512, 384, 144, 64, 1, None, False),
    ("up_3.norm_0", 512, 384, 144, 64, 3, "leaky0.2", False),
    ("up_3.norm_1", 512, 384, 64, 64, 3, "leaky0.2", True),
    ("up_4.norm_s", 1024, 768, 80, 32, 1, None, False),
    ("up_4.norm_0", 1024, 768, 80, 32, 3, "leaky0.2", False),
    ("up_4.norm_1", 1024, 768, 32, 32, 3, "leaky0.2", True),
]


def log(*a):
    print(*a, flush=True)


def device_phase():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; "
                 "this script needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return card


def build_phase():
    from hrviton_tpu_torch.ops import spade_block as sb
    t0 = time.perf_counter()
    lib = sb.build(verbose=True)
    log(f"build: {lib.name} in {time.perf_counter() - t0:.2f} s")


def _events_ms(fn, iters):
    fn()                                       # warm-up
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def _unit_inputs(gen, dtype, h, w, c, cout, ks, residual):
    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale
    args = [r(B, h, w, c).to(dtype), r(B, h, w, 1), r(c, scale=0.1),
            r(B, h, w, 128).to(dtype),
            r(c, 128, 3, 3, scale=0.03), r(c, scale=0.1),
            r(c, 128, 3, 3, scale=0.03), r(c, scale=0.1),
            r(cout, c, ks, ks, scale=(1.0 / (c * ks * ks)) ** 0.5),
            r(cout, scale=0.1) if ks == 3 else None]
    res = r(B, h, w, cout).to(dtype) if residual else None
    return args, res


def kernel_phase():
    """Kernel vs plain at each main-path unit shape. Tolerances: f32 (TF32
    off in the plain version) 1e-4 x max|ref|, for f32 sums of 9*128 products
    in another order; bf16 2 ulps of max|ref| (2 * 2^-7 * max|ref|), since the
    plain version rounds gamma, beta, mod and out to bf16 and a sum in another
    order flips single roundings."""
    from hrviton_tpu_torch.ops import spade_block as sb
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    totals = {}
    for dtype in (torch.bfloat16, torch.float32):
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, max_abs=0.0,
                   ops_ms=0.0, bytes_ms=0.0)
        for name, h, w, c, cout, ks, act, residual in UNITS:
            args, res = _unit_inputs(gen, dtype, h, w, c, cout, ks, residual)
            out = sb.spade_conv_unit(act, *args, res)
            torch.cuda.synchronize()
            ref = sb.spade_conv_ref(*args, pre_act=act, residual=res)
            if not torch.isfinite(out).all():
                raise RuntimeError(f"{name} {dtype}: non-finite kernel output")
            scale = ref.float().abs().max().item()
            err = (out.float() - ref.float()).abs().max().item()
            tol = (1e-4 if dtype == torch.float32 else 2 * 2 ** -7) * scale
            ok = err <= tol
            ms = _events_ms(lambda: sb.spade_conv_unit(act, *args, res), 3)
            plain_ms = _events_ms(
                lambda: sb.spade_conv_ref(*args, pre_act=act, residual=res), 3)
            flops = sb.unit_flops(B, h, w, c, cout, ks)
            nbytes = sb.unit_bytes(B, h, w, c, cout, ks,
                                   elem=args[0].element_size(),
                                   residual=residual)
            t_ops = flops / PEAK_OPS[dtype] * 1e3
            t_bytes = nbytes / PEAK_BYTES * 1e3
            bound = max(t_ops, t_bytes)
            log(f"unit {name} {str(dtype)[6:]}: max_abs {err:.3e} "
                f"(tol {tol:.3e}, rel {err / scale:.2e}) "
                f"{'ok' if ok else 'FAIL'} | kernel {ms:.3f} ms, plain "
                f"{plain_ms:.3f} ms, bound {bound:.4f} ms "
                f"({'operations' if t_ops >= t_bytes else 'bytes'}), "
                f"{flops / ms / 1e9:.1f} TFLOP/s")
            if not ok:
                raise RuntimeError(f"{name} {dtype}: kernel disagrees with "
                                   f"its plain version ({err} > {tol})")
            tot["ms"] += ms
            tot["plain_ms"] += plain_ms
            tot["bound_ms"] += bound
            tot["max_abs"] = max(tot["max_abs"], err)
            tot["ops_ms"] += t_ops
            tot["bytes_ms"] += t_bytes
            del args, res, out, ref
        totals[dtype] = tot
        log(f"six units, batch {B}, {str(dtype)[6:]}: kernel "
            f"{tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, bound "
            f"{tot['bound_ms']:.4f} ms")
    torch.cuda.empty_cache()
    return totals


def _synthetic_batch(h, w, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda c: torch.randn(B, h, w, c, generator=g, device="cuda")
    return {"cloth": r(3),
            "cloth_mask": torch.rand(B, h, w, 1, generator=g, device="cuda"),
            "parse_agnostic": r(13), "densepose": r(3), "agnostic": r(3)}


def _kernel_group(name):
    if "spade_unit" in name:
        return "fused unit (spade_unit kernels)"
    low = name.lower()
    if any(k in low for k in ("conv", "xmma", "gemm", "cudnn", "sm90", "cutlass")):
        return "convolutions (cuDNN)"
    if "grid_sampler" in low or "upsample" in low or "interp" in low:
        return "resize / grid_sample"
    if "reduce" in low or "norm" in low or "welford" in low:
        return "reductions (stats, norms)"
    return "other elementwise / copies"


def profile_phase(pipe, batch):
    """One steady request under torch.profiler: device time by kernel group
    and the device's busy share of the request's wall time. Informational:
    if the profiler sees no device activity, it says so."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        pipe(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        log("profile: the profiler recorded no device time (not measured)")
        return
    groups = {}
    for e in kernels:
        g = _kernel_group(e.name)
        groups[g] = groups.get(g, 0.0) + e.time_range.elapsed_us()
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    total = sum(groups.values())
    log(f"profile: one request {wall_us / 1e3:.1f} ms wall, device busy "
        f"{busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}%), {len(kernels)} "
        f"kernel launches")
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"profile:   {g}: {us / 1e3:.2f} ms ({100 * us / total:.1f}% of "
            f"device time)")


def main_path_phase(card):
    from hrviton_tpu_torch import TryOnPipeline
    from hrviton_tpu_torch.models.spade import SPADENorm
    from hrviton_tpu_torch.ops import spade_block as sb
    torch.backends.cudnn.benchmark = True
    t0 = time.perf_counter()
    pipe = TryOnPipeline(device="cuda", dtype=torch.bfloat16, seed=0)
    # noise_scale initialises to zero; random values make the noise path count
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for m in pipe.generator.modules():
            if isinstance(m, SPADENorm):
                m.noise_scale.copy_(torch.randn(m.noise_scale.shape,
                                                generator=g) * 0.1)
    log(f"main path: TryOnPipeline built in {time.perf_counter() - t0:.2f} s "
        f"({sum(p.numel() for p in pipe.generator.parameters()) / 1e6:.1f}M "
        f"generator, {sum(p.numel() for p in pipe.tocg.parameters()) / 1e6:.1f}M "
        f"tocg parameters)")
    fh, fw = pipe.cfg.fine_height, pipe.cfg.fine_width
    batches = [_synthetic_batch(fh, fw, seed) for seed in range(N_REQUESTS)]

    sb.spade_conv_unit.launches = 0
    times, outs = [], []
    for i, batch in enumerate(batches):
        before = sb.spade_conv_unit.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        rgb, cond = pipe(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        n = sb.spade_conv_unit.launches - before
        if n != 6:
            raise RuntimeError(f"request {i}: {n} unit launches, expected 6")
        if tuple(rgb.shape) != (B, fh, fw, 3):
            raise RuntimeError(f"rgb shape {tuple(rgb.shape)}")
        if not torch.isfinite(rgb).all() or rgb.abs().max().item() > 1.0:
            raise RuntimeError("rgb not finite or outside [-1, 1]")
        outs.append(rgb)
        log(f"request {i}: {times[-1] * 1e3:.1f} ms, 6 unit launches, rgb "
            f"mean {rgb.float().mean().item():.4f} std "
            f"{rgb.float().std().item():.4f}")
    launches = sb.spade_conv_unit.launches

    # the first request against the same pipeline with the fused gate off;
    # the second gate-off run is timed (the first one tunes cuDNN's convs)
    pipe.generator.set_fused(False)
    before = sb.spade_conv_unit.launches
    rgb_plain, _ = pipe(batches[0])
    torch.cuda.synchronize()
    t = time.perf_counter()
    pipe(batches[1])
    torch.cuda.synchronize()
    unfused_s = time.perf_counter() - t
    pipe.generator.set_fused(True)
    if sb.spade_conv_unit.launches != before:
        raise RuntimeError("the unfused pipeline launched the fused kernel")
    d = (outs[0].float() - rgb_plain.float()).abs()
    ref = rgb_plain.float().abs()
    # bf16: both versions round gamma, beta, mod and out to bf16 (relative
    # step 2^-8); sums in another order flip single roundings, which conv_img
    # and tanh carry to the rgb. Limits: max 5% of max|rgb|, mean 1% of
    # mean|rgb| of the unfused output.
    lim_max, lim_mean = 0.05 * ref.max().item(), 0.01 * ref.mean().item()
    log(f"fused vs unfused pipeline (bf16): max_abs {d.max().item():.4e} "
        f"mean_abs {d.mean().item():.4e} (limits {lim_max:.3e} / "
        f"{lim_mean:.3e})")
    if d.max().item() > lim_max or d.mean().item() > lim_mean:
        raise RuntimeError("fused pipeline disagrees with the unfused one")
    profile_phase(pipe, batches[2])
    steady = sum(times[1:]) / len(times[1:])
    log(f"main path: {steady * 1e3:.1f} ms/request (batch {B}, steady, "
        f"requests 2-{N_REQUESTS}), {B / steady:.2f} img/s, first request "
        f"{times[0] * 1e3:.1f} ms; fused gate off: {unfused_s * 1e3:.1f} "
        f"ms/request | {card}")
    return launches


def main():
    card = device_phase()
    build_phase()
    totals = kernel_phase()
    launches = main_path_phase(card)
    t = totals[torch.bfloat16]
    record = {"kernels": [{
        "name": "spade_unit (six units of one batch-4 request: up_3, up_4 x "
                "norm_s/norm_0/norm_1, bf16)",
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": t["max_abs"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": "operations" if t["ops_ms"] >= t["bytes_ms"] else "bytes",
        "library_ms": None,
    }]}
    log(card)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
