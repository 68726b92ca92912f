#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py            # everything below
    python3 chip_smoke.py --paths    # phases 1, 2, 4, 5 and 6 only
    python3 chip_smoke.py --alone    # phases 1, 2 and kernels' times alone

Phases (any failure exits non-zero, and no result line is printed):
  1. device: the card's name and power limit (nvidia-smi), torch/CUDA versions;
  2. build: compile every hand-written kernel from the sources in the checkout
     (hrviton_tpu_torch/csrc/{spade_block,spade_fused,conv3x3,copy_probe,
     conv_tma}.cu: twelve kernels and the instance statistics; conv_tma.cu
     holds conv_halo, conv_roll, conv_band, conv_dma, conv_prodroll, conv_e2
     and conv_e), one nvcc process each, all started together, with ptxas's
     report of registers and spills; a kernel whose wgmma ptxas serialised
     (C7518, C7520) fails it;
  3. kernel check: each kernel's wrapper against its plain PyTorch version at
     every shape its main path gives it, batch 4, in bf16 and f32, with times
     beside the bound:
       - the fused SPADE unit (ops/spade_block.py) at the six unit shapes of
         the first path (up_3, up_4 x norm_s/norm_0/norm_1): in bf16 two
         launches on the TMA / wgmma conv engine (gamma|beta with the
         modulation, then the consumer conv) and the one-pass statistics,
         each part's time printed; and at one ragged small shape;
       - the one-pass instance statistics (ops/spade_fused.py:norm_stats)
         against instance_stats at the six unit shapes (mu within 1e-4 of
         the std, rsig within 1e-4 relative);
       - the fused modulation (ops/spade_fused.py, in bf16 the unit's
         gamma|beta stage on the conv engine with no activation) at the nine
         norms of the second path (up_2, up_3, up_4), beside cuDNN's time for
         the gamma|beta product alone (not the same function), and at one
         ragged small shape;
       - the wide 3x3 conv (ops/conv3x3.py:conv3x3_wide, on the conv engine
         in bf16) at its eight sites (up_1's gamma/beta convs and conv_1,
         up_2's conv_1), beside F.conv2d, and at one ragged small shape;
       - the small-channel 3x3 conv (conv3x3_small, on the conv engine in
         bf16; 9 input channels as the engine's narrow input) at its four
         sites (conv_6, conv_7, up_4.conv_1, conv_img), beside F.conv2d,
         and at three ragged small shapes (one with 20 input channels,
         which the wrapper pads to 24);
     the bf16 kernels of the modulation and the small conv are also timed
     alone by CUDA events around the bare C entry point, with the operands
     packed; the times of the unit, the modulation and both convs are
     printed beside those of the designs they replaced (PERF.md); and the
     SASS of every kernel on wgmma (cuobjdump -sass: the engine's and the
     seven of conv_tma.cu) must hold HGMMA and no HMMA, that of conv_band
     and conv_dma in a cluster of 2 or 4 the multicast form of the TMA load,
     and that of the band-copy probe the TMA load and store and no store of
     a thread to device memory;
  4. first path: TryOnPipeline at full width (tocg ngf=96 at 256x192, SPADE
     ngf=64 'most' at 1024x768, bf16, random seeded weights) with its default
     configuration answers 3 requests of batch 4; the unit kernel must launch
     exactly 6 times per request and no other kernel at all, the rgb must be
     finite in [-1, 1], and one request is compared with the same pipeline
     with the fused gate off (plain units on the card);
  5. second path: the same pipeline under SPADEGenConfig(fused_block=False,
     fast_spade=True, fast_conv=True) with the small-channel switch on
     answers 3 requests of batch 4; per request the modulation kernel must
     launch exactly 9 times, the wide conv 8 times, the small conv 4 times
     and the fused unit never; one request is compared with the same pipeline
     with the knobs off, and both are timed in turns; the layout copies
     around the modulation (models/spade.py:_nhwc) are timed in one request;
  6. the inference CLI's path (hrviton_tpu_torch/cli/test_generator.py) at
     its own configuration and full size (fine 1024x768, condition 256x192,
     tocg ngf=96, SPADE ngf=64 'most', batch 1, random weights from seed 0):
     the fused unit's wrapper at the six unit shapes at batch 1, in f32 (the
     FMA kernel, a direct call: off every path, since the kernels' gates
     take bf16 only, as the JAX gates do) and bf16 (the conv engine),
     against spade_conv_ref with TF32 off, with times beside the bound; 26 compact
     uint8 batches, each made with numpy from its own seed in the wire
     format of VitonHDDataset(compact=True); expand_compact on the card bit
     for bit against its CPU run; then the CLI's per-batch step (tryon_step)
     on every batch in f32 (the CLI's default, with torch's default TF32
     settings restored explicitly) and with --bf16: in f32 no hand-written
     kernel launches (the library's convs, TF32 off), with --bf16 the fused
     unit exactly 6 times a forward and the statistics 6; rgb finite in
     [-1, 1]; the
     first 3 equal to a TryOnPipeline built directly on the same expanded
     batch (f32 1e-4 x max|ref|, bf16 2 ulps); the first against the same
     weights with the fused unit off, fed inputs built from the raw batch
     with numpy (f32 1e-4 x max|ref|, bf16 the first path's limits); the 12
     panels' grid and to_uint8 of the expected shapes; ms per image by CUDA
     events over the 25 batches after the first (median, quartiles, min,
     max); and an f32 batch again with TF32 off for the process, equal to
     the default-settings run within 1e-4 x max|ref|, beside the difference
     a forward with TF32 on and the port's guard taken out gives (the
     check's teeth);
  7. tools: the conv-experiment entry points hrviton_tpu_torch/tools/
     {exp_conv,exp_conv2,exp_copy_probe}.main at their full size (x (4, 1024,
     768, 128), w (3, 3, 128, 128), bf16), exp_conv2.main once with 'all'
     and, as the JAX script times them, with 'e' and 'e2' under SKIP_CHECK,
     with exact launch counts; then each of their eight kernels (conv_band,
     conv_halo, conv_dma, conv_roll, conv_prodroll, conv_e, conv_e2, the
     band-copy probe) against its plain version at that size, at every band
     height its entry point times, and at one ragged small size (the probe
     bit for bit), with times beside the library call (F.conv2d;
     Tensor.copy_), conv3x3_wide at the same shape and the bound. Every conv
     (conv_halo, conv_roll, conv_band, conv_dma, conv_prodroll, conv_e2 and
     conv_e on TMA tensor loads and wgmma, csrc/conv_tma.cu) reads x as it
     is: its wrapper may allocate the output and the packed weights only,
     and may take no longer than the kernel alone and the weight packing.
     The times of the seven conv_tma.cu kernels and of the probe are printed
     beside those of the designs they replaced, with the time the host takes
     to encode a call's tensor maps and, for conv_band and conv_dma, the
     cluster each launch shares its weights over; conv_band, conv_dma,
     conv_prodroll, conv_e2, conv_e and the probe are also timed alone by
     CUDA events around the bare C entry point (weights packed beforehand),
     beside the profiler's time; the bound of conv_prodroll and conv_e2 with
     the products of their strips' overlapping columns is printed beside the
     conv's (conv_e walks whole rows: it has no overlap), and the probe's
     line gives the bytes its halo rows read again. No kernel pays the JAX
     tools' gather of halo tiles; it is timed alone for reference;
  8. the rejection and evaluation path (hrviton_tpu_torch/cli/
     {get_norm_const,test_condition,evaluate}.py) at the CLIs' own
     configuration, f32 (they have no bf16 flag): a synthetic VITON-HD tree
     of 64 train and 64 test pairs at 256x192 (the port's
     make_synthetic_dataset, written and read with PIL, as the CLIs read
     their data), the tocg ngf=96 with random weights from --seed 0, the
     condition discriminator (33 channels, ndf 64, 3 layers, 2 scales) from
     a D.pth the phase writes under the reference's keys from seeded random
     weights and reads through convert_cond_discriminator; get_norm_const
     prints M, test_condition --D_checkpoint --norm_const M writes 64 grids
     and rejection_prob.txt (64 lines, descending), all under torch's
     default TF32 settings; a second test_condition run with TF32 off gives
     the same scores within 1e-4 x max|ref|; the first batch's scores equal
     rejection_scores(d_logit(D(...)), M) computed on the card within 1e-4
     x max|ref|, beside what a discriminator forward with TF32 on and the
     guard taken out gives; test_condition's step (tocg + D + scores, batch
     8) timed by CUDA events on every batch; LPIPS alex (random weights) on
     the card against the same module on the CPU within 1e-4 x max|ref|,
     and timed per pair at 128x128; InceptionV3 timed per image at
     299x299; evaluate.main on the tocg's warped cloth of every test pair
     against the test images, with a torchvision-keyed inception_v3 .pth
     of seeded random weights: SSIM, MSE, LPIPS and IS finite, eval.txt
     and lpips.txt written; and no hand-written kernel launched in the
     whole phase (every counter unchanged).

The second-to-last line is the {"kernels": [...]} JSON record and the last
line is {"ok": true, "device": {...}}. With --paths the script stops after
phase 6 and prints only the last line: it is how two checkouts are timed in
turns (a copy of this script in each, see README). With --alone it times
the engine's model kernels at their main-path shapes by CUDA events (the
modulation and the small conv around their bare entry points, the unit and
the wide conv through their wrappers) and the tools' conv_prodroll, conv_e2,
conv_e and the probe in turns with F.conv2d and Tensor.copy_, and conv_band
and conv_dma in clusters of 1, 2 and 4 in turns (the
variants the shipped cluster was chosen from; the tap loop against the
unrolled taps, whose outputs alone are checked), and prints only the last
line: it is how two builds of the engine, a checkout and a copy of it with
one change, are timed in turns. Imports nothing of JAX.
"""

import dataclasses
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

B = 4                       # batch of the kernel check and of each request
N_REQUESTS = 3              # per path
PEAK_BYTES = 3.35e12        # H100 SXM HBM3, bytes/s
PEAK_OPS = {torch.bfloat16: 989e12,    # dense bf16 tensor-core FLOP/s
            torch.float32: 67e12}      # f32 outside the tensor cores
CSRC = "hrviton_tpu_torch/csrc/"

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
# (name, h, w, c, launches per request): the norms fast_spade admits
MODULATE_SITES = [
    ("up_2.norm_s/norm_0", 256, 192, 272, 2), ("up_2.norm_1", 256, 192, 128, 1),
    ("up_3.norm_s/norm_0", 512, 384, 144, 2), ("up_3.norm_1", 512, 384, 64, 1),
    ("up_4.norm_s/norm_0", 1024, 768, 80, 2), ("up_4.norm_1", 1024, 768, 32, 1),
]
# (name, h, w, cin, cout, pre_act, launches per request)
WIDE_SITES = [
    ("up_1.norm_s/norm_0 gamma, beta", 128, 96, 128, 528, "relu", 4),
    ("up_1.norm_1 gamma, beta", 128, 96, 128, 256, "relu", 2),
    ("up_1.conv_1", 128, 96, 256, 256, "leaky0.2", 1),
    ("up_2.conv_1", 256, 192, 128, 128, "leaky0.2", 1),
]
SMALL_SITES = [
    ("conv_6", 512, 384, 9, 16, None, 1),
    ("conv_7", 1024, 768, 9, 16, None, 1),
    ("up_4.conv_1", 1024, 768, 32, 32, "leaky0.2", 1),
    ("conv_img", 1024, 768, 32, 3, "leaky0.2", 1),
]
# launches per request on each path (the statistics: one per unit or norm)
FIRST_PATH = {"spade_unit": 6, "spade_modulate": 0, "conv3x3_wide": 0,
              "conv3x3_small": 0, "instance_stats": 6}
SECOND_PATH = {"spade_unit": 0,
               "spade_modulate": sum(s[-1] for s in MODULATE_SITES),   # 9
               "conv3x3_wide": sum(s[-1] for s in WIDE_SITES),         # 8
               "conv3x3_small": sum(s[-1] for s in SMALL_SITES),       # 4
               "instance_stats": sum(s[-1] for s in MODULATE_SITES)}   # 9
UNIT_RAGGED = (2, 37, 45, 40, 24, 3, "leaky0.2", True)   # b, h, w, c, cout, k
WIDE_RAGGED = (2, 37, 45, 128, 528, "relu")              # b, h, w, cin, cout
MODULATE_RAGGED = (2, 37, 45, 272)                       # b, h, w, c
# b, h, w, cin, cout, pre_act: a narrow input, one N tile of 8, and a Cin
# that the wrapper pads to a multiple of 8
SMALL_RAGGED = [(2, 37, 40, 9, 16, None), (2, 37, 40, 32, 3, "leaky0.2"),
                (2, 37, 45, 20, 24, "relu")]
# The model kernels on the conv engine, as they were before it (ldmatrix +
# mma.sync kernels, weights packed per call; the unit also with the
# three-pass statistics): one batch-4 bf16 request's (wrapper ms, kernel
# alone ms), as PERF.md records them, on an NVIDIA H100 80GB HBM3 at 700 W.
# Printed beside this run's totals.
EARLIER_MODEL = {"spade_unit": (46.50, 34.74), "conv3x3_wide": (2.38, 1.77),
                 "spade_modulate": (23.09, 20.33), "conv3x3_small": (1.82, 1.59)}
# the kernels on wgmma of each source (the engine's and the tools' TMA
# kernels), whose SASS must hold HGMMA and no HMMA
WGMMA_KERNELS = {"spade_fused": ("spade_modulate_kernel",),
                 "conv3x3": ("conv3x3_wide_kernel", "conv3x3_small_kernel"),
                 "spade_block": ("spade_unit_gb_kernel", "spade_unit_conv_kernel"),
                 "conv_tma": ("conv_halo_tma_kernel", "conv_roll_tma_kernel",
                              "conv_band_tma_kernel", "conv_dma_tma_kernel",
                              "conv_prodroll_tma_kernel", "conv_e2_tma_kernel",
                              "conv_e_tma_kernel")}
# the kernels that move bytes by TMA in both directions, whose SASS must hold
# the tensor load (UTMALDG) and store (UTMASTG) and no store of a thread to
# device memory (STG)
TMA_COPY_KERNELS = {"copy_probe": ("band_copy_probe_kernel",)}
# the BAND kind's template arguments (TR, TC, CL) in a mangled kernel name
BAND_ARGS = re.compile(r"conv_(?:band|dma)_tma_kernelILi(\d+)ELi(\d+)ELi(\d+)E")
# the SASS of a TMA load multicast over the cluster
MULTICAST = re.compile(r"\bUTMALDG\S*\.MULTICAST\b")
TOOLS_X = (B, 1024, 768, 128)           # the tools' x; w is (3, 3, 128, 128)
TOOLS_RAGGED = (2, 48, 40, 16, 24, 8)   # b, h, w, cin, cout, th
# (key, kernel name in a profile, band heights; the first is the record's)
TOOL_CONVS = [("conv_band", "conv_band_tma_kernel", (8, 16, 32)),
              ("conv_halo", "conv_halo_tma_kernel", (8, 16)),
              ("conv_dma", "conv_dma_tma_kernel", (8,)),
              ("conv_roll", "conv_roll_tma_kernel", (8, 16)),
              ("conv_prodroll", "conv_prodroll_tma_kernel", (8, 16)),
              ("conv_e", "conv_e_tma_kernel", (8, 16)),
              ("conv_e2", "conv_e2_tma_kernel", (8, 16))]
# wrappers that make no copy of x
UNSTAGED = ("conv_halo", "conv_roll", "conv_band", "conv_dma", "conv_prodroll",
            "conv_e", "conv_e2")
# how each tool wrapper orders the taps before it packs them
TAP_ORDER = {"conv_roll": "pack_kx", "conv_e2": "pack_ky"}
# the product-shift kernels in strips: bound with their strips' extra
# products
PRODUCT_SHIFT = ("conv_prodroll", "conv_e2")
# and all three product-shift kernels (conv_e walks whole rows)
SHIFT_KINDS = PRODUCT_SHIFT + ("conv_e",)
# the BAND kind (conv_band, conv_dma): launched in clusters
BAND_KIND = ("conv_band", "conv_dma")
# also timed alone by CUDA events around the bare entry point
EVENTS_ALONE = BAND_KIND + SHIFT_KINDS
# What the seven conv_tma.cu kernels and the probe took before they read x by
# TMA (cp.async / mma.sync kernels, after a gather or a pad in device memory
# for all but conv_e2 and conv_e; the probe's bulk copies into two slots and
# 16-byte stores of every thread): {band height: (wrapper ms, kernel alone
# ms)} as PERF.md records them, at TOOLS_X on an NVIDIA H100 80GB HBM3 at 700
# W. Printed beside this run's times; those kernels no longer exist to be
# timed again.
EARLIER = {"conv_halo": {8: (7.62, 4.04), 16: (8.44, 5.07)},
           "conv_roll": {8: (8.63, 5.05)},
           "conv_band": {8: (4.78, 3.42), 16: (4.24, 2.94), 32: (3.99, 2.68)},
           "conv_dma": {8: (4.83, 3.48)},
           "conv_prodroll": {8: (7.87, 4.19), 16: (7.86, 4.45)},
           "conv_e2": {8: (4.88, 4.68), 16: (5.42, 5.20)},
           "conv_e": {8: (4.12, 3.90), 16: (4.58, 4.56)},
           "copy_probe": {16: (0.572, 0.577)}}
PROBE_TH = 16


def log(*a):
    print(*a, flush=True)


def _wrappers():
    """name -> the kernel wrapper that carries the launch count (in --paths
    mode on an older checkout, only the wrappers it has)."""
    from hrviton_tpu_torch.ops import conv3x3 as c3
    from hrviton_tpu_torch.ops import spade_block as sb
    from hrviton_tpu_torch.ops import spade_fused as sf
    found = {"spade_unit": sb.spade_conv_unit,
             "spade_modulate": sf.fused_spade_modulate,
             "conv3x3_wide": c3.conv3x3_wide,
             "conv3x3_small": c3.conv3x3_small,
             "instance_stats": getattr(sf, "norm_stats", None)}
    return {k: w for k, w in found.items() if w is not None}


def _tool_wrappers():
    """name -> (kernel wrapper with the launch count, its plain version)."""
    from hrviton_tpu_torch.tools import exp_conv, exp_conv2, exp_copy_probe
    return {"conv_band": (exp_conv.conv_band, exp_conv.conv_band_ref),
            "conv_halo": (exp_conv2.conv_halo, exp_conv2.conv_halo_ref),
            "conv_dma": (exp_conv2.conv_dma, exp_conv2.conv_dma_ref),
            "conv_roll": (exp_conv2.conv_roll, exp_conv2.conv_roll_ref),
            "conv_prodroll": (exp_conv2.conv_prodroll,
                              exp_conv2.conv_prodroll_ref),
            "conv_e": (exp_conv2.conv_e, exp_conv2.conv_e_ref),
            "conv_e2": (exp_conv2.conv_e2, exp_conv2.conv_e2_ref),
            "copy_probe": (exp_copy_probe.probe, exp_copy_probe.probe_ref)}


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
    """Every source, with ptxas's report; fails if ptxas serialised the wgmma
    of a kernel (C7518, C7520: "wgmma.mma_async instructions are
    serialized")."""
    import contextlib
    import io
    from hrviton_tpu_torch.ops import _build
    t0 = time.perf_counter()
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        libs = _build.build_all(verbose=True)
    log(report.getvalue().rstrip())
    log(f"build: {', '.join(p.name for p in libs.values())} in "
        f"{time.perf_counter() - t0:.2f} s")
    serialized = [line for line in report.getvalue().splitlines()
                  if "are serialized" in line]
    if serialized:
        raise RuntimeError("ptxas serialised wgmma:\n" + "\n".join(serialized))


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


def _names(kernel_name):
    return (kernel_name,) if isinstance(kernel_name, str) else tuple(kernel_name)


def _device_ms(fn, kernel_name, iters=2, per_call=None):
    """Device time of the kernels whose names contain ``kernel_name`` (or one
    of a tuple of names) in one call of fn, from torch.profiler (the
    wrapper's own packing left out), or None if the profiler recorded no
    such kernel. A window now and then loses
    records (seen after the pipelines' profiles: one of two launches, or all
    of a window shorter than ~2 ms). ``per_call`` says how many such kernels
    one call launches, if known: then the mean over the records that did
    arrive is taken. Otherwise a window's records are summed, and a window
    whose count is no multiple of its calls is taken again, four times as
    long."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(3):
        n = iters * 4 ** attempt
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and any(n in e.name for n in _names(kernel_name))]
        if us and per_call:
            return sum(us) / len(us) * per_call / 1e3
        if us and len(us) % n == 0:
            return sum(us) / 1e3 / n
    return None


def _device_split(fn, names, iters=3):
    """ms per call of fn's kernels, by the first of ``names`` each kernel's
    name contains (torch.profiler); names with no record are left out."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = next((n for n in names if n in e.name), None)
        if name is not None:
            split[name] = split.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / iters
    return split


def _randn(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen, device="cuda") * scale


def _unit_inputs(gen, dtype, h, w, c, cout, ks, residual, batch=B):
    r = lambda *shape, scale=1.0: _randn(gen, *shape, scale=scale)
    args = [r(batch, h, w, c).to(dtype), r(batch, h, w, 1), r(c, scale=0.1),
            r(batch, h, w, 128).to(dtype),
            r(c, 128, 3, 3, scale=0.03), r(c, scale=0.1),
            r(c, 128, 3, 3, scale=0.03), r(c, scale=0.1),
            r(cout, c, ks, ks, scale=(1.0 / (c * ks * ks)) ** 0.5),
            r(cout, scale=0.1) if ks == 3 else None]
    res = r(batch, h, w, cout).to(dtype) if residual else None
    return args, res


def _check_site(tot, label, dtype, n, kernel, plain, library, kernel_name,
                flops, nbytes, exact=False, per_call=None):
    """One shape of one kernel: run the wrapper, hold it against its plain
    version (bit for bit if ``exact``), time wrapper, plain and library call,
    and add ``n`` launches' worth to the totals. ``per_call``: as in
    ``_device_ms``. Raises if the kernel disagrees."""
    out = kernel()
    torch.cuda.synchronize()
    ref = plain()
    if not torch.isfinite(out).all():
        raise RuntimeError(f"{label} {dtype}: non-finite kernel output")
    scale = ref.float().abs().max().item()
    err = (out.float() - ref.float()).abs().max().item()
    tol = (0.0 if exact else
           1e-4 if dtype == torch.float32 else 2 * 2 ** -7) * scale
    iters = 3 if dtype == torch.bfloat16 else 2
    ms = _events_ms(kernel, iters)
    plain_ms = _events_ms(plain, iters)
    lib_ms = _events_ms(library, iters) if library is not None else None
    dev_ms = (_device_ms(kernel, kernel_name, per_call=per_call)
              if dtype == torch.bfloat16 else None)
    t_ops = flops / PEAK_OPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    bound = max(t_ops, t_bytes)
    fmt = lambda v: "not measured" if v is None else f"{v:.3f} ms"
    log(f"{label} {str(dtype)[6:]} x{n}: max_abs {err:.3e} (tol {tol:.3e}, rel "
        f"{err / scale:.2e}) {'ok' if err <= tol else 'FAIL'} | wrapper "
        f"{ms:.3f} ms, kernel alone {fmt(dev_ms)}, plain {plain_ms:.3f} ms, "
        f"library {fmt(lib_ms)}, bound {bound:.4f} ms "
        f"({'operations' if t_ops >= t_bytes else 'bytes'}), "
        f"{flops / ms / 1e9:.1f} TFLOP/s, {nbytes / ms / 1e6:.0f} GB/s")
    if err > tol:
        raise RuntimeError(f"{label} {dtype}: kernel disagrees with its plain "
                           f"version ({err} > {tol})")
    for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound),
                   ("ops_ms", t_ops), ("bytes_ms", t_bytes),
                   ("library_ms", lib_ms), ("kernel_alone_ms", dev_ms)):
        if v is None:
            tot[key] = None
        elif tot.get(key, 0.0) is not None:
            tot[key] = tot.get(key, 0.0) + n * v
    tot["max_abs"] = max(tot.get("max_abs", 0.0), err)


# the unit's kernels by part (bf16)
UNIT_PARTS = ("spade_unit_gb", "spade_unit_conv", "instance_stats")


def _check_stats(tot, label, args, shape):
    """The one-pass statistics against instance_stats: mu within 1e-4 of the
    channel's std, rsig within 1e-4 relative (the kernel sums per thread in
    f32 about a shift and merges in f64, the plain version takes
    torch.var_mean in f32). Times beside the bound (bytes:
    x and the noise read once)."""
    from hrviton_tpu_torch.ops import spade_fused as sf
    mu, rsig = sf.norm_stats(*args)
    torch.cuda.synchronize()
    mu0, rsig0 = sf.instance_stats(*args)
    err_mu = ((mu - mu0).abs() * rsig0).max().item()
    err_rs = ((rsig - rsig0).abs() / rsig0).max().item()
    ok = err_mu <= 1e-4 and err_rs <= 1e-4 and bool(
        torch.isfinite(mu).all() and torch.isfinite(rsig).all())
    ms = _events_ms(lambda: sf.norm_stats(*args), 3)
    plain_ms = _events_ms(lambda: sf.instance_stats(*args), 3)
    alone = _device_ms(lambda: sf.norm_stats(*args), "instance_stats")
    b, h, w, c = shape
    bound = sf.stats_bytes(b, h, w, c,
                           elem=args[0].element_size()) / PEAK_BYTES * 1e3
    log(f"{label}: mu err {err_mu:.2e} (of the std), rsig err {err_rs:.2e} "
        f"(relative) {'ok' if ok else 'FAIL'} | wrapper {ms:.3f} ms, kernel "
        f"alone " + ("not measured" if alone is None else f"{alone:.3f} ms")
        + f", plain {plain_ms:.3f} ms, bound {bound:.4f} ms (bytes)")
    if not ok:
        raise RuntimeError(f"{label}: the statistics disagree with instance_stats")
    for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound),
                   ("kernel_alone_ms", alone)):
        if v is None or tot.get(key, 0.0) is None:
            tot[key] = None
        else:
            tot[key] = tot.get(key, 0.0) + v
    tot.update(ops_ms=0.0, bytes_ms=tot["bound_ms"], library_ms=None,
               max_abs=max(tot.get("max_abs", 0.0),
                           (rsig - rsig0).abs().max().item()))


def _alone_events(tot, label, n, launch):
    """The kernel alone by CUDA events around its bare C entry point
    (``launch``: operands checked, statistics computed and weights packed
    beforehand), beside the profiler's time, whose windows lose records now
    and then; ``n`` launches' worth into the totals."""
    ms = _events_ms(launch, 10)
    tot["events_alone_ms"] = tot.get("events_alone_ms", 0.0) + n * ms
    log(f"{label}: kernel alone by CUDA events {ms:.3f} ms")


def alone_phase():
    """The engine's model kernels timed by CUDA events at each main-path
    shape, batch 4, bf16, summed over one request's launches; no result is
    checked. The modulation and the small conv alone, around their bare
    entry points (statistics computed and weights packed beforehand); the
    unit and the wide conv through their wrappers (weights packed once).
    Then the tools' product-shift kernels around their bare entry points at
    TOOLS_X, TH 8 and 16 (weights packed beforehand), and the probe at
    PROBE_TH, in turns with F.conv2d and Tensor.copy_, and conv_band and
    conv_dma at TH=8 in clusters of 1, 2 and 4 (band_variants)."""
    from hrviton_tpu_torch.ops import conv3x3 as c3
    from hrviton_tpu_torch.ops import spade_block as sb
    from hrviton_tpu_torch.ops import spade_fused as sf
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    sums = {}

    def timed(key, label, n, fn):
        ms = _events_ms(fn, 10)
        sums[key] = sums.get(key, 0.0) + n * ms
        log(f"alone {key} {label}: {ms:.3f} ms")
    for name, h, w, c, cout, ks, act, residual in UNITS:
        args, res = _unit_inputs(gen, bf, h, w, c, cout, ks, residual)
        timed("spade_unit (wrapper)", name, 1,
              lambda: sb.spade_conv_unit(act, *args, res))
    for name, h, w, c, n in MODULATE_SITES:
        args = _unit_inputs(gen, bf, h, w, c, 8, 1, False)[0][:8]
        timed("spade_modulate", f"{name} (CT, NTILES) {sf.gb_tiles(c)}", n,
              sf.modulate_launcher(*args)[0])
    del args, res
    for key, sites in (("conv3x3_wide (wrapper)", WIDE_SITES),
                       ("conv3x3_small", SMALL_SITES)):
        for name, h, w, cin, cout, act, n in sites:
            x = _randn(gen, B, h, w, cin).to(bf)
            wt = _randn(gen, cout, cin, 3, 3, scale=(1.0 / (9 * cin)) ** 0.5)
            bias = _randn(gen, cout, scale=0.1)
            fn = (c3.small_launcher(x, wt, bias, act)[0] if key == "conv3x3_small"
                  else lambda: c3.conv3x3_wide(x, wt, bias, act))
            timed(key, name, n, fn)
    log("alone, one request's launches: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in sums.items()))
    from hrviton_tpu_torch.tools import _common
    x = _randn(gen, *TOOLS_X).to(bf)
    wt = _randn(gen, 3, 3, TOOLS_X[-1], TOOLS_X[-1], scale=0.1).to(bf)
    # in turns (forward, then backward), beside the library conv: the card
    # slows as it heats, so a fixed order would favour the first
    launches = {f"{key} TH={th}": _common.conv_launcher(
        f"{key}_forward_bf16", x, wt, th,
        getattr(_common, TAP_ORDER.get(key, "pack_taps")))[0]
        for key in SHIFT_KINDS for th in (8, 16)}
    xa = x.permute(0, 3, 1, 2)
    wl = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    launches["library F.conv2d"] = lambda: F.conv2d(xa, wl, None, 1, 1)
    from hrviton_tpu_torch.tools import exp_copy_probe
    out = torch.empty_like(x)
    launches[f"copy_probe TH={PROBE_TH}"] = exp_copy_probe.probe_launcher(x, PROBE_TH)[0]
    launches["library Tensor.copy_"] = lambda: out.copy_(x)
    times = {k: [] for k in launches}
    for keys in (list(launches), list(launches)[::-1]):
        for k in keys:
            times[k].append(_events_ms(launches[k], 10))
    for k, ms in times.items():
        log(f"alone {k} {TOOLS_X}: " + ", ".join(f"{t:.3f}" for t in ms)
            + f" ms, best {min(ms):.3f}")
    del launches, out
    band_variants(x, wt)


class _Clocks:
    """nvidia-smi's SM clock, power draw and temperature sampled every 250 ms
    while the block runs (the card slows its clock at its power limit under
    sustained load); summarised on exit, the sampler stopped."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader,nounits", "-lms", "250"],
            stdout=subprocess.PIPE, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        rows = []
        for line in self.proc.communicate(timeout=60)[0].splitlines():
            try:
                vals = [float(v) for v in line.split(",")]
            except ValueError:          # a field the card does not report
                continue
            if len(vals) == 3:
                rows.append(vals)
        if rows:
            clk, watts, temp = zip(*rows)
            log(f"clocks over {len(rows)} samples: SM {min(clk):.0f}-{max(clk):.0f} "
                f"MHz (median {sorted(clk)[len(clk) // 2]:.0f}), power draw up to "
                f"{max(watts):.1f} W, up to {max(temp):.0f} C")
        return False


def band_variants(x, wt, rounds=2):
    """conv_band (taps unrolled) and conv_dma (taps in a loop) alone at TH=8
    by CUDA events around the bare entry point, in clusters of 1, 2 and 4
    blocks, in turns (1, 2, 4, 4, 2, 1 per round, the two kernels one after
    the other at each, conv_halo's kernel, the same block, beside them), the
    card's clocks and power sampled: the variants the shipped cluster was
    chosen from, and the tap loop against the unrolled taps. Each variant's
    output is then held to the plain version (2 bf16 ulps of max|ref|).
    Returns {(key, cluster): [ms]}."""
    from hrviton_tpu_torch.tools import _common, exp_conv
    clusters = (1, 2, 4)
    for cl in clusters:
        log(f"band variants: the card holds {_common.band_active_clusters(cl)} "
            f"clusters of {cl} conv_band blocks at TH=8 at once")
    launchers = {(key, cl): _common.conv_launcher(f"{key}_forward_bf16", x, wt,
                                                  8, cluster=cl)
                 for key in BAND_KIND for cl in clusters}
    launches = {k: v[0] for k, v in launchers.items()}
    launches["conv_halo", None] = _common.conv_launcher(
        "conv_halo_forward_bf16", x, wt, 8)[0]
    times = {k: [] for k in launches}
    with _Clocks():
        for _ in range(rounds):
            for cl in clusters + clusters[::-1]:
                for key in BAND_KIND:
                    times[key, cl].append(_events_ms(launches[key, cl], 10))
                times["conv_halo", None].append(_events_ms(launches["conv_halo", None], 10))
    shipped = _common.band_cluster(8)
    for (key, cl), ms in times.items():
        label = "" if cl is None else \
            f" cluster {cl}{' (shipped)' if cl == shipped else ''}"
        log(f"alone {key} TH=8{label} {TOOLS_X}: " + ", ".join(f"{t:.3f}" for t in ms)
            + f" ms, best {min(ms):.3f}, median {sorted(ms)[len(ms) // 2]:.3f}")
    for cl in clusters:
        band, dma = min(times["conv_band", cl]), min(times["conv_dma", cl])
        log(f"band variants, cluster {cl}: the tap loop (conv_dma) "
            f"{100 * (dma - band) / band:+.1f}% against the unrolled taps "
            f"(conv_band), best of each")
    torch.cuda.synchronize()
    ref = exp_conv.conv_band_ref(x, wt, 8).float()
    tol = 2 * 2 ** -7 * ref.abs().max().item()
    for (key, cl), (_, out) in launchers.items():
        err = (out.float() - ref).abs().max().item()
        if not err <= tol:
            raise RuntimeError(f"{key} in clusters of {cl}: max_abs {err} > {tol}")
    log(f"band variants: every output within {tol:.3e} of the plain version")
    return times


def _sass_functions(src, names):
    """(kernel name, mangled name, SASS) of every function of csrc/<src>.cu's
    library (cuobjdump -sass) whose name contains one of ``names``; raises
    if one of them has none."""
    from hrviton_tpu_torch.ops import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(_build.build(src))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    found = []
    for func in re.split(r"\n\s*Function : ", text)[1:]:
        fname = func.split("\n", 1)[0].strip()
        hit = next((n for n in names if n in fname), None)
        if hit is not None:
            found.append((hit, fname, func))
    missing = set(names) - {hit for hit, _, _ in found}
    if missing:
        raise RuntimeError(f"{src}.cu: no SASS of {sorted(missing)}")
    return found


def sass_phase():
    """Every instantiation of the kernels on wgmma (the conv engine's and
    conv_tma.cu's): its SASS (cuobjdump -sass of the built library) must hold
    HGMMA (wgmma) and no HMMA (mma.sync); conv_band's and conv_dma's in a
    cluster of 2 or 4 the multicast TMA load too, and in a cluster of 1
    none. The probe's: the TMA load and store, and no STG."""
    for src, names in TMA_COPY_KERNELS.items():
        for hit, fname, func in _sass_functions(src, names):
            counts = {op: len(re.findall(rf"\b{op}\b", func))
                      for op in ("UTMALDG", "UTMASTG", "STG")}
            log(f"sass {hit}: " + ", ".join(f"{k} x{v}" for k, v in counts.items()))
            if not counts["UTMALDG"] or not counts["UTMASTG"] or counts["STG"]:
                raise RuntimeError(f"{fname}: not TMA in both directions: {counts}")
    for src, names in WGMMA_KERNELS.items():
        seen = {n: 0 for n in names}
        for hit, fname, func in _sass_functions(src, names):
            seen[hit] += 1
            hgmma = len(re.findall(r"\bHGMMA\b", func))
            hmma = len(re.findall(r"\bHMMA\b", func))
            if hgmma == 0 or hmma:
                raise RuntimeError(f"{fname}: {hgmma} HGMMA, {hmma} HMMA")
            band = BAND_ARGS.search(fname)
            if band:
                cl, casts = int(band.group(3)), len(MULTICAST.findall(func))
                log(f"sass {hit} (TR, TC, CL) {band.groups()}: {hgmma} HGMMA, "
                    f"{casts} multicast loads ({MULTICAST.pattern})")
                if (cl > 1) != (casts > 0):
                    raise RuntimeError(f"{fname}: a cluster of {cl} with "
                                       f"{casts} multicast loads")
        log(f"sass {src}.cu: " + ", ".join(f"{n} x{k}" for n, k in seen.items())
            + ": HGMMA in each, no HMMA")


def kernel_phase():
    """Every kernel vs its plain version at each main-path shape. Tolerances:
    f32 (TF32 off in the plain version) 1e-4 x max|ref|, for f32 sums of
    9*128 or more products in another order; bf16 2 ulps of max|ref| (2 *
    2^-7 * max|ref|), since each plain version rounds the same intermediates
    to bf16 as its kernel and a sum in another order flips single roundings.
    Returns {kernel name: {dtype: totals over one request's launches}}."""
    from hrviton_tpu_torch.ops import conv3x3 as c3
    from hrviton_tpu_torch.ops import spade_block as sb
    from hrviton_tpu_torch.ops import spade_fused as sf
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    totals = {name: {} for name in FIRST_PATH}
    for dtype in (torch.bfloat16, torch.float32):
        elem = torch.empty(0, dtype=dtype).element_size()

        tot = totals["spade_unit"][dtype] = {}
        stats = totals["instance_stats"][dtype] = {}
        split = {}
        for name, h, w, c, cout, ks, act, residual in UNITS:
            args, res = _unit_inputs(gen, dtype, h, w, c, cout, ks, residual)
            unit = lambda: sb.spade_conv_unit(act, *args, res)
            _check_site(
                tot, f"unit {name}", dtype, 1, unit,
                lambda: sb.spade_conv_ref(*args, pre_act=act, residual=res),
                None, ("spade_unit", "instance_stats"),
                sb.unit_flops(B, h, w, c, cout, ks),
                sb.unit_bytes(B, h, w, c, cout, ks, elem=elem,
                              residual=residual))
            if dtype == torch.bfloat16:
                parts = _device_split(unit, UNIT_PARTS)
                log(f"unit {name}: alone by part " + ", ".join(
                    f"{k} {v:.3f} ms" for k, v in parts.items())
                    + f" (gamma|beta tiles {sb.gb_tiles(c)}, consumer tiles "
                    f"{sb.conv_tiles(cout)})")
                for k, v in parts.items():
                    split[k] = split.get(k, 0.0) + v
                _check_stats(stats, f"instance_stats {name}", args[:3],
                             (B, h, w, c))
            del args, res
        if dtype == torch.bfloat16:
            tot["split"] = split
            b, h, w, c, cout, ks, act, residual = UNIT_RAGGED
            args, res = _unit_inputs(gen, dtype, h, w, c, cout, ks, residual,
                                     batch=b)
            _hold(f"unit ragged {UNIT_RAGGED}", sb.spade_conv_unit,
                  lambda: sb.spade_conv_unit(act, *args, res),
                  lambda: sb.spade_conv_ref(*args, pre_act=act, residual=res),
                  False)
            del args, res

        tot = totals["spade_modulate"][dtype] = {}
        for name, h, w, c, n in MODULATE_SITES:
            args, _ = _unit_inputs(gen, dtype, h, w, c, 8, 1, False)
            args = args[:8]
            if dtype == torch.bfloat16:
                # the wrapper's plain-torch part beside the kernel: the stats
                stats_ms = _events_ms(lambda: sf.norm_stats(*args[:3]), 3)
                tot["stats_ms"] = tot.get("stats_ms", 0.0) + n * stats_ms
                log(f"modulate {name}: the statistics (norm_stats) alone "
                    f"{stats_ms:.3f} ms")
            _check_site(
                tot, f"modulate {name}", dtype, n,
                lambda: sf.fused_spade_modulate(*args),
                lambda: sf.modulate_ref(*args), None,
                "spade_modulate_kernel" if dtype == torch.bfloat16
                else "spade_modulate_f32_kernel",
                sf.modulate_flops(B, h, w, c),
                sf.modulate_bytes(B, h, w, c, elem=elem))
            if dtype == torch.bfloat16:
                _alone_events(tot, f"modulate {name}", n,
                              sf.modulate_launcher(*args)[0])
                # cuDNN on the gamma|beta product alone: not the same function
                # (no modulation, gamma and beta to device memory)
                a = F.relu(args[3]).permute(0, 3, 1, 2)
                wgb = torch.cat([args[4], args[6]]).to(dtype).contiguous(
                    memory_format=torch.channels_last)
                cudnn_ms = _events_ms(lambda: F.conv2d(a, wgb, None, 1, 1), 3)
                tot["cudnn_gb_ms"] = tot.get("cudnn_gb_ms", 0.0) + n * cudnn_ms
                log(f"modulate {name}: cuDNN's gamma|beta product alone (F.conv2d "
                    f"of relu(actv) with [wg; wb], not the same function) "
                    f"{cudnn_ms:.3f} ms; N tiles (CT, NTILES) {sf.gb_tiles(c)}")
                del a, wgb
            del args
        if dtype == torch.bfloat16:
            b, h, w, c = MODULATE_RAGGED
            args = _unit_inputs(gen, dtype, h, w, c, 8, 1, False, batch=b)[0][:8]
            _hold(f"modulate ragged {MODULATE_RAGGED}", sf.fused_spade_modulate,
                  lambda: sf.fused_spade_modulate(*args),
                  lambda: sf.modulate_ref(*args), False)
            del args

        for key, sites, run, fused_bias, kname in (
                ("conv3x3_wide", WIDE_SITES, c3.conv3x3_wide, True,
                 "conv3x3_wide_kernel"),
                ("conv3x3_small", SMALL_SITES, c3.conv3x3_small, False,
                 "conv3x3_small_kernel")):
            tot = totals[key][dtype] = {}
            for name, h, w, cin, cout, act, n in sites:
                x = _randn(gen, B, h, w, cin).to(dtype)
                wt = _randn(gen, cout, cin, 3, 3, scale=(1.0 / (9 * cin)) ** 0.5)
                bias = _randn(gen, cout, scale=0.1)
                # the library call: one F.conv2d on the activated input with
                # the bias, channels_last, in the working dtype
                xa = c3.activation(x, act).permute(0, 3, 1, 2)
                wl = wt.to(dtype).contiguous(memory_format=torch.channels_last)
                bl = bias.to(dtype)
                _check_site(
                    tot, f"{key} {name} {cin}->{cout} {h}x{w}", dtype, n,
                    lambda: run(x, wt, bias, act),
                    lambda: c3.conv3x3_ref(x, wt, bias, act,
                                           fused_bias=fused_bias),
                    lambda: F.conv2d(xa, wl, bl, 1, 1),
                    kname if dtype == torch.bfloat16 else "conv3x3_f32_kernel",
                    c3.conv_flops(B, h, w, cin, cout),
                    c3.conv_bytes(B, h, w, cin, cout, elem=elem))
                if key == "conv3x3_wide" and dtype == torch.bfloat16:
                    log(f"{key} {name}: N tile {c3.wide_bn(x.shape, cout)}")
                if key == "conv3x3_small" and dtype == torch.bfloat16:
                    _alone_events(tot, f"{key} {name}", n,
                                  c3.small_launcher(x, wt, bias, act)[0])
                    log(f"{key} {name}: N tiles {c3.small_tiles(cout)}, "
                        + (f"narrow input, boxes of {c3.narrow_box(cin)} elements"
                           if cin % 8 else "16-channel boxes"))
                del x, xa
            if key == "conv3x3_wide" and dtype == torch.bfloat16:
                b, h, w, cin, cout, act = WIDE_RAGGED
                x = _randn(gen, b, h, w, cin).to(dtype)
                wt = _randn(gen, cout, cin, 3, 3, scale=(1.0 / (9 * cin)) ** 0.5)
                bias = _randn(gen, cout, scale=0.1)
                _hold(f"{key} ragged {WIDE_RAGGED}", run,
                      lambda: run(x, wt, bias, act),
                      lambda: c3.conv3x3_ref(x, wt, bias, act, fused_bias=True),
                      False)
                del x
            if key == "conv3x3_small" and dtype == torch.bfloat16:
                for b, h, w, cin, cout, act in SMALL_RAGGED:
                    x = _randn(gen, b, h, w, cin).to(dtype)
                    wt = _randn(gen, cout, cin, 3, 3, scale=(1.0 / (9 * cin)) ** 0.5)
                    bias = _randn(gen, cout, scale=0.1)
                    _hold(f"{key} ragged {(b, h, w, cin, cout, act)}", run,
                          lambda: run(x, wt, bias, act),
                          lambda: c3.conv3x3_ref(x, wt, bias, act), False)
                    del x
        for key in totals:
            t = totals[key][dtype]
            if not t:
                continue
            fmt = lambda v: "not measured" if v is None else f"{v:.3f} ms"
            log(f"{key}, one request's launches, batch {B}, {str(dtype)[6:]}: "
                f"wrapper {t['ms']:.3f} ms, kernel alone "
                f"{fmt(t['kernel_alone_ms'])}, plain {t['plain_ms']:.3f} ms, "
                f"library {fmt(t['library_ms'])}, bound {t['bound_ms']:.4f} ms"
                + (f", of the wrapper: the statistics {t['stats_ms']:.3f} ms"
                   if "stats_ms" in t else "")
                + (f", alone by CUDA events around the bare entry point "
                   f"{t['events_alone_ms']:.3f} ms" if "events_alone_ms" in t else "")
                + (f", cuDNN's gamma|beta product alone {t['cudnn_gb_ms']:.3f} ms"
                   if "cudnn_gb_ms" in t else "")
                + (", alone by part " + ", ".join(
                    f"{k} {v:.3f} ms" for k, v in t["split"].items())
                   if "split" in t else ""))
            if key in EARLIER_MODEL and dtype == torch.bfloat16:
                was = EARLIER_MODEL[key]
                log(f"{key}: on the TMA / wgmma engine wrapper {t['ms']:.3f} ms, "
                    f"kernels alone {fmt(t['kernel_alone_ms'])}"
                    + (f" (events {t['events_alone_ms']:.3f} ms)"
                       if "events_alone_ms" in t else "")
                    + f"; the earlier design {was[0]:.2f} ms, kernel alone "
                    f"{was[1]:.2f} ms (PERF.md)")
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
    if "instance_stats" in name:
        return "instance statistics (one-pass kernel)"
    if "spade_modulate" in name:
        return "fused modulation (spade_modulate kernels)"
    if "conv3x3_wide" in name or "conv3x3_small" in name or "conv3x3_f32" in name:
        return "3x3 conv kernels (conv3x3.cu)"
    low = name.lower()
    if any(k in low for k in ("conv", "xmma", "gemm", "cudnn", "sm90", "cutlass")):
        return "convolutions (cuDNN)"
    if "grid_sampler" in low or "upsample" in low or "interp" in low:
        return "resize / grid_sample"
    if "reduce" in low or "norm" in low or "welford" in low:
        return "reductions (stats, norms)"
    return "other elementwise / copies"


def profile_phase(tag, pipe, batch):
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
        log(f"{tag} profile: the profiler recorded no device time (not measured)")
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
    log(f"{tag} profile: one request {wall_us / 1e3:.1f} ms wall, device busy "
        f"{busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}%), {len(kernels)} "
        f"kernel launches")
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"{tag} profile:   {g}: {us / 1e3:.2f} ms ({100 * us / total:.1f}% "
            f"of device time)")


def _build_pipeline(tag, gen_cfg=None):
    from hrviton_tpu_torch import TryOnPipeline
    from hrviton_tpu_torch.models.spade import SPADENorm
    t0 = time.perf_counter()
    pipe = TryOnPipeline(gen_cfg=gen_cfg, device="cuda", dtype=torch.bfloat16,
                         seed=0)
    # noise_scale initialises to zero; random values make the noise path count
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for m in pipe.generator.modules():
            if isinstance(m, SPADENorm):
                m.noise_scale.copy_(torch.randn(m.noise_scale.shape,
                                                generator=g) * 0.1)
    log(f"{tag}: TryOnPipeline built in {time.perf_counter() - t0:.2f} s "
        f"({sum(p.numel() for p in pipe.generator.parameters()) / 1e6:.1f}M "
        f"generator, {sum(p.numel() for p in pipe.tocg.parameters()) / 1e6:.1f}M "
        f"tocg parameters)")
    return pipe


def _request(pipe, batch):
    """One timed request: (seconds, rgb, launches of each kernel in it)."""
    wrappers = _wrappers()
    before = {k: w.launches for k, w in wrappers.items()}
    torch.cuda.synchronize()
    t = time.perf_counter()
    rgb, _ = pipe(batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    return seconds, rgb, {k: w.launches - before[k] for k, w in wrappers.items()}


def _serve(tag, pipe, batches, expect):
    """Answer the requests; each must launch exactly ``expect`` and give a
    finite rgb of the right shape in [-1, 1]. The launch counts are set to 0
    just before and read just after. Returns (times, outputs, counts)."""
    fh, fw = pipe.cfg.fine_height, pipe.cfg.fine_width
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    expect = {k: v for k, v in expect.items() if k in wrappers}
    times, outs = [], []
    for i, batch in enumerate(batches):
        seconds, rgb, n = _request(pipe, batch)
        if n != expect:
            raise RuntimeError(f"{tag} request {i}: launches {n}, expected {expect}")
        if tuple(rgb.shape) != (B, fh, fw, 3):
            raise RuntimeError(f"rgb shape {tuple(rgb.shape)}")
        if not torch.isfinite(rgb).all() or rgb.abs().max().item() > 1.0:
            raise RuntimeError("rgb not finite or outside [-1, 1]")
        times.append(seconds)
        outs.append(rgb)
        log(f"{tag} request {i}: {seconds * 1e3:.1f} ms, launches {n}, rgb mean "
            f"{rgb.float().mean().item():.4f} std {rgb.float().std().item():.4f}")
    return times, outs, {k: w.launches for k, w in wrappers.items()}


def _compare(tag, got, want):
    """The kernel pipeline's rgb against the same pipeline on the library
    path, bf16: both round the same intermediates to bf16 (relative step
    2^-8); sums in another order flip single roundings, which conv_img and
    tanh carry to the rgb. Limits: max 5% of max|rgb|, mean 1% of mean|rgb|
    of the library path's output."""
    d = (got.float() - want.float()).abs()
    ref = want.float().abs()
    lim_max, lim_mean = 0.05 * ref.max().item(), 0.01 * ref.mean().item()
    log(f"{tag} (bf16): max_abs {d.max().item():.4e} mean_abs "
        f"{d.mean().item():.4e} (limits {lim_max:.3e} / {lim_mean:.3e})")
    if d.max().item() > lim_max or d.mean().item() > lim_mean:
        raise RuntimeError(f"{tag}: the two pipelines disagree")


def first_path_phase(card):
    """The default configuration: the fused unit at up_3 and up_4."""
    torch.backends.cudnn.benchmark = True
    pipe = _build_pipeline("first path")
    fh, fw = pipe.cfg.fine_height, pipe.cfg.fine_width
    batches = [_synthetic_batch(fh, fw, seed) for seed in range(N_REQUESTS)]
    times, outs, counts = _serve("first path", pipe, batches, FIRST_PATH)

    # the first request against the same pipeline with the fused gate off;
    # the second gate-off run is timed (the first one tunes cuDNN's convs)
    pipe.generator.set_fused(False)
    _, rgb_plain, n = _request(pipe, batches[0])
    unfused_s, _, n2 = _request(pipe, batches[1])
    pipe.generator.set_fused(True)
    if any(n.values()) or any(n2.values()):
        raise RuntimeError("the unfused pipeline launched a kernel")
    _compare("first path, fused vs unfused pipeline", outs[0], rgb_plain)
    profile_phase("first path", pipe, batches[2])
    steady = sum(times[1:]) / len(times[1:])
    log(f"first path: {steady * 1e3:.1f} ms/request (batch {B}, steady, "
        f"requests 2-{N_REQUESTS}), {B / steady:.2f} img/s, first request "
        f"{times[0] * 1e3:.1f} ms; fused gate off: {unfused_s * 1e3:.1f} "
        f"ms/request | {card}")
    return counts


def _layout_copies(pipe, batch):
    """The NHWC copies of x and actv that models/spade.py makes before each
    fused modulation (_nhwc), in one request: each call timed by CUDA events
    on the stream around it; a call whose input is already NHWC in memory
    makes no copy. Informational (a part of the profile's elementwise
    work)."""
    from hrviton_tpu_torch.models import spade as ms
    orig, spans = ms._nhwc, []

    def timed(t):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = orig(t)
        e1.record()
        spans.append((e0, e1, out.data_ptr() != t.data_ptr()))
        return out
    ms._nhwc = timed
    try:
        pipe(batch)
        torch.cuda.synchronize()
    finally:
        ms._nhwc = orig
    total = sum(e0.elapsed_time(e1) for e0, e1, _ in spans)
    log(f"second path: the modulation's layout copies (_nhwc of x and actv): "
        f"{len(spans)} calls, {sum(c for *_, c in spans)} copies, {total:.3f} ms "
        f"per request")


def second_path_phase(card):
    """The generator's dispatch knobs on: fused modulation, wide and
    small-channel 3x3 conv kernels; the fused unit off."""
    from hrviton_tpu_torch import SPADEGenConfig
    from hrviton_tpu_torch.ops import conv3x3 as c3
    from hrviton_tpu_torch.ops import spade_fused as sf
    on_cfg = SPADEGenConfig(ngf=64, num_upsampling_layers="most",
                            fused_block=False, fast_spade=True, fast_conv=True)
    off_cfg = dataclasses.replace(on_cfg, fast_spade=False, fast_conv=False)
    pipe = _build_pipeline("second path", on_cfg)
    fh, fw = pipe.cfg.fine_height, pipe.cfg.fine_width
    batches = [_synthetic_batch(fh, fw, seed) for seed in range(N_REQUESTS)]
    present = _wrappers()
    expect_on = {k: v for k, v in SECOND_PATH.items() if k in present}
    no_launch = dict.fromkeys(expect_on, 0)

    def knobs(on):
        pipe.generator.cfg = on_cfg if on else off_cfg
        c3._VIEWS = on

    views_before = c3._VIEWS
    try:
        knobs(True)
        times, outs, counts = _serve("second path", pipe, batches, SECOND_PATH)
        if c3.fast_conv_enabled() or sf.fast_spade_enabled():
            raise RuntimeError("a generator left its dispatch switch on")
        # knobs off: the same pipeline on the library path. The first run
        # tunes cuDNN's convs; then off, on, on, off are timed in turns.
        knobs(False)
        _, rgb_plain, n = _request(pipe, batches[0])
        if n != no_launch:
            raise RuntimeError(f"the knobs-off pipeline launched a kernel: {n}")
        _compare("second path, knobs on vs off", outs[0], rgb_plain)
        turns = {True: [], False: []}
        for on in (False, True, True, False):
            knobs(on)
            seconds, _, n = _request(pipe, batches[1])
            if n != (expect_on if on else no_launch):
                raise RuntimeError(f"knobs {'on' if on else 'off'}: launches {n}")
            turns[on].append(seconds * 1e3)
        knobs(True)
        profile_phase("second path", pipe, batches[2])
        _layout_copies(pipe, batches[2])
    finally:
        c3._VIEWS = views_before
    steady = sum(times[1:]) / len(times[1:])
    log(f"second path: {steady * 1e3:.1f} ms/request (batch {B}, steady, "
        f"requests 2-{N_REQUESTS}), {B / steady:.2f} img/s, first request "
        f"{times[0] * 1e3:.1f} ms; in turns, knobs on "
        f"{', '.join(f'{t:.1f}' for t in turns[True])} ms, knobs off "
        f"{', '.join(f'{t:.1f}' for t in turns[False])} ms | {card}")
    return counts


CLI_TIMED = 25              # compact batches timed per dtype, after a warm-up
CLI_CHECKED = 3             # of them, compared with TryOnPipeline


def _compact_batch(h, w, seed):
    """One loader batch of the CLI (batch 1) in the wire format of
    VitonHDDataset(compact=True), made with numpy from ``seed``: uint8
    images, 0/1 cloth masks, 13-group label maps in blocks of 16x16 pixels,
    nested paired/unpaired cloth, and the name lists."""
    import numpy as np
    rng = np.random.default_rng(seed)
    u8 = lambda: rng.integers(0, 256, (1, h, w, 3), dtype=np.uint8)

    def labels():
        small = rng.integers(0, 13, (1, h // 16, w // 16), dtype=np.uint8)
        return small.repeat(16, axis=1).repeat(16, axis=2)

    def mask():
        m = np.zeros((1, h, w, 1), np.uint8)
        m[:, h // 5:h // 2, w // 4:3 * w // 4] = 1
        return m
    names = [f"{seed:05d}_00.jpg"], [f"{seed + 1:05d}_00.jpg"]
    return {"c_name": {"paired": names[0], "unpaired": names[1]},
            "im_name": names[0],
            "cloth": {"paired": u8(), "unpaired": u8()},
            "cloth_mask": {"paired": mask(), "unpaired": mask()},
            "parse_idx": labels(), "parse_agnostic_idx": labels(),
            "densepose": u8(), "pose": u8(), "image": u8(), "agnostic": u8()}


def _reference_inputs(raw, dtype):
    """The pipeline's inputs built from a raw compact batch with numpy, apart
    from the port's data path: the unpaired cloth and mask, u8 * (2/255) - 1
    in f32, the 13-way one-hot of the agnostic parse; on the card in
    ``dtype``."""
    import numpy as np
    img = lambda u8: u8.astype(np.float32) * np.float32(2 / 255) - np.float32(1)
    arrays = {"cloth": img(raw["cloth"]["unpaired"]),
              "cloth_mask": raw["cloth_mask"]["unpaired"].astype(np.float32),
              "parse_agnostic": np.eye(13, dtype=np.float32)[
                  raw["parse_agnostic_idx"]],
              "densepose": img(raw["densepose"]),
              "agnostic": img(raw["agnostic"])}
    return {k: torch.from_numpy(v).to("cuda").to(dtype)
            for k, v in arrays.items()}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _tf32(cudnn, matmul):
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul


def _guard_off():
    """A context in which the port's TF32 guard (core/precision.no_tf32,
    which every library conv and matmul of an f32 forward is issued under)
    changes nothing: what a forward gives with TF32 on, the checks' teeth."""
    import contextlib
    from unittest import mock
    from hrviton_tpu_torch.core import precision
    return mock.patch.object(precision, "no_tf32", contextlib.nullcontext)


def _within(label, got, want, dtype):
    """got against want: f32 1e-4 x max|want|, bf16 2 ulps of max|want|."""
    scale = want.float().abs().max().item()
    tol = (1e-4 if dtype == torch.float32 else 2 * 2 ** -7) * scale
    err = (got.float() - want.float()).abs().max().item()
    log(f"{label}: max_abs {err:.3e} (tol {tol:.3e}) "
        f"{'ok' if err <= tol else 'FAIL'}")
    if got.shape != want.shape or err > tol:
        raise RuntimeError(f"{label}: disagree")


def _spread(ms):
    """median, quartiles, min and max of a list of times, as one string."""
    import statistics
    q1, med, q3 = statistics.quantiles(ms, n=4)
    return (f"median {med:.2f} ms (quartiles {q1:.2f}-{q3:.2f}, min "
            f"{min(ms):.2f}, max {max(ms):.2f}, n {len(ms)})")


def _cli_units(gen):
    """Kernel 1 at the CLI's batch 1, at the six unit shapes, in f32 (the
    FMA kernel, off every path: the gate takes bf16 only, so this is a
    direct call of the wrapper) and bf16 (the conv engine, on the CLI's
    --bf16 path), each unit against spade_conv_ref on the same inputs, TF32
    off. Returns {dtype: totals over one forward's six units}."""
    from hrviton_tpu_torch.ops import spade_block as sb
    totals = {}
    _tf32(False, False)
    for dtype in (torch.float32, torch.bfloat16):
        elem = torch.empty(0, dtype=dtype).element_size()
        tot = totals[dtype] = {}
        for name, h, w, c, cout, ks, act, residual in UNITS:
            args, res = _unit_inputs(gen, dtype, h, w, c, cout, ks, residual,
                                     batch=1)
            _check_site(
                tot, f"cli unit {name} batch 1", dtype, 1,
                lambda: sb.spade_conv_unit(act, *args, res),
                lambda: sb.spade_conv_ref(*args, pre_act=act, residual=res),
                None, ("spade_unit", "instance_stats"),
                sb.unit_flops(1, h, w, c, cout, ks),
                sb.unit_bytes(1, h, w, c, cout, ks, elem=elem,
                              residual=residual))
            del args, res
        fmt = lambda v: "not measured" if v is None else f"{v:.3f} ms"
        where = ("a direct call, off every path" if dtype == torch.float32
                 else "the CLI's --bf16 path")
        log(f"cli unit ({where}), one batch-1 forward's six units, "
            f"{str(dtype)[6:]}: "
            f"wrapper {tot['ms']:.3f} ms, kernel alone "
            f"{fmt(tot['kernel_alone_ms'])}, plain {tot['plain_ms']:.3f} ms, "
            f"bound {tot['bound_ms']:.4f} ms")
    torch.cuda.empty_cache()
    return totals


def cli_phase(card):
    """The inference CLI's path: its own configuration at full size, batch
    1, random weights from seed 0, f32 and --bf16 (module docstring, phase
    6). Returns ({dtype: kernel 1's totals at batch 1}, {dtype: launches of
    each kernel over the CLI's steps in that dtype})."""
    import warnings
    from hrviton_tpu_torch import TryOnPipeline
    from hrviton_tpu_torch.cli import test_generator as tg
    from hrviton_tpu_torch.core.precision import bf16_params
    from hrviton_tpu_torch.data.device import expand_compact, to_device
    from hrviton_tpu_torch.pipelines.tryon import tryon_forward
    from hrviton_tpu_torch.utils.vis import make_image_grid, to_uint8

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    base = ["--tocg_checkpoint", "", "--gen_checkpoint", "", "--device", "cuda"]
    opt = tg.get_opt(base)
    fh, fw = opt.fine_height, opt.fine_width
    raws, expand_ms = [], []
    for seed in range(1 + CLI_TIMED):
        raw = _compact_batch(fh, fw, seed)
        raw.pop("c_name")
        raw.pop("im_name")
        raws.append(raw)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        got = expand_compact(to_device(raw, "cuda"))
        e1.record()
        torch.cuda.synchronize()
        expand_ms.append(e0.elapsed_time(e1))
        want = dict(_leaves(expand_compact(to_device(raw, "cpu"))))
        for key, t in _leaves(got):
            w = want[key]
            if t.dtype != w.dtype or not torch.equal(t.cpu(), w):
                raise RuntimeError(f"expand_compact {key}: the card's result "
                                   f"differs from the CPU's")
    log(f"cli: expand_compact of {len(raws)} compact batches at {fh}x{fw} on "
        f"the card equals its CPU run bit for bit ({len(list(_leaves(got)))} "
        f"tensors each); the copy to the card and the expansion, batch 1, "
        f"CUDA events: {_spread(expand_ms[1:])} after the first "
        f"{expand_ms[0]:.2f} ms")

    wrappers = _wrappers()
    no_launch = dict.fromkeys(wrappers, 0)
    # the gates take bf16 only, as the JAX gates do: the f32 CLI launches
    # no kernel, --bf16 the first path's per forward
    expects = {torch.float32: no_launch,
               torch.bfloat16: {k: v for k, v in FIRST_PATH.items()
                                if k in wrappers}}
    grid_shape = (3 * (fh + 2) + 2, 4 * (fw + 2) + 2, 3)
    gen = torch.Generator(device="cuda").manual_seed(11)
    launches, ms_per_image = {}, {}
    try:
        units = _cli_units(gen)
        ref = TryOnPipeline(device="cuda", seed=opt.seed, noise_seed=opt.seed + 1)
        for bf16 in (False, True):
            dtype = torch.bfloat16 if bf16 else torch.float32
            tag = f"cli {'bf16' if bf16 else 'f32'}"
            pipe = tg.build_pipeline(tg.get_opt(base + (["--bf16"] if bf16
                                                        else [])))
            if bf16:
                bf16_params(ref.tocg)
                bf16_params(ref.generator)
                ref.dtype = torch.bfloat16
            _tf32(True, False)                  # torch's defaults, explicitly
            expect = expects[dtype]
            n_total = dict(no_launch)
            times, steps = [], []
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                for i, raw in enumerate(raws):
                    before = {k: w.launches for k, w in wrappers.items()}
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    step = tg.tryon_step(pipe, raw)
                    e1.record()
                    torch.cuda.synchronize()
                    n = {k: w.launches - before[k] for k, w in wrappers.items()}
                    for k in n:
                        n_total[k] += n[k]
                    if n != expect:
                        raise RuntimeError(f"{tag} batch {i}: launches {n}, "
                                           f"expected {expect}")
                    rgb = step.output
                    if rgb.dtype != dtype or tuple(rgb.shape) != (1, fh, fw, 3):
                        raise RuntimeError(f"{tag}: rgb {rgb.dtype} "
                                           f"{tuple(rgb.shape)}")
                    if not torch.isfinite(rgb).all() or rgb.abs().max().item() > 1.0:
                        raise RuntimeError(f"{tag}: rgb not finite or outside [-1, 1]")
                    times.append(e0.elapsed_time(e1))
                    if i < CLI_CHECKED:
                        steps.append(step)
                        log(f"{tag} batch {i}: {times[-1]:.1f} ms, launches "
                            f"{n}, rgb mean {rgb.float().mean().item():.4f} "
                            f"std {rgb.float().std().item():.4f}")
                    del step, rgb
            launches[dtype] = n_total
            tf32_warn = [str(w.message) for w in caught
                         if "tf32" in str(w.message).lower()
                         or "fp32_precision" in str(w.message)]
            log(f"{tag}: warnings about TF32 settings while it ran: "
                f"{tf32_warn or 'none'}")
            grid = make_image_grid(tg.grid_panels(steps[0], 0), nrow=4)
            u8 = to_uint8(steps[0].output.float().cpu())
            if grid.shape != grid_shape or u8.shape != (1, fh, fw, 3) or \
                    u8.dtype.name != "uint8":
                raise RuntimeError(f"{tag}: grid {grid.shape}, to_uint8 "
                                   f"{u8.shape} {u8.dtype}")
            for i, step in enumerate(steps):
                want, _ = ref(step.batch)
                _within(f"{tag} batch {i}: the CLI's step against "
                        f"TryOnPipeline on the same expanded batch",
                        step.output, want, dtype)
            # a reference apart from the port's data path and kernels: the
            # inputs built from the raw batch with numpy, the same weights
            # with the fused unit off (cuDNN's convs in its place)
            before = {k: w.launches for k, w in wrappers.items()}
            pipe.generator.set_fused(False)
            plain, _ = pipe(_reference_inputs(raws[0], dtype))
            pipe.generator.set_fused(True)
            if {k: w.launches - before[k] for k, w in wrappers.items()} != no_launch:
                raise RuntimeError(f"{tag}: the unfused pipeline launched a kernel")
            label = (f"{tag} batch 0: the CLI's step against the unfused "
                     f"pipeline on inputs built with numpy from the raw batch")
            if bf16:
                _compare(label, steps[0].output, plain)
            else:
                _within(label, steps[0].output, plain, dtype)
            if not bf16:
                # the same f32 request with TF32 off for the process; then
                # the same forward with TF32 on and the guard taken out
                _tf32(False, False)
                off = tg.tryon_step(pipe, raws[0]).output
                _within("cli f32: torch's default TF32 settings against TF32 "
                        "off", steps[0].output, off, dtype)
                _tf32(True, True)
                noise = torch.Generator(device=pipe.device).manual_seed(
                    pipe.noise_seed)
                with torch.inference_mode(), _guard_off():
                    on, _ = tryon_forward(
                        pipe.tocg, lambda x, seg: pipe.generator(x, seg, noise),
                        steps[0].batch, pipe.cfg)
                d = (on.float() - off.float()).abs()
                log(f"cli f32: a forward with TF32 on (the guard taken out) "
                    f"against TF32 off: max_abs {d.max().item():.3e} mean_abs "
                    f"{d.mean().item():.3e} (the limit above: "
                    f"{1e-4 * off.abs().max().item():.3e})")
                _tf32(True, False)
            profile_phase(tag, pipe, steps[-1].batch)
            ms_per_image[tag] = _spread(times[1:])
            log(f"{tag}: grid {grid.shape}, to_uint8 {u8.shape}; ms per image "
                f"(batch 1, CUDA events around tryon_step, after the first "
                f"batch, each batch from its own seed): {ms_per_image[tag]}; "
                f"first batch {times[0]:.1f} ms | {card}")
            del pipe, steps
            torch.cuda.empty_cache()
    finally:
        _tf32(*saved)
    for tag, s in ms_per_image.items():
        log(f"cli: {tag} ms per image {s} | {card}")
    return units, launches


REJ_PAIRS = 64              # pairs per split of phase 8's synthetic tree
REJ_BATCH = 8               # the rejection CLIs' default batch
REJ_HW = (256, 192)         # the CLIs' default fine size (the tocg's)


def _d_state_dict(d):
    """A CondMultiscaleDiscriminator's weights under the reference's D_*.pth
    key names (each sub-D a Sequential: convs at 0, 2, 5, 8, 11)."""
    sd = {}
    for i in range(d.cfg.num_d):
        sub = getattr(d, f"discriminator_{i}")
        for j, si in enumerate((0, 2, 5, 8, 11)):
            conv = getattr(sub, f"layer{j}_conv")
            sd[f"layer{i}.{si}.weight"] = conv.weight.detach().cpu()
            sd[f"layer{i}.{si}.bias"] = conv.bias.detach().cpu()
    return sd


def _scores_file(path):
    rows = [line.split() for line in open(path).read().splitlines()]
    return [r[0] for r in rows], [float(r[1]) for r in rows]


def _all_launches():
    return {**{k: w.launches for k, w in _wrappers().items()},
            **{k: w.launches for k, (w, _) in _tool_wrappers().items()}}


def rejection_phase(card):
    """The rejection and evaluation path at the CLIs' own configuration, f32
    (module docstring, phase 8)."""
    import statistics
    import tempfile
    import numpy as np
    from hrviton_tpu_torch.cli import common
    from hrviton_tpu_torch.cli import evaluate as ev
    from hrviton_tpu_torch.cli import get_norm_const as gnc
    from hrviton_tpu_torch.cli import test_condition as tc
    from hrviton_tpu_torch.config import CondDiscriminatorConfig
    from hrviton_tpu_torch.data.dataset import VitonHDDataset
    from hrviton_tpu_torch.data.loader import Loader
    from hrviton_tpu_torch.data.synthetic import make_synthetic_dataset
    from hrviton_tpu_torch.infer.rejection import d_logit, rejection_scores
    from hrviton_tpu_torch.losses.lpips import make_lpips
    from hrviton_tpu_torch.models.discriminators import \
        CondMultiscaleDiscriminator
    from hrviton_tpu_torch.models.inception import InceptionV3
    from hrviton_tpu_torch.nn.layers import init_weights
    from hrviton_tpu_torch.pipelines.tryon import compose_clothmask
    from PIL import Image

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    fh, fw = REJ_HW
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rejection_")
    before = _all_launches()
    try:
        t0 = time.perf_counter()
        root = make_synthetic_dataset(os.path.join(tmp, "data"), n=REJ_PAIRS,
                                      w=fw, h=fh, modes=("train", "test"))
        d = CondMultiscaleDiscriminator(CondDiscriminatorConfig(input_nc=33),
                                        device="cpu")
        init_weights(d, torch.Generator().manual_seed(5))
        d_pth = os.path.join(tmp, "D.pth")
        torch.save(_d_state_dict(d), d_pth)
        log(f"rejection: synthetic VITON-HD tree of {REJ_PAIRS} train and "
            f"{REJ_PAIRS} test pairs at {fh}x{fw} and a D.pth under the "
            f"reference's keys (33 channels, ndf 64, 3 layers, 2 scales, "
            f"random from seed 5) in {time.perf_counter() - t0:.1f} s")
        base = ["--dataroot", root, "--fine_height", str(fh), "--fine_width",
                str(fw), "-b", str(REJ_BATCH), "-j", "4", "--D_checkpoint",
                d_pth, "--device", "cuda"]
        train = base + ["--datamode", "train", "--data_list", "train_pairs.txt"]
        test = base + ["--datamode", "test", "--data_list", "test_pairs.txt"]

        _tf32(True, False)                  # torch's defaults, explicitly
        t0 = time.perf_counter()
        m = gnc.main(train)
        log(f"rejection: get_norm_const.main M = {m!r} in "
            f"{time.perf_counter() - t0:.1f} s")
        if not np.isfinite(m):
            raise RuntimeError(f"rejection: M = {m}")
        t0 = time.perf_counter()
        out = tc.main(test + ["--norm_const", repr(m), "--output_dir",
                              os.path.join(tmp, "default")])
        log(f"rejection: test_condition.main in {time.perf_counter() - t0:.1f} s")
        names, scores = _scores_file(os.path.join(out, "rejection_prob.txt"))
        grids = [n for n in os.listdir(out) if n.endswith(".png")]
        if len(names) != REJ_PAIRS or sorted(scores, reverse=True) != scores \
                or len(grids) != REJ_PAIRS or not np.isfinite(scores).all():
            raise RuntimeError(f"rejection_prob.txt: {len(names)} lines, "
                               f"sorted {sorted(scores, reverse=True) == scores}"
                               f", {len(grids)} grids")
        got = dict(zip(names, scores))
        gshape = np.asarray(Image.open(os.path.join(out, grids[0]))).shape
        if gshape != (3 * (fh + 2) + 2, 4 * (fw + 2) + 2, 3):
            raise RuntimeError(f"grid {gshape}")
        log(f"rejection: rejection_prob.txt {len(names)} lines in descending "
            f"order ({scores[0]:.6g} .. {scores[-1]:.6g}), {len(grids)} grids "
            f"{gshape}")

        # the same run with TF32 off for the process
        _tf32(False, False)
        out_off = tc.main(test + ["--norm_const", repr(m), "--output_dir",
                                  os.path.join(tmp, "off")])
        off = dict(zip(*_scores_file(os.path.join(out_off,
                                                  "rejection_prob.txt"))))
        _tf32(True, False)
        _within("rejection: scores under torch's default TF32 settings against "
                "TF32 off", torch.tensor([got[n] for n in names]),
                torch.tensor([off[n] for n in names]), torch.float32)

        # the first batch directly, and test_condition's step timed by CUDA
        # events on every batch
        opt = tc.get_opt(test + ["--norm_const", repr(m)])
        tocg = common.build_tocg(opt)
        dm = common.build_cond_discriminator(opt)
        loader = Loader(VitonHDDataset(common.data_cfg_from_args(opt),
                                       mode="test"),
                        REJ_BATCH, shuffle=False, drop_last=False,
                        num_workers=4)
        pred_dir = os.path.join(tmp, "pred")
        os.makedirs(pred_dir)
        step_ms, tocg_ms, d_ms = [], [], []

        def events_ms(fn):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn()
            e1.record()
            torch.cuda.synchronize()
            return out, e0.elapsed_time(e1)
        try:
            for b in range(REJ_PAIRS // REJ_BATCH):
                raw = loader.next_batch()
                input1, input2 = common.condition_inputs(raw, "paired", "cuda")
                def step():
                    out = tc.condition_step(tocg, dm, input1, input2)
                    return (*out, rejection_scores(out[-1], m))
                (seg, wc, wcm, logits, s), ms = events_ms(step)
                step_ms.append(ms)
                with torch.inference_mode():       # the step's two parts
                    _, ms = events_ms(lambda: tocg(input1, input2))
                    tocg_ms.append(ms)
                    xd = torch.cat([input1, input2, torch.softmax(seg, -1)], -1)
                    _, ms = events_ms(lambda: dm(xd))
                    d_ms.append(ms)
                cnames = raw["c_name"]["paired"]
                if b == 0:
                    with torch.inference_mode():
                        _, seg0, _, wcm0 = tocg(input1, input2)
                        seg0 = compose_clothmask(seg0, wcm0, "warp_grad")
                        x = torch.cat([input1, input2,
                                       torch.softmax(seg0, dim=-1)], dim=-1)
                        ref = rejection_scores(d_logit(dm(x)), m)
                        _within("rejection: the first batch's scores in "
                                "rejection_prob.txt against rejection_scores("
                                "d_logit(D(...)), M) on the card",
                                torch.tensor([got[n.replace('.jpg', '.png')]
                                              for n in cnames]),
                                torch.from_numpy(ref), torch.float32)
                        if not np.array_equal(s, ref):
                            log(f"rejection: the step's scores differ from the "
                                f"direct ones by {np.abs(s - ref).max():.3e}")
                        logit_off = dm(x)[-1][-1]
                        with _guard_off():
                            _tf32(True, True)
                            logit_on = dm(x)[-1][-1]
                            _tf32(True, False)
                        dd = (logit_on - logit_off).abs().max().item()
                        log(f"rejection: a discriminator forward with TF32 on "
                            f"(the guard taken out) against the default: "
                            f"max_abs {dd:.3e} (limit "
                            f"{1e-4 * logit_off.abs().max().item():.3e})")
                for i, n in enumerate(cnames):
                    img = ((wc[i].float().cpu().numpy() + 1) * 127.5).clip(0, 255)
                    Image.fromarray(img.astype(np.uint8)).save(os.path.join(
                        pred_dir, f"{n.split('.')[0]}_{raw['c_name']['unpaired'][i].split('.')[0]}.png"))
        finally:
            loader.close()
        log(f"rejection: test_condition's step (tocg + D + scores), batch "
            f"{REJ_BATCH} at {fh}x{fw}, f32, CUDA events: {_spread(step_ms[1:])}"
            f" per batch, first {step_ms[0]:.2f} ms; its parts alone: the "
            f"tocg {_spread(tocg_ms[1:])}, the discriminator "
            f"{_spread(d_ms[1:])} | {card}")

        # evaluation: LPIPS on the card against the CPU, its and Inception's
        # times, then evaluate.main on the tocg's warped cloth
        gt_dir = os.path.join(root, "test", "image")
        preds = sorted(os.listdir(pred_dir))
        lp_card, lp_cpu = make_lpips(device="cuda"), make_lpips(device="cpu")
        pairs = [(ev.lpips_input(Image.open(os.path.join(gt_dir, n.split("_")[0]
                                                         + "_00.jpg")), "cpu"),
                  ev.lpips_input(Image.open(os.path.join(pred_dir, n)), "cpu"))
                 for n in preds[:REJ_BATCH]]
        card_d = torch.cat([lp_card(a.cuda(), b.cuda()).cpu() for a, b in pairs])
        cpu_d = torch.cat([lp_cpu(a, b) for a, b in pairs])
        _within("rejection: LPIPS alex on the card against the same module on "
                "the CPU", card_d, cpu_d, torch.float32)
        lp_ms = []
        for a, b in pairs * 3:
            a, b = a.cuda(), b.cuda()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            lp_card(a, b)
            e1.record()
            torch.cuda.synchronize()
            lp_ms.append(e0.elapsed_time(e1))
        net = InceptionV3(device="cpu")
        init_weights(net, torch.Generator().manual_seed(6))
        sd = net.state_dict()
        for k in [k for k in sd if k.endswith("running_var")]:
            sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(0)
        inc_pth = os.path.join(tmp, "inception_v3.pth")
        torch.save(sd, inc_pth)
        net = net.cuda().eval()
        inc_ms = []
        with torch.inference_mode():
            for n in preds[:REJ_BATCH + 1]:
                x = ev.inception_input(Image.open(os.path.join(pred_dir, n)),
                                       "cuda")
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                net(x)
                e1.record()
                torch.cuda.synchronize()
                inc_ms.append(e0.elapsed_time(e1))
        log(f"rejection: LPIPS alex at 128x128, one pair, CUDA events: "
            f"{_spread(lp_ms[1:])}, first {lp_ms[0]:.2f} ms; InceptionV3 at "
            f"299x299, one image: {_spread(inc_ms[1:])}, first "
            f"{inc_ms[0]:.2f} ms | {card}")
        t0 = time.perf_counter()
        res = ev.main(["--predict_dir", pred_dir, "--ground_truth_dir", gt_dir,
                       "--inception_weights", inc_pth, "--device", "cuda"])
        log(f"rejection: evaluate.main on {len(preds)} images in "
            f"{time.perf_counter() - t0:.1f} s: SSIM {res[0]:.6f} MSE "
            f"{res[1]:.6f} LPIPS {res[2]:.6f} IS {res[3]:.6f} +- {res[4]:.6f}")
        lines = open(os.path.join(pred_dir, "eval.txt")).read().splitlines()
        n_lpips = len(open(os.path.join(pred_dir, "lpips.txt")).readlines())
        if not (np.isfinite(res).all() and len(lines) == 2
                and lines[0].startswith("SSIM : ") and n_lpips == len(preds)):
            raise RuntimeError(f"evaluate: {res}, eval.txt {lines}, "
                               f"lpips.txt {n_lpips} lines")
    finally:
        _tf32(*saved)
        shutil.rmtree(tmp, ignore_errors=True)
    after = _all_launches()
    if after != before:
        raise RuntimeError(f"rejection: a hand-written kernel launched: "
                           f"{ {k: after[k] - before[k] for k in after} }")
    log(f"rejection: no hand-written kernel launched | {card}")
    torch.cuda.empty_cache()


def _hold(label, wrapper, call, plain, exact):
    """One call of a wrapper at a small size against its plain version: one
    launch, finite, within 2 bf16 ulps of max|ref| (or bit for bit)."""
    before = wrapper.launches
    out = call()
    torch.cuda.synchronize()
    ref = plain()
    scale = ref.float().abs().max().item()
    err = (out.float() - ref.float()).abs().max().item()
    tol = 0.0 if exact else 2 * 2 ** -7 * scale
    log(f"{label}: max_abs {err:.3e} (tol {tol:.3e}) "
        f"{'ok' if err <= tol else 'FAIL'}, launches {wrapper.launches - before}")
    if wrapper.launches != before + 1:
        raise RuntimeError(f"{label}: {wrapper.launches - before} launches in "
                           f"one call")
    if not torch.isfinite(out).all() or err > tol or out.shape != ref.shape:
        raise RuntimeError(f"{label}: kernel disagrees with its plain version")


def _no_staging(label, call, alone, pack, x):
    """A wrapper that reads x as it is. One call may allocate its output and
    the packed weights, far less than a second copy of x. And it may take
    longer than its kernel alone (``alone``, from the profiler) and the
    weight packing ``pack`` by launch gaps only: by less than half of the
    cheapest staging pass there could be, one read and one write of x, timed
    here as Tensor.copy_. All by CUDA events over ten calls, so that the gap
    before the first launch weighs little."""
    x_bytes = x.numel() * x.element_size()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = call()
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base \
        - out.numel() * out.element_size()
    ms, pack_ms = _events_ms(call, 10), _events_ms(pack, 10)
    copy_ms = _events_ms(lambda: out.copy_(x), 10)
    del out
    log(f"{label}: wrapper {ms:.3f} ms, kernel alone "
        + ("not measured" if alone is None else f"{alone:.3f} ms")
        + f", weight packing {pack_ms:.3f} ms, a copy of x {copy_ms:.3f} ms; "
        f"allocated beside the output {extra / 1e6:.2f} MB (x is "
        f"{x_bytes / 1e6:.0f} MB)")
    if extra > x_bytes // 8:
        raise RuntimeError(f"{label}: the wrapper allocated {extra} bytes "
                           f"beside its output: a staged copy of x?")
    if alone is not None and ms - alone - pack_ms > 0.5 * copy_ms:
        raise RuntimeError(f"{label}: the wrapper takes {ms - alone:.3f} ms "
                           f"more than its kernel: a staging pass?")


def tools_phase(card):
    """The conv-experiment path. First its entry points, at full size, with
    the launch counts set to 0 just before and read just after; then each
    kernel against its plain version. Tolerance: 2 bf16 ulps of max|ref| for
    the convs (kernel and plain version both sum nine taps x Cin products in
    f32 and round once; the orders differ), none for the probe (a copy).
    Returns ({kernel: {bf16: totals}}, {kernel: launches of the entry
    points})."""
    from hrviton_tpu_torch.ops import conv3x3 as c3
    from hrviton_tpu_torch.tools import (_common, exp_conv, exp_conv2,
                                         exp_copy_probe)
    for name in ("PROF_BATCH", "PROF_H", "PROF_W", "PROF_C", "PROF_ITERS",
                 "PROF_TH", "SKIP_CHECK"):
        os.environ.pop(name, None)          # the tools' own full size
    model, tools = _wrappers(), _tool_wrappers()
    for w in (*model.values(), *(t[0] for t in tools.values())):
        w.launches = 0
    t0 = time.perf_counter()
    exp_conv.main()
    exp_conv2.main("all")
    os.environ["SKIP_CHECK"] = "1"      # the JAX script times e and e2 so
    try:
        exp_conv2.main("e")
        exp_conv2.main("e2")
    finally:
        del os.environ["SKIP_CHECK"]
    exp_copy_probe.main()
    counts = {k: t[0].launches for k, t in tools.items()}
    model_counts = {k: w.launches for k, w in model.items()}
    log(f"tools: entry points ran in {time.perf_counter() - t0:.1f} s, launches "
        f"{counts}, of the model kernels {model_counts}")
    # a warm-up and twice PROF_ITERS calls
    timed = 1 + 2 * _common.problem_size()[-1]
    expect = {"conv_band": 1 + 3 * timed,    # the check; TH = 8, 16, 32
              "conv_halo": 1 + timed, "conv_dma": 1 + timed,
              "conv_roll": 1 + timed,        # main('all'): the check; TH = 8
              "conv_prodroll": 1 + 2 * timed,            # ... TH = 8, 16
              # the check of main('all'); TH = 8, 16 under SKIP_CHECK
              "conv_e": 1 + 2 * timed, "conv_e2": 1 + 2 * timed,
              "copy_probe": 1 + timed}
    # exp_conv.main times conv3x3_wide beside conv_band; nothing else of the
    # model's kernels runs here
    expect_model = dict.fromkeys(model, 0) | {"conv3x3_wide": timed}
    if counts != expect or model_counts != expect_model:
        raise RuntimeError(f"tools: launches {counts} / {model_counts}, "
                           f"expected {expect} / {expect_model}")

    dtype = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(2)
    b, h, w, cin, cout, th = TOOLS_RAGGED
    x = _randn(gen, b, h, w, cin).to(dtype)
    wt = _randn(gen, 3, 3, cin, cout, scale=0.1).to(dtype)
    for key, _, _ in TOOL_CONVS:
        run, plain = tools[key]
        _hold(f"{key} ragged {TOOLS_RAGGED}", run, lambda: run(x, wt, th=th),
              lambda: plain(x, wt, th), False)
    probe, probe_ref = tools["copy_probe"]
    _hold(f"copy_probe ragged {TOOLS_RAGGED[:4]} TH={th}", probe,
          lambda: probe(x, th=th), lambda: probe_ref(x, th), True)

    _, h, w, c = TOOLS_X
    x = _randn(gen, *TOOLS_X).to(dtype)
    wt = _randn(gen, 3, 3, c, c, scale=0.1).to(dtype)
    # the library call: one F.conv2d, channels_last, in the working dtype
    xa = x.permute(0, 3, 1, 2)
    w_oihw = wt.permute(3, 2, 0, 1)
    wl = w_oihw.contiguous(memory_format=torch.channels_last)
    flops = c3.conv_flops(B, h, w, c, c)
    strip_cols = -(-w // 62) * 64       # product columns of the shift kernels
    nbytes = (2 * x.numel() + wt.numel()) * x.element_size()
    totals = {}
    with _Clocks():
        for key, kname, ths in TOOL_CONVS:
            run, plain = tools[key]
            for th in ths:
                tot = {}
                _check_site(tot, f"{key} TH={th} {c}->{c} {h}x{w}", dtype, 1,
                            lambda: run(x, wt, th=th), lambda: plain(x, wt, th),
                            lambda: F.conv2d(xa, wl, None, 1, 1), kname, flops,
                            nbytes, per_call=1)
                totals.setdefault(key, {dtype: tot})
                entry = f"{key}_forward_bf16"
                order = getattr(_common, TAP_ORDER.get(key, "pack_taps"))
                if key in UNSTAGED:
                    layout = _common._ENTRIES[entry][2]
                    _no_staging(f"{key} TH={th}", lambda: run(x, wt, th=th),
                                tot["kernel_alone_ms"],
                                lambda: layout(wt, order), x)
                if key in EVENTS_ALONE:
                    launch, _ = _common.conv_launcher(entry, x, wt, th, order)
                    alone, ev = tot["kernel_alone_ms"], _events_ms(launch, 10)
                    log(f"{key} TH={th}: kernel alone by CUDA events around the "
                        f"bare entry point {ev:.3f} ms, by the profiler "
                        + ("not measured" if alone is None else
                           f"{alone:.3f} ms ({100 * (ev - alone) / alone:+.1f}%)")
                        + f"; bound {flops / PEAK_OPS[dtype] * 1e3:.4f} ms"
                        + (f", with the products of the strips' overlapping "
                           f"columns {flops * strip_cols / w / PEAK_OPS[dtype] * 1e3:.4f} ms"
                           if key in PRODUCT_SHIFT else ""))
                    del launch
                if key in EARLIER:
                    was = EARLIER[key].get(th)
                    alone = tot["kernel_alone_ms"]
                    log(f"{key} TH={th}: wrapper {tot['ms']:.3f} ms, kernel alone "
                        + ("not measured" if alone is None else f"{alone:.3f} ms")
                        + " by TMA and wgmma"
                        + (f" in clusters of {_common.band_cluster(th)} blocks"
                           if key in BAND_KIND else "")
                        + "; the earlier design "
                        + ("not measured at this band height" if was is None else
                           f"{was[0]:.2f} ms, kernel alone {was[1]:.2f} ms "
                           f"(PERF.md)"))
    log(f"conv_halo, conv_roll: encoding one call's two tensor maps takes "
        f"{_common.tensor_map_encode_us(x, wt):.2f} us of host time")
    for th in (8, 16):
        log(f"TH={th}: the JAX tools' gather alone (halo_tiles) "
            f"{_events_ms(lambda: exp_conv2.halo_tiles(x, th), 3):.3f} ms; "
            f"no kernel pays it any more: the tiles of conv_halo, conv_roll "
            f"and conv_prodroll are TMA boxes of the unpadded x")
    log(f"the JAX tools' pad alone (pad_input) "
        f"{_events_ms(lambda: _common.pad_input(x), 3):.3f} ms; no kernel pays "
        f"it any more: conv_band's and conv_dma's band tiles are TMA boxes of "
        f"the unpadded x")
    wide = lambda: c3.conv3x3_wide(x, w_oihw)
    wide_alone = _device_ms(wide, "conv3x3_wide_kernel", per_call=1)
    log(f"conv3x3_wide {c}->{c} {h}x{w}: wrapper {_events_ms(wide, 3):.3f} ms, "
        f"kernel alone "
        + ("not measured" if wide_alone is None else f"{wide_alone:.3f} ms"))
    out = torch.empty_like(x)
    tot = {}
    _check_site(tot, f"copy_probe TH={PROBE_TH} {TOOLS_X}", dtype, 1,
                lambda: probe(x, th=PROBE_TH), lambda: probe_ref(x, PROBE_TH),
                lambda: out.copy_(x), "band_copy_probe_kernel", 0,
                2 * x.numel() * x.element_size(), exact=True, per_call=1)
    totals["copy_probe"] = {dtype: tot}
    launch, _ = exp_copy_probe.probe_launcher(x, PROBE_TH)
    ev, alone = _events_ms(launch, 10), tot["kernel_alone_ms"]
    was = EARLIER["copy_probe"][PROBE_TH]
    log(f"copy_probe TH={PROBE_TH}: wrapper {tot['ms']:.3f} ms, kernel alone by "
        f"CUDA events around the bare entry point {ev:.3f} ms, by the profiler "
        + ("not measured" if alone is None else f"{alone:.3f} ms")
        + f" (TMA loads and stores); bound {tot['bound_ms']:.4f} ms (x read once, "
        f"out written once: {2 * x.numel() * x.element_size() / 1e6:.0f} MB), the "
        f"halo rows read again {2 * x.numel() * x.element_size() / PROBE_TH / 1e6:.1f} "
        f"MB more (2/TH of x); the earlier design {was[0]:.3f} ms, kernel alone "
        f"{was[1]:.3f} ms (PERF.md)")
    del launch
    log(f"tools: {card}")
    del x, xa, out
    torch.cuda.empty_cache()
    return totals, counts


KERNELS = [
    # (key, name, source, file:line of the TPU kernel's pl.pallas_call)
    ("spade_unit", "spade_unit (six units of one batch-4 request: up_3, up_4 x "
     "norm_s/norm_0/norm_1, bf16; per unit the gamma|beta and consumer "
     "launches on the TMA / wgmma conv engine and the one-pass statistics)",
     "spade_block.cu", "hrviton_tpu/ops/spade_block.py:337"),
    ("spade_unit_cli_bf16", "spade_unit on the inference CLI's path, --bf16: "
     "the six units of one batch-1 forward at 1024x768, per unit the "
     "gamma|beta and consumer launches on the conv engine and the one-pass "
     "statistics; launches over the CLI's bf16 batches",
     "spade_block.cu", "hrviton_tpu/ops/spade_block.py:337"),
    ("spade_modulate", "spade_modulate (nine norms of one batch-4 request: "
     "up_2, up_3, up_4 x norm_s/norm_0/norm_1, bf16)", "spade_fused.cu",
     "hrviton_tpu/ops/spade_fused.py:249"),
    ("conv3x3_wide", "conv3x3_wide (eight convs of one batch-4 request: up_1 "
     "gamma/beta x3 and conv_1, up_2 conv_1, bf16; on the TMA / wgmma conv "
     "engine)", "conv3x3.cu", "hrviton_tpu/ops/conv3x3.py:224"),
    ("conv3x3_small", "conv3x3_small (four convs of one batch-4 request: "
     "conv_6, conv_7, up_4.conv_1, conv_img, bf16)", "conv3x3.cu",
     "hrviton_tpu/ops/conv3x3.py:426"),
    ("conv_band", "conv_band (tools/exp_conv.main: x (4, 1024, 768, 128), w "
     "(3, 3, 128, 128), bf16, unpadded; TMA band tiles and wgmma, taps "
     "unrolled; times at TH=8, launches of the check and the timings at TH=8, "
     "16, 32)", "conv_tma.cu", "tools/exp_pallas_conv.py:93"),
    ("conv_halo", "conv_halo (tools/exp_conv2.main('all'): the same x, "
     "unpadded, and w; TMA halo tiles and wgmma, TH=8)", "conv_tma.cu",
     "tools/exp_pallas_conv2.py:98"),
    ("conv_dma", "conv_dma (tools/exp_conv2.main('all'): the same x, "
     "unpadded, and w; TMA band tiles and wgmma, taps in a loop, TH=8)",
     "conv_tma.cu", "tools/exp_pallas_conv2.py:253"),
    ("conv_roll", "conv_roll (tools/exp_conv2.main('all'): the same x, "
     "unpadded, and w; three TMA boxes a stage and wgmma; times at TH=8, "
     "launches at TH=8)", "conv_tma.cu", "tools/exp_pallas_conv2.py:146"),
    ("conv_prodroll", "conv_prodroll (tools/exp_conv2.main('all'): the same x, "
     "unpadded, and w; one TMA box a chunk, nine products a chunk on wgmma, "
     "the kx shift on three accumulators; times at TH=8, launches at TH=8, "
     "16)",
     "conv_tma.cu", "tools/exp_pallas_conv2.py:197"),
    ("conv_e", "conv_e (tools/exp_conv2.main('all') and main('e') under "
     "SKIP_CHECK: the same x, unpadded, and w; one TMA box a chunk, nine "
     "products a chunk on wgmma, the kx shift on three accumulators carried "
     "along each row's 64-column tiles; times at TH=8, launches at TH=8, 16)",
     "conv_tma.cu", "tools/exp_pallas_conv2.py:352"),
    ("conv_e2", "conv_e2 (tools/exp_conv2.main('all') and main('e2') under "
     "SKIP_CHECK: the same x, unpadded, and w; three TMA boxes a chunk (ky "
     "packed into channels), wgmma, the kx shift on three accumulators; "
     "times at TH=8, launches at TH=8, 16)", "conv_tma.cu",
     "tools/exp_pallas_conv2.py:438"),
    ("copy_probe", "band-copy probe (tools/exp_copy_probe.main: the same x, "
     "TH=16; a TMA box a band into a ring of slots, its interior rows back by "
     "a TMA store)", "copy_probe.cu", "tools/exp_dma_probe.py:67"),
    # a helper of kernels 1 and 2, no TPU kernel's counterpart: the JAX
    # package computes the statistics with XLA outside its Pallas kernels
    ("instance_stats", "instance_stats (one-pass statistics of the six units "
     "of one batch-4 request, bf16; launches also one per norm of the second "
     "path)",
     "spade_fused.cu", "hrviton_tpu/ops/spade_block.py:270"),
]


def _contract_line():
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def main():
    card = device_phase()
    build_phase()
    if sys.argv[1:] == ["--paths"]:
        first_path_phase(card)
        torch.cuda.empty_cache()
        second_path_phase(card)
        torch.cuda.empty_cache()
        # a parent checkout from before the CLI (timed in turns) has none
        if importlib.util.find_spec("hrviton_tpu_torch.cli") is not None:
            cli_phase(card)
        _contract_line()
        return
    if sys.argv[1:] == ["--alone"]:
        log(card)
        alone_phase()
        _contract_line()
        return
    if sys.argv[1:]:
        sys.exit(f"chip_smoke: unknown arguments {sys.argv[1:]}")
    sass_phase()
    totals = kernel_phase()
    first = first_path_phase(card)
    torch.cuda.empty_cache()
    second = second_path_phase(card)
    torch.cuda.empty_cache()
    cli_units, cli_launches = cli_phase(card)
    # the statistics run on both paths, every other kernel on one of them;
    # the CLI's launches of the unit go to its own rows, with its batch-1
    # times (the statistics' launches there are inside those rows' times)
    launches = {k: first.get(k, 0) + second.get(k, 0)
                for k in set(first) | set(second)}
    rows = {k: v[torch.bfloat16] for k, v in totals.items()}
    # the f32 CLI launches no kernel (the gates take bf16 only, checked in
    # phase 6): its unit check is a direct call, in the log only
    rows["spade_unit_cli_bf16"] = cli_units[torch.bfloat16]
    launches["spade_unit_cli_bf16"] = cli_launches[torch.bfloat16]["spade_unit"]
    torch.cuda.empty_cache()
    tool_totals, tool_launches = tools_phase(card)
    rows.update({k: v[torch.bfloat16] for k, v in tool_totals.items()})
    launches.update(tool_launches)
    torch.cuda.empty_cache()
    rejection_phase(card)
    record = {"kernels": []}
    ths = {key: t for key, _, t in TOOL_CONVS}
    for key, name, source, replaces in KERNELS:
        t = rows[key]
        if launches[key] <= 0:
            raise RuntimeError(f"{key}: no launch on its main path")
        if key in BAND_KIND:
            from hrviton_tpu_torch.tools import _common
            name += "; blocks a cluster, sharing each stage's weights by " \
                "multicast where more than 1: " + ", ".join(
                    f"{_common.band_cluster(th)} at TH={th}" for th in ths[key])
        record["kernels"].append({
            "name": name, "route": "cuda", "source": CSRC + source,
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": t["max_abs"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "operations" if t["ops_ms"] >= t["bytes_ms"] else "bytes",
            "library_ms": t["library_ms"]})
    log(card)
    log(json.dumps(record))
    _contract_line()


if __name__ == "__main__":
    main()
