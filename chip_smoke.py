#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py            # everything below
    python3 chip_smoke.py --paths    # phases 1, 2, 4, 5 and 6 only
    python3 chip_smoke.py --alone    # phases 1, 2 and kernels' times alone
    python3 chip_smoke.py --captured # phases 1, 2 and 11 only
    python3 chip_smoke.py --steps    # phases 1, 2 and the recorded
                                     # training steps of phases 9 and 10
    python3 chip_smoke.py --knockout # phases 1, 2 and 12, the tools at
                                     # ten pairs, every training variant
    python3 chip_smoke.py --sass-diff DIR  # phases 1, 2 and the engine
                                     # kernels' SASS here against DIR's
    python3 chip_smoke.py --wgrad    # phases 1, 2 and 13

Phases (any failure exits non-zero, and no result line is printed):
  1. device: the card's name and power limit (nvidia-smi), torch/CUDA versions;
  2. build: compile every hand-written kernel from the sources in the checkout
     (hrviton_tpu_torch/csrc/{spade_block,spade_fused,conv3x3,copy_probe,
     conv_tma,spade_knock,wgrad3x3}.cu: the model path's five kernels on the
     conv engine, the seven of conv_tma.cu and the band-copy probe, the
     instance statistics and the weight gradient; conv_tma.cu holds
     conv_halo, conv_roll, conv_band, conv_dma, conv_prodroll, conv_e2 and conv_e, spade_knock.cu the unit's
     knock variants, timing only, wgrad3x3.cu the training step's bf16
     weight gradient), one nvcc process each, all started together, with ptxas's
     report of registers and spills; a kernel whose wgmma ptxas serialised
     (C7518, C7520) fails it;
  3. kernel check: each kernel's wrapper against its plain PyTorch version at
     every shape its main path gives it, batch 4, in bf16 (the kernels run
     for bf16 on the card only), with times beside the bound:
       - the fused SPADE unit (ops/spade_block.py) at the six unit shapes of
         the first path (up_3, up_4 x norm_s/norm_0/norm_1): two launches on
         the TMA / wgmma conv engine (gamma|beta with the
         modulation, then the consumer conv) and the one-pass statistics,
         each part's time printed; and at one ragged small shape;
       - the one-pass instance statistics (ops/spade_fused.py:norm_stats)
         against instance_stats at the six unit shapes (mu within 1e-4 of
         the std, rsig within 1e-4 relative);
       - the fused modulation (ops/spade_fused.py, the unit's gamma|beta
         stage on the conv engine with no activation) at the nine
         norms of the second path (up_2, up_3, up_4), beside cuDNN's time for
         the gamma|beta product alone (not the same function), and at one
         ragged small shape;
       - the wide 3x3 conv (ops/conv3x3.py:conv3x3_wide, on the conv engine)
         at its eight sites (up_1's gamma/beta convs and conv_1,
         up_2's conv_1), beside F.conv2d, and at one ragged small shape;
       - the small-channel 3x3 conv (conv3x3_small, on the conv engine; 9
         input channels as the engine's narrow input) at its four
         sites (conv_6, conv_7, up_4.conv_1, conv_img), beside F.conv2d,
         and at three ragged small shapes (one with 20 input channels,
         which the wrapper pads to 24);
     the kernels of the modulation and the small conv are also timed
     alone by CUDA events around the bare C entry point, with the operands
     packed; the times of the unit, the modulation and both convs are
     printed beside those of the designs they replaced (PERF.md); and the
     SASS of every kernel on wgmma (cuobjdump -sass: the engine's and the
     seven of conv_tma.cu) must hold HGMMA and no HMMA, that of conv_band
     and conv_dma in a cluster of 2 or 4 the multicast form of the TMA load,
     and that of the band-copy probe the TMA load and store and no store of
     a thread to device memory;
  (The inference entry points of phases 4-6 and 8 replay CUDA graphs, as a
  user's calls do: hrviton_tpu_torch/core/graphs.py; phase 5's layout
  copies are timed eagerly. A profiler window of kernel times is held to
  its calls' launches, and the windows that lost records are printed at
  the end.)
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
     the fused unit's wrapper at the six unit shapes at batch 1 in bf16 (the
     conv engine; the kernels run for bf16 on the card only, an f32 call is
     the plain version), against spade_conv_ref with TF32 off, with times
     beside the bound; 26 compact
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
     whole phase (every counter unchanged);
  9. training: (a) the four model-path kernels' autograd.Functions
     (spade_conv_unit at up_3 / up_4's six units, fused_spade_modulate at
     the nine fast_spade norms, conv3x3_wide and conv3x3_small at their
     sites), batch 2 at 1024x768, bf16: the output within 2 bf16 ulps of
     max|ref| of the plain version and every input gradient within 2 bf16
     ulps of max|ref| of the plain version's autograd; the wide kernel
     reads its weight anew after an SGD step on it; (b) stage 1 through
     cli/train_condition.main: tocg ngf=96 at 256x192, batch 8, f32, the
     condition discriminator (33 channels, ndf 64, 3 layers, 2 scales), 12
     steps on a synthetic tree of 64 pairs a split (make_synthetic_dataset,
     random VGG19 from seed 0 under --allow_random_vgg), IoU validation,
     under torch's default TF32 settings and cuDNN's autotuning off (torch's
     default; the paths' phases leave it on): finite losses every step, ms/step
     by CUDA events (median and quartiles after the first), peak
     torch.cuda.max_memory_allocated, the TF32 flags a hook on every logit
     map reads in backward (all False), no kernel launched; its
     tocg_final.ckpt and D_final.ckpt load into cli/test_condition (64
     rejection scores); (c) stage 2 through cli/train_generator.main: SPADE
     ngf=64 'most' at 1024x768, batch 2, --bf16, the CLI's defaults (fused
     unit off, remat, D remat, taps wgrad), the SPADE discriminator (ndf
     64, 3 layers, 2 scales), the frozen tocg from stage 1's checkpoint, 8
     steps with in-train LPIPS (random alex) and the TensorBoard grids'
     generate_debug: the same figures, the hinge D loss at init within 0.05
     of 2.0, no kernel launched but wgrad3x3, once a wgrad_taps call (this
     run and its eager run; the record's launches of wgrad3x3 are this
     run's); (d) stage 2 with --fused_block, 4 steps:
     the fused unit and the statistics exactly 18 launches a step (6 in the
     G loss's forward, 6 when backward recomputes up_3 and up_4, 6 in the D
     step's regeneration), wgrad3x3 once a wgrad_taps call, the counts set
     to 0 just before and read just after; those launches of the unit and
     the statistics join the record's rows; (e) stage 2 with --no_taps_wgrad, 4 steps: ms/step beside
     (c)'s, each beside the taps op's backward calls and layout copies a
     step (conv3x3_taps.backwards, .layout_copies; none without the taps),
     the tap-product weight gradient's cost against cuDNN's (the CLIs'
     steps, eval calls and expand replay CUDA graphs, as a user's run does,
     with the allocator's expandable segments the CLIs turn on); (b), (c)
     and (d) each also run eagerly under graphs.disabled() (its launches
     not counted): the peak memory, allocated and reserved from an emptied
     cache, recorded beside eager;
     (f) the recorded steps (core/graphs.py, the trainers' train_step)
     against eager (graphs.disabled()), each from a state built alike from
     one seed, in turns on the same 3 batches of the trees (the CLIs' data
     path), 11 pairs, cuDNN deterministic: stage 1 (as (b), with --Ddropout,
     under torch's default TF32 settings with the TF32 hooks), stage 2 (as
     (c)), stage 2 --fused_block (as (d)); bit for bit every step's metrics
     and the generators' states (dropout, noise) after every step, and,
     after the last, every parameter, buffer (running statistics, spectral
     u/v), Adam moment and step count and the counters; launches a step
     eager and replayed (18 unit and 18 statistics with --fused_block;
     stage 2's wgrad3x3 once a wgrad_taps call, as many eager as
     replayed; none else); one recording. Stage 1's eager step is not reproducible
     on the card (atomic adds in grid_sample's backward): a second eager
     state is stepped in the same turns, the ops torch names as
     nondeterministic are printed, and before each step both eager states
     are set to the replayed one; then, after each step, bit for bit in all
     three: every metric, every tensor but the tocg's parameters and their
     Adam moments (the tocg's running statistics, the whole discriminator
     with its Adam state, every step count), the dropout generator; the
     tocg's parameters and moments within 4 times the two eager runs'
     distance D from that state (the sum over those tensors of mean|x - y|
     / mean|y|); the memory of the first eager step and of the first
     replayed call (warm-up, recording), the step's pool and what is
     allocated in it; ms/step eager and replayed by CUDA
     events (the pairs after the first: median, quartiles), the recording's
     seconds, the pool's MiB, the graph's kernel nodes (DOT dump) beside one
     eager step's profiled launches; (g) the loader's host time
     (hrviton_tpu_torch/tools/bench_loader.py, one worker, stage 2's tree
     at 1024x768, full f32 against compact uint8);
 10. data parallel, the alias norms, LPIPS head training, on phase 9's
     synthetic trees, cuDNN deterministic for (a): (a) both training CLIs
     through --coordinator 127.0.0.1:<free port> --num_processes 1
     --process_id 0 (core/mesh.py over NCCL: one rank, whose reductions
     are real collectives) and, the same seed and data, without the flags:
     stage 1 at phase 9's configuration for 4 steps, its first-step losses
     within 1e-5 relative; stage 2 with --fused_block, bf16, 3 steps,
     exactly 18 unit and 18 statistics launches a step and wgrad3x3 once a
     wgrad_taps call (the counts set to 0 just before and read just after;
     the unit's and the statistics' join the record's rows), the
     G losses of the first step within 1e-5 and the D losses (after the G
     update) within 1e-3; finite losses, TF32 off in backward, ms/step
     beside the run without the flags and phase 9's, the group torn down
     after each CLI; (b) stage 2 with --norm_G spectralaliasbatch, fused
     unit off, 2 steps: finite losses, no kernel launched but wgrad3x3
     (once a wgrad_taps call), every
     'aliasbatch' running mean moved from 0 in gen_model_final.ckpt; and
     SPADEResBlock with use_mask_norm at up_4's shape (80 -> 32, 1024x768,
     batch 1, f32, seeded weights and misalign mask) on the card against
     the same module on the CPU within 1e-4 x max|ref|; (c) LPIPSHeadTrainer
     (alex, 64x64, batch 8) replayed against eager as in phase 9 (f), 11
     pairs on 10 batches, the learning rate decayed before the sixth step;
     then 10 replayed steps of a new trainer: finite losses, every lin
     kernel >= 0 after each step; (d) phase 9 (f) through one NCCL rank (a group of one,
     its reductions real collectives recorded in the graphs): stage 1 and
     stage 2 --fused_block, 4 pairs each;
 11. (in a process of its own, chip_smoke.py --captured: a long process's
     profiler windows lose records, PERF.md section 7) captured entry
     points (core/graphs.py), each eager (graphs.disabled()) against
     replayed at full width: both paths (batch 4, bf16, 1024x768),
     the inference CLI's step (batch 1, f32 and bf16; then a new bf16
     pipeline at batch 2 and a last batch of 1, a graph each),
     test_condition's condition_step and get_norm_const's norm_const_step
     (batch 8, 256x192, f32, tocg ngf=96, the condition discriminator),
     evaluate's LPIPS (alex, 128x128) and Inception with its softmax
     (299x299): replay equal to eager bit for bit (or, naming every tensor
     that differs, the main output within the pipelines' limits), the same
     launch counters per call, the kernel nodes of each graph (its DOT dump
     under build/graphs/) no fewer than one eager call's kernel
     launches (the most of up to three profiler windows; any difference
     named kernel by kernel) with every hand-written kernel among them as
     often, the
     outputs of a call unchanged after the next call, weights written in
     place after a replay recorded anew and equal to eager with them; then
     10 eager and replayed calls in turns by CUDA events and host clock,
     the device busy time and host gap of one call each (torch.profiler)
     and the graphs' pool memory;
 12. the knockout attribution (timing only; ops/spade_block.py knock=,
     models/spade.py:gen_knock, hrviton_tpu_torch/tools/exp_*_knockout.py
     and profile_components.py): (a) each of the seven knock variants of
     the unit's two kernels (csrc/spade_knock.cu, a compile-time mask of
     conv_engine.cuh and spade_mod.cuh) through the wrapper with its tag
     set at the six unit shapes, batch 4, bf16, on x with channel means and
     scales far from 0 and 1, against the plain knocked unit within 2 ulps
     of max|ref|, and the production unit outside that limit (actv_dma,
     whose output is undefined, launched and timed only), with times beside
     the plain version and the bound of what the variant still does; (c)
     gen_knock through the replayed first path with each of the JAX tool's
     knocks, skeleton and the unit's eight tag sets: one recording a set,
     two replays equal, after each context the production graph replayed
     with no new recording and the output from before the knocks bit for
     bit; the variants' counts and those of the production kernels a
     knocked call launches set to 0 just before and read just after (the
     variants' in the record; each stage run once a unit a call); (d) each
     tool's main at full size, two pairs (the condition stage's full
     variant held against condition_forward bit for bit; the training
     step's: prod and skeleton, after its full variant's step is held
     against the production step bit for bit, its ms beside the stage-2
     CLI's of phase 9); (b) every knock variant built, with HGMMA in all
     but the two without products.
 13. the bf16 weight gradient of the training step's 3x3 convs
     (ops/conv3x3.py:wgrad3x3, csrc/wgrad3x3.cu): one eager step of the
     stage-2 benchmark cell (SPADE ngf 64 'most' at 1024x768, batch 2;
     benchmark/drivers/train_closed_loop.py builds it): 94 launches, as
     many as wgrad_taps, the operands the wrapper copied, and each call's x
     and g as the step hands them to the wrapper (shape, strides, storage
     offset: g contiguous NHWC, a concatenation's NHWC slice (copied by
     the wrapper), the NHWC view of an NCHW tensor, or of a
     concatenation's NCHW slice), the calls' shapes those of
     tests/test_torch_wgrad3x3.py:cell_sites; then at each distinct call,
     on operands drawn with those strides and offsets, and again with g
     the NHWC view of a contiguous NCHW tensor and of a concatenation's
     NCHW slice (the kernel's 5-D read of g, which the step no longer
     reaches), the kernel against wgrad3x3_ref within one bf16 ulp an
     element (2^-12 of max|ref| near zero: tests/test_torch_wgrad3x3.py),
     finite, two launches bit for bit; the kernel alone (CUDA events
     around the bare launch) and the wrapper (with the copies it makes) in
     each of those layouts, the plain version and cuDNN's bf16 weight
     gradient (torch.nn.grad.conv2d_weight, a yardstick the port never
     calls) as the step hands g, each at up_4's largest call and summed
     over the 94. In
     the full run phase 9 (c) holds the stage-2 CLI's launches of the kernel
     to wgrad_taps' (the record's launches).

The second-to-last line is the {"kernels": [...]} JSON record and the last
line is {"ok": true, "device": {...}}. With --wgrad the script builds and
runs phase 13 and prints its row of the record before the last line. With --knockout the script builds and
runs phase 12 with the tools at ten pairs and every training variant (the
measured tables of PERF.md), and prints only the last line; with
--sass-diff DIR it builds the engine kernels here and in the checkout at DIR
(e.g. a parent unpacked under build/) and fails unless the production
kernels' SASS and resources are the same. With --steps the script builds, writes
the two synthetic trees and runs phase 9 (f), (g), phase 10 (c) and (d), and
prints only the last line. With --paths the script stops after
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

import contextlib
import dataclasses
import importlib.util
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from benchmark.flops import unit_bytes, unit_flops  # noqa: E402

B = 4                       # batch of the kernel check and of each request
N_REQUESTS = 3              # per path
PEAK_BYTES = 3.35e12        # H100 SXM HBM3, bytes/s
PEAK_OPS = 989e12           # dense bf16 tensor-core FLOP/s
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
              "conv3x3_small": 0, "instance_stats": 6, "wgrad3x3": 0}
SECOND_PATH = {"spade_unit": 0,
               "spade_modulate": sum(s[-1] for s in MODULATE_SITES),   # 9
               "conv3x3_wide": sum(s[-1] for s in WIDE_SITES),         # 8
               "conv3x3_small": sum(s[-1] for s in SMALL_SITES),       # 4
               "instance_stats": sum(s[-1] for s in MODULATE_SITES),   # 9
               "wgrad3x3": 0}
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
             "instance_stats": getattr(sf, "norm_stats", None),
             "wgrad3x3": getattr(c3, "wgrad3x3", None)}
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


@contextlib.contextmanager
def _window(cpu=False):
    """A torch.profiler window over device activity (and the host's with
    ``cpu``), the device synchronised before and after its work."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        yield prof
        torch.cuda.synchronize()


# Profiler windows that held fewer kernel records than their calls launched:
# (what, records, launches). A window loses a record now and then (PERF.md
# section 7; neither the kernels' static CUDA runtimes nor the window's
# edges); every window's count is tallied and the short ones printed at the
# end of the run.
WINDOWS = {"windows": 0, "short": []}


def _tally(what, got, want):
    WINDOWS["windows"] += 1
    if got != want:
        WINDOWS["short"].append((str(what), got, want))


def _names(kernel_name):
    return (kernel_name,) if isinstance(kernel_name, str) else tuple(kernel_name)


def _device_ms(fn, kernel_name, per_call, iters=2):
    """Device time of the kernels whose names contain ``kernel_name`` (or one
    of a tuple of names) in one call of fn, from torch.profiler (the
    wrapper's own packing left out): one call launches ``per_call`` such
    kernels, so the mean of the records that arrived times ``per_call``
    (a window that lost records is tallied); None without a record."""
    with _window() as prof:
        for _ in range(iters):
            fn()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and any(n in e.name for n in _names(kernel_name))]
    _tally(kernel_name, len(us), per_call * iters)
    return sum(us) / len(us) * per_call / 1e3 if us else None


def _device_split(fn, names, per_call, iters=3):
    """ms per call of fn's kernels, by the first of ``names`` each kernel's
    name contains (torch.profiler): the mean record of each name times
    ``per_call``, the kernels of that name one call launches (a window that
    lost records is tallied); names with no record are left out."""
    with _window() as prof:
        for _ in range(iters):
            fn()
    us = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = next((n for n in names if n in e.name), None)
        if name is not None:
            us.setdefault(name, []).append(e.time_range.elapsed_us())
    _tally(names, {n: len(v) for n, v in us.items()},
           {n: k * iters for n, k in zip(names, per_call)})
    return {n: sum(v) / len(v) * k / 1e3
            for n, k in zip(names, per_call) if (v := us.get(n))}


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


def _modulate_ops(b, h, w, c, nh=128) -> int:
    """Operations of one modulation (2 per multiply-add): the gamma and beta
    3x3 convs over nh channels. The elementwise chain is negligible beside
    them and is not counted."""
    return 2 * b * h * w * 2 * 9 * nh * c


def _modulate_bytes(b, h, w, c, nh=128) -> int:
    """Bytes one bf16 modulation must move: x, actv and the noise (f32)
    read once, out written once, weights read once."""
    px = b * h * w
    return px * (2 * c + nh) * 2 + px * 4 + 2 * 9 * nh * c * 2


def _stats_bytes(b, h, w, c) -> int:
    """Bytes the bf16 instance statistics must move: x and the noise (f32)
    read once, mu and rsig (f32) written once."""
    return b * h * w * (c * 2 + 4) + 2 * b * c * 4


def _conv_ops(b, h, w, cin, cout) -> int:
    """Operations of one 3x3 conv (2 per multiply-add)."""
    return 2 * b * h * w * 9 * cin * cout


def _conv_bytes(b, h, w, cin, cout) -> int:
    """Bytes a bf16 3x3 conv must move: x read once, out written once,
    weights and bias read once."""
    return (b * h * w * (cin + cout) + 9 * cin * cout + cout) * 2


def _check_site(tot, label, n, kernel, plain, library, kernel_name,
                flops, nbytes, per_call, exact=False):
    """One shape of one bf16 kernel: run the wrapper, hold it against its
    plain version (2 ulps of max|ref|, bit for bit if ``exact``), time
    wrapper, plain and library call, and add ``n`` launches' worth to the
    totals. ``per_call``: as in ``_device_ms``. Raises if the kernel
    disagrees."""
    out = kernel()
    torch.cuda.synchronize()
    ref = plain()
    if not torch.isfinite(out).all():
        raise RuntimeError(f"{label}: non-finite kernel output")
    scale = ref.float().abs().max().item()
    err = (out.float() - ref.float()).abs().max().item()
    tol = (0.0 if exact else 2 * 2 ** -7) * scale
    ms = _events_ms(kernel, 3)
    plain_ms = _events_ms(plain, 3)
    lib_ms = _events_ms(library, 3) if library is not None else None
    dev_ms = _device_ms(kernel, kernel_name, per_call=per_call)
    t_ops = flops / PEAK_OPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    bound = max(t_ops, t_bytes)
    fmt = lambda v: "not measured" if v is None else f"{v:.3f} ms"
    log(f"{label} bfloat16 x{n}: max_abs {err:.3e} (tol {tol:.3e}, rel "
        f"{err / scale:.2e}) {'ok' if err <= tol else 'FAIL'} | wrapper "
        f"{ms:.3f} ms, kernel alone {fmt(dev_ms)}, plain {plain_ms:.3f} ms, "
        f"library {fmt(lib_ms)}, bound {bound:.4f} ms "
        f"({'operations' if t_ops >= t_bytes else 'bytes'}), "
        f"{flops / ms / 1e9:.1f} TFLOP/s, {nbytes / ms / 1e6:.0f} GB/s")
    if err > tol:
        raise RuntimeError(f"{label}: kernel disagrees with its plain "
                           f"version ({err} > {tol})")
    for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound),
                   ("ops_ms", t_ops), ("bytes_ms", t_bytes),
                   ("library_ms", lib_ms), ("kernel_alone_ms", dev_ms)):
        if v is None:
            tot[key] = None
        elif tot.get(key, 0.0) is not None:
            tot[key] = tot.get(key, 0.0) + n * v
    tot["max_abs"] = max(tot.get("max_abs", 0.0), err)


# the unit's kernels by part (bf16): gamma|beta, the consumer conv, the
# statistics' two passes
UNIT_PARTS = ("spade_unit_gb", "spade_unit_conv", "instance_stats")
UNIT_KERNELS = 4


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
    alone = _device_ms(lambda: sf.norm_stats(*args), "instance_stats", 2)
    b, h, w, c = shape
    bound = _stats_bytes(b, h, w, c) / PEAK_BYTES * 1e3
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
    beforehand), beside the profiler's time; ``n`` launches' worth into
    the totals."""
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


def _sass_functions(src, names, lib=None):
    """(kernel name, mangled name, SASS) of every function of csrc/<src>.cu's
    library (cuobjdump -sass; ``lib``: a built library's path, else this
    checkout's) whose name contains one of ``names``; raises if one of them
    has none."""
    from hrviton_tpu_torch.ops import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib or str(_build.build(src))],
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
    """Every kernel vs its plain version at each main-path shape, in bf16
    (the kernels run for bf16 on the card only; an f32 call is the plain
    version). Tolerance 2 ulps of max|ref| (2 * 2^-7 * max|ref|), since each
    plain version rounds the same intermediates to bf16 as its kernel and a
    sum in another order flips single roundings. Returns {kernel name:
    totals over one request's launches}."""
    from hrviton_tpu_torch.ops import conv3x3 as c3
    from hrviton_tpu_torch.ops import spade_block as sb
    from hrviton_tpu_torch.ops import spade_fused as sf
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    # the weight gradient's row is phase 13's
    totals = {}
    dtype = torch.bfloat16

    tot = totals["spade_unit"] = {}
    stats = totals["instance_stats"] = {}
    split = {}
    for name, h, w, c, cout, ks, act, residual in UNITS:
        args, res = _unit_inputs(gen, dtype, h, w, c, cout, ks, residual)
        unit = lambda: sb.spade_conv_unit(act, *args, res)
        _check_site(
            tot, f"unit {name}", 1, unit,
            lambda: sb.spade_conv_ref(*args, pre_act=act, residual=res),
            None, ("spade_unit", "instance_stats"),
            unit_flops(B, h, w, c, cout, ks),
            unit_bytes(B, h, w, c, cout, ks, residual=residual), UNIT_KERNELS)
        parts = _device_split(unit, UNIT_PARTS, (1, 1, 2))
        log(f"unit {name}: alone by part " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in parts.items())
            + f" (gamma|beta tiles {sb.gb_tiles(c)}, consumer tiles "
            f"{sb.conv_tiles(cout)})")
        for k, v in parts.items():
            split[k] = split.get(k, 0.0) + v
        _check_stats(stats, f"instance_stats {name}", args[:3],
                     (B, h, w, c))
        del args, res
    tot["split"] = split
    b, h, w, c, cout, ks, act, residual = UNIT_RAGGED
    args, res = _unit_inputs(gen, dtype, h, w, c, cout, ks, residual,
                             batch=b)
    _hold(f"unit ragged {UNIT_RAGGED}", sb.spade_conv_unit,
          lambda: sb.spade_conv_unit(act, *args, res),
          lambda: sb.spade_conv_ref(*args, pre_act=act, residual=res),
          False)
    del args, res

    tot = totals["spade_modulate"] = {}
    for name, h, w, c, n in MODULATE_SITES:
        args, _ = _unit_inputs(gen, dtype, h, w, c, 8, 1, False)
        args = args[:8]
        # the wrapper's plain-torch part beside the kernel: the stats
        stats_ms = _events_ms(lambda: sf.norm_stats(*args[:3]), 3)
        tot["stats_ms"] = tot.get("stats_ms", 0.0) + n * stats_ms
        log(f"modulate {name}: the statistics (norm_stats) alone "
            f"{stats_ms:.3f} ms")
        _check_site(
            tot, f"modulate {name}", n,
            lambda: sf.fused_spade_modulate(*args),
            lambda: sf.modulate_ref(*args), None, "spade_modulate_kernel",
            _modulate_ops(B, h, w, c), _modulate_bytes(B, h, w, c), 1)
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
        del a, wgb, args
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
        tot = totals[key] = {}
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
                tot, f"{key} {name} {cin}->{cout} {h}x{w}", n,
                lambda: run(x, wt, bias, act),
                lambda: c3.conv3x3_ref(x, wt, bias, act,
                                       fused_bias=fused_bias),
                lambda: F.conv2d(xa, wl, bl, 1, 1), kname,
                _conv_ops(B, h, w, cin, cout),
                _conv_bytes(B, h, w, cin, cout), 1)
            if key == "conv3x3_wide":
                log(f"{key} {name}: N tile {c3.wide_bn(x.shape, cout)}")
            else:
                _alone_events(tot, f"{key} {name}", n,
                              c3.small_launcher(x, wt, bias, act)[0])
                log(f"{key} {name}: N tiles {c3.small_tiles(cout)}, "
                    + (f"narrow input, boxes of {c3.narrow_box(cin)} elements"
                       if cin % 8 else "16-channel boxes"))
            del x, xa
        if key == "conv3x3_wide":
            b, h, w, cin, cout, act = WIDE_RAGGED
            x = _randn(gen, b, h, w, cin).to(dtype)
            wt = _randn(gen, cout, cin, 3, 3, scale=(1.0 / (9 * cin)) ** 0.5)
            bias = _randn(gen, cout, scale=0.1)
            _hold(f"{key} ragged {WIDE_RAGGED}", run,
                  lambda: run(x, wt, bias, act),
                  lambda: c3.conv3x3_ref(x, wt, bias, act, fused_bias=True),
                  False)
            del x
        else:
            for b, h, w, cin, cout, act in SMALL_RAGGED:
                x = _randn(gen, b, h, w, cin).to(dtype)
                wt = _randn(gen, cout, cin, 3, 3, scale=(1.0 / (9 * cin)) ** 0.5)
                bias = _randn(gen, cout, scale=0.1)
                _hold(f"{key} ragged {(b, h, w, cin, cout, act)}", run,
                      lambda: run(x, wt, bias, act),
                      lambda: c3.conv3x3_ref(x, wt, bias, act), False)
                del x
    for key, t in totals.items():
        fmt = lambda v: "not measured" if v is None else f"{v:.3f} ms"
        log(f"{key}, one request's launches, batch {B}, bfloat16: "
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
        if key in EARLIER_MODEL:
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
    with _window(cpu=True) as prof:
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
    busy = _busy_us(kernels)
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
    makes no copy. Run eagerly (graphs.disabled()): the same kernels as the
    replayed request. Informational (a part of the profile's elementwise
    work)."""
    from hrviton_tpu_torch.core import graphs
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
        with graphs.disabled():      # a replay runs no Python to time
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
    if len(ms) < 2:
        return f"{', '.join(f'{t:.2f}' for t in ms)} ms (n {len(ms)})"
    q1, med, q3 = statistics.quantiles(ms, n=4)
    return (f"median {med:.2f} ms (quartiles {q1:.2f}-{q3:.2f}, min "
            f"{min(ms):.2f}, max {max(ms):.2f}, n {len(ms)})")


def _cli_units(gen):
    """Kernel 1 at the CLI's batch 1, at the six unit shapes, in bf16 (the
    conv engine, on the CLI's --bf16 path), each unit against
    spade_conv_ref on the same inputs, TF32 off. Returns the totals over
    one forward's six units."""
    from hrviton_tpu_torch.ops import spade_block as sb
    tot = {}
    _tf32(False, False)
    for name, h, w, c, cout, ks, act, residual in UNITS:
        args, res = _unit_inputs(gen, torch.bfloat16, h, w, c, cout, ks,
                                 residual, batch=1)
        _check_site(
            tot, f"cli unit {name} batch 1", 1,
            lambda: sb.spade_conv_unit(act, *args, res),
            lambda: sb.spade_conv_ref(*args, pre_act=act, residual=res),
            None, ("spade_unit", "instance_stats"),
            unit_flops(1, h, w, c, cout, ks),
            unit_bytes(1, h, w, c, cout, ks, residual=residual), UNIT_KERNELS)
        del args, res
    fmt = lambda v: "not measured" if v is None else f"{v:.3f} ms"
    log(f"cli unit (the CLI's --bf16 path), one batch-1 forward's six units, "
        f"bfloat16: wrapper {tot['ms']:.3f} ms, kernel alone "
        f"{fmt(tot['kernel_alone_ms'])}, plain {tot['plain_ms']:.3f} ms, "
        f"bound {tot['bound_ms']:.4f} ms")
    torch.cuda.empty_cache()
    return tot


def cli_phase(card):
    """The inference CLI's path: its own configuration at full size, batch
    1, random weights from seed 0, f32 and --bf16 (module docstring, phase
    6). Returns (kernel 1's bf16 totals at batch 1, {dtype: launches of
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
    from hrviton_tpu_torch.models.inception import (InceptionV3,
                                                    inception_probs)
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
        for n in preds[:REJ_BATCH + 1]:
            x = ev.inception_input(Image.open(os.path.join(pred_dir, n)),
                                   "cuda")
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            inception_probs(net, x)
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


TRAIN_PAIRS = 64            # pairs per split of phase 9's synthetic trees
STAGE1 = dict(hw=(256, 192), batch=8, steps=12)    # bench_train.py:7-11,77
STAGE2 = dict(hw=(1024, 768), batch=2, steps=8, fused_steps=4)
# the fused unit's launches per stage-2 step with --fused_block (remat on):
# up_3 and up_4 run 3 units each in the G loss's forward, again when
# backward recomputes those two checkpointed blocks, and once more in the
# D step's regeneration (no gradient, no recompute); the statistics kernel
# launches once per unit
UNITS_PER_FUSED_STEP = 6 + 6 + 6


def _grad_site(label, kernel, plain_fwd, plain_grad, args, diff, gen):
    """One kernel's autograd.Function against its plain version's autograd
    on the same inputs: the output within 2 bf16 ulps of max|ref| (the
    kernel check's limit) and every input gradient within 2 bf16 ulps of its
    max|ref| (the Function's backward is the plain version's autograd on
    the saved inputs: the same computation)."""
    def leaves():
        return [None if a is None else a.detach().clone().requires_grad_(i in diff)
                for i, a in enumerate(args)]
    lk, lp = leaves(), leaves()
    out = kernel(*lk)
    g = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)
    gk = torch.autograd.grad(out, [lk[i] for i in diff], g)
    with torch.no_grad():
        ref = plain_fwd(*[None if a is None else a.detach() for a in lp])
    gp = torch.autograd.grad(plain_grad(*lp), [lp[i] for i in diff], g)
    _within(f"training: {label} output", out.detach(), ref, torch.bfloat16)
    worst = 0.0
    for i, a, b in zip(diff, gk, gp):
        scale = b.float().abs().max().item()
        err = (a.float() - b.float()).abs().max().item()
        worst = max(worst, err / max(scale * 2 ** -7, 1e-30))
        if a.shape != b.shape or not torch.isfinite(a).all() or \
                err > 2 * 2 ** -7 * scale:
            raise RuntimeError(f"training: {label} gradient of input {i}: "
                               f"{err} > 2 ulps of {scale}")
    log(f"training: {label} gradients of {len(diff)} inputs within "
        f"{worst:.2f} bf16 ulps of max|ref| (limit 2) ok")


def _function_grads():
    """Part 1 of phase 9: the four Functions' gradients at the main-path
    shapes, batch 2 (the training batch), bf16; and the weight-pack cache
    after an optimizer step."""
    from hrviton_tpu_torch.ops import conv3x3 as c3
    from hrviton_tpu_torch.ops import spade_block as sb
    from hrviton_tpu_torch.ops import spade_fused as sf
    gen = torch.Generator(device="cuda").manual_seed(9)
    bf = torch.bfloat16
    b = STAGE2["batch"]
    for name, h, w, c, cout, ks, act, residual in UNITS:
        args, res = _unit_inputs(gen, bf, h, w, c, cout, ks, residual, batch=b)
        args = args + [res]
        diff = [i for i, a in enumerate(args) if a is not None]
        unit = lambda *a, act=act: sb.spade_conv_unit(act, *a)
        ref = lambda *a, act=act: sb.spade_conv_ref(*a[:10], pre_act=act,
                                                    residual=a[10])
        _grad_site(f"spade_conv_unit {name} b{b}", unit, ref, ref, args, diff,
                   gen)
        del args
        torch.cuda.empty_cache()
    for name, h, w, c, _ in MODULATE_SITES:
        args, _ = _unit_inputs(gen, bf, h, w, c, c, 3, False, batch=b)
        args = args[:8]
        _grad_site(f"fused_spade_modulate {name} b{b}", sf.fused_spade_modulate,
                   sf.modulate_ref, sf.modulate_ref, args, list(range(8)), gen)
    for kind, sites in (("wide", WIDE_SITES), ("small", SMALL_SITES)):
        wrapper = c3.conv3x3_wide if kind == "wide" else c3.conv3x3_small
        for name, h, w, cin, cout, act, _ in sites:
            args = [_randn(gen, b, h, w, cin).to(bf),
                    _randn(gen, cout, cin, 3, 3, scale=(1.0 / (9 * cin)) ** 0.5
                           ).to(bf), _randn(gen, cout, scale=0.1)]
            fwd = lambda x, w_, b_, act=act, k=kind: c3.conv3x3_ref(
                x, w_, b_, act, fused_bias=k == "wide")
            grad = lambda x, w_, b_, act=act: c3.conv3x3_ref(x, w_, b_, act)
            _grad_site(f"conv3x3_{kind} {name} b{b}",
                       lambda x, w_, b_, act=act, f=wrapper: f(x, w_, b_, act),
                       fwd, grad, args, [0, 1, 2], gen)
    # the engine's weight-pack cache after an optimizer step: the kernel
    # must read the updated weights
    name, h, w, cin, cout, act, _ = WIDE_SITES[2]
    x = _randn(gen, b, h, w, cin).to(bf)
    wt = torch.nn.Parameter(_randn(gen, cout, cin, 3, 3, scale=0.02).to(bf))
    opt = torch.optim.SGD([wt], lr=10.0)
    c3.conv3x3_wide(x, wt, None, act).float().square().mean().backward()
    before = c3.conv3x3_wide(x, wt.detach(), None, act)
    opt.step()
    after = c3.conv3x3_wide(x, wt.detach(), None, act)
    ref = c3.conv3x3_ref(x, wt.detach(), None, act, fused_bias=True)
    moved = (after.float() - before.float()).abs().max().item()
    _within(f"training: conv3x3_wide {name} after an SGD step on its weight "
            f"(output moved by {moved:.3e}) against the plain version with "
            f"the new weight", after, ref, bf)
    if moved == 0.0:
        raise RuntimeError("training: the kernel read the old weights")


def _tf32_spy(module, name, seen):
    """``module.name`` (a GAN loss) wrapped so that a hook on each logit map
    records cuDNN's and the matmul's TF32 flags when backward reaches it."""
    from unittest import mock
    real = getattr(module, name)

    def flags(g):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return g

    def spy(pred, *a, **k):
        for p in pred:
            t = p[-1] if isinstance(p, (list, tuple)) else p
            if t.requires_grad:
                t.register_hook(flags)
        return real(pred, *a, **k)
    return mock.patch.object(module, name, spy)


def _run_cli(label, main, argv, spy_module, spy_name, card, eager=False):
    """One training CLI's main under torch's default TF32 settings, with
    the TF32 spy (``eager``: under graphs.disabled(), the reference of the
    memory it takes); prints its losses, ms/step and peak memory, allocated
    and reserved (a graph's private pool is reserved for as long as the
    graph lives), from an emptied cache."""
    import numpy as np
    from hrviton_tpu_torch.core import graphs
    seen = []
    _tf32(True, False)
    if eager:
        label += ", eager (graphs.disabled())"
    _free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _tf32_spy(spy_module, spy_name, seen), \
            (graphs.disabled() if eager else contextlib.nullcontext()):
        rec = main(argv)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rec["peak_gib"] = peak, torch.cuda.max_memory_reserved() / 2 ** 30
    pools = "" if eager else "; pools after it " + ", ".join(
        f"{k} {v:.0f} MiB" for k, v in _cli_pools().items())
    for i, m in enumerate(rec["metrics"]):
        log(f"training: {label} step {i + 1}: " +
            " ".join(f"{k}={v:.6g}" for k, v in sorted(m.items())))
        if not np.isfinite(list(m.values())).all():
            raise RuntimeError(f"training: {label}: non-finite loss at step {i + 1}")
    ms = rec["step_ms"]
    log(f"training: {label} ms/step by CUDA events after the first step: "
        f"{_spread(ms[1:])}, first {ms[0]:.2f} ms; peak "
        f"torch.cuda.max_memory_allocated {peak:.2f} GiB, max_memory_reserved "
        f"{rec['peak_gib'][1]:.2f} GiB{pools}; main {wall:.1f} s "
        f"| {card}")
    flags = sorted(set(seen))
    log(f"training: {label} TF32 flags (cudnn, matmul) seen in backward at "
        f"{len(seen)} logit maps: {flags}")
    if not seen or flags != [(False, False)]:
        raise RuntimeError(f"training: {label}: TF32 in backward {flags}")
    # the run's trainer is garbage now (its optimizers are in reference
    # cycles): its graphs and their pools' memory go with it
    _free()
    return rec


def _cli_pools():
    """MiB of the training CLIs' pools that hold segments: the trainers'
    (step and eval graphs), expand's, lpips_resize's."""
    from hrviton_tpu_torch.cli import common
    from hrviton_tpu_torch.cli import train_generator as t2
    from hrviton_tpu_torch.train import condition_trainer as ct
    from hrviton_tpu_torch.train import generator_trainer as gt
    out = {}
    for key, capt in (("stage 1 step and eval", ct._step),
                      ("stage 2 step and eval", gt._step),
                      ("expand", common.expand),
                      ("lpips_resize", t2._lpips_resize)):
        sizes = _pool_sizes([capt]) if capt.pool is not None else None
        if sizes and sizes[0]:
            out[key] = sizes[0]
    return out


def _renamed(argv, name):
    """A CLI's arguments with another --name (its own checkpoints)."""
    i = argv.index("--name")
    return argv[:i + 1] + [name] + argv[i + 2:]


def training_trees(tmp):
    """Phase 9's and phase 10's synthetic trees under ``tmp``: (stage 1's,
    stage 2's) roots."""
    from hrviton_tpu_torch.data.synthetic import make_synthetic_dataset
    t0 = time.perf_counter()
    (h1, w1), (h2, w2) = STAGE1["hw"], STAGE2["hw"]
    r1 = make_synthetic_dataset(os.path.join(tmp, "d1"), n=TRAIN_PAIRS,
                                w=w1, h=h1, modes=("train", "test"))
    r2 = make_synthetic_dataset(os.path.join(tmp, "d2"), n=TRAIN_PAIRS,
                                w=w2, h=h2, modes=("train", "test"))
    log(f"training: synthetic trees of {TRAIN_PAIRS} pairs a split at "
        f"{h1}x{w1} and {h2}x{w2} in {time.perf_counter() - t0:.1f} s")
    return r1, r2


@contextlib.contextmanager
def _as_a_user_runs():
    """The CLIs run as a user runs them: cuDNN's autotuning off, torch's
    default (the paths' phases turn it on and leave it so); the TF32 flags
    restored after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        _tf32(*saved)
        torch.backends.cudnn.benchmark = benchmark
        torch.cuda.empty_cache()


def training_phase(card, tmp, r1, r2):
    """Phase 9 (module docstring): the four Functions' gradients, then both
    training CLIs at full width on the synthetic trees. Returns the fused
    unit's and the statistics' launches of part 4 and stage 2's ms/step."""
    from hrviton_tpu_torch.cli import test_condition as tc
    from hrviton_tpu_torch.cli import train_condition as t1
    from hrviton_tpu_torch.cli import train_generator as t2
    from hrviton_tpu_torch.train import condition_trainer, generator_trainer

    _function_grads()
    torch.cuda.empty_cache()
    with _as_a_user_runs():
        (h1, w1), (h2, w2) = STAGE1["hw"], STAGE2["hw"]
        ck, tb = os.path.join(tmp, "ck"), os.path.join(tmp, "tb")
        before = _all_launches()

        # part 2: stage 1, f32, through the CLI
        n1 = STAGE1["steps"]
        argv1 = ["--name", "s1", "--dataroot", r1, "--test_dataroot", r1,
                 "--fine_height", str(h1), "--fine_width", str(w1),
                 "-b", str(STAGE1["batch"]), "-j", "4", "--keep_step", str(n1),
                 "--display_count", "1", "--tensorboard_count", str(n1),
                 "--val_count", str(n1), "--val_samples", "16",
                 "--save_count", str(n1), "--checkpoint_dir", ck,
                 "--tensorboard_dir", tb, "--allow_random_vgg", "--device",
                 "cuda"]
        rec1 = _run_cli(
            f"stage 1 (tocg ngf=96 {h1}x{w1}, batch {STAGE1['batch']}, f32, "
            f"condition D 33 ch ndf 64 3 layers 2 scales)", t1.main, argv1,
            condition_trainer, "lsgan_loss", card)
        if len(rec1["metrics"]) != n1 or len(rec1["val_iou"]) != 1:
            raise RuntimeError(f"training: stage 1 gave {len(rec1['metrics'])} "
                               f"steps, val/iou {rec1['val_iou']}")
        peaks = {"stage 1": (rec1, _run_cli(
            "stage 1", t1.main, _renamed(argv1, "s1e"), condition_trainer,
            "lsgan_loss", card, eager=True))}
        s1 = os.path.join(ck, "s1")
        out = tc.main(["--dataroot", r1, "--datamode", "test",
                       "--data_list", "test_pairs.txt", "--fine_height", str(h1),
                       "--fine_width", str(w1), "-b", "8", "-j", "4",
                       "--tocg_checkpoint", os.path.join(s1, "tocg_final.ckpt"),
                       "--D_checkpoint", os.path.join(s1, "D_final.ckpt"),
                       "--norm_const", "1.0", "--output_dir",
                       os.path.join(tmp, "tc"), "--device", "cuda"])
        n_scores = len(open(os.path.join(out, "rejection_prob.txt")).readlines())
        if n_scores != TRAIN_PAIRS:
            raise RuntimeError(f"training: test_condition on stage 1's "
                               f"checkpoints gave {n_scores} scores")
        log(f"training: stage 1's tocg_final.ckpt and D_final.ckpt "
            f"({', '.join(sorted(os.listdir(s1)))}) load into "
            f"cli/test_condition: {n_scores} rejection scores")
        mid = _all_launches()
        if mid != before:
            raise RuntimeError(f"training: stage 1 launched a kernel: "
                               f"{ {k: mid[k] - before[k] for k in mid} }")
        torch.cuda.empty_cache()

        # part 3: stage 2 with the CLI's defaults, bf16
        common = ["--dataroot", r2, "--test_dataroot", r2, "-b",
                  str(STAGE2["batch"]), "-j", "4", "--decay_step", "0",
                  "--display_count", "1", "--save_count", "100000",
                  "--checkpoint_dir", ck, "--tensorboard_dir", tb,
                  "--allow_random_vgg", "--bf16", "--tocg_checkpoint",
                  os.path.join(s1, "tocg_final.ckpt"), "--device", "cuda"]
        n2 = STAGE2["steps"]
        argv2 = ["--name", "s2", "--keep_step", str(n2), "--tensorboard_count",
                 str(n2), "--lpips_count", str(n2), "--lpips_samples", "4",
                 "--lpips_batch", "2"] + common
        from hrviton_tpu_torch.ops import conv3x3 as c3
        taps0 = (c3.wgrad3x3.launches, c3.wgrad_taps.launches)
        taps_mid = c3.wgrad_taps.launches
        # the taps op's backward calls and layout copies a step (registered
        # counters: the recorded steps count as the eager ones)
        taps_op = (c3.conv3x3_taps.backwards, c3.conv3x3_taps.layout_copies)
        op0 = [c.launches for c in taps_op]
        rec2 = _run_cli(
            f"stage 2 (SPADE ngf=64 'most' {h2}x{w2}, batch "
            f"{STAGE2['batch']}, bf16, fused unit off, remat, d_remat, taps "
            f"wgrad; SPADE D ndf 64 3 layers 2 scales; frozen tocg ngf=96 from "
            f"stage 1)", t2.main, argv2, generator_trainer, "gan_loss", card)
        wgrad = [a - b for a, b in zip((c3.wgrad3x3.launches,
                                        c3.wgrad_taps.launches), taps0)]
        op2 = [(c.launches - b) / n2 for c, b in zip(taps_op, op0)]
        log(f"training: stage 2's bf16 weight gradients: wgrad3x3 {wgrad[0]} "
            f"launches, wgrad_taps {wgrad[1]} calls")
        if wgrad[0] != wgrad[1] or wgrad[0] <= 0:
            raise RuntimeError(f"training: stage 2 took wgrad3x3 {wgrad[0]} "
                               f"times for wgrad_taps' {wgrad[1]}")
        peaks["stage 2"] = (rec2, _run_cli(
            "stage 2", t2.main, _renamed(argv2, "s2e"), generator_trainer,
            "gan_loss", card, eager=True))
        d0 = rec2["metrics"][0]["loss/dis"]
        log(f"training: stage 2 hinge D loss at init {d0:.6f} (expect ~2.0), "
            f"LPIPS {rec2['lpips']}, checkpoints "
            f"{sorted(os.listdir(os.path.join(ck, 's2')))}")
        if abs(d0 - 2.0) > 0.05 or len(rec2["metrics"]) != n2 or \
                len(rec2["lpips"]) != 1:
            raise RuntimeError(f"training: stage 2: D loss {d0}, "
                               f"{len(rec2['metrics'])} steps, LPIPS {rec2['lpips']}")
        # the recorded and the eager run: no kernel but the weight
        # gradient's, once for each of wgrad_taps' calls (all bf16)
        after2 = _all_launches()
        want2 = dict(mid, wgrad3x3=mid["wgrad3x3"] + c3.wgrad_taps.launches
                     - taps_mid)
        if after2 != want2 or want2["wgrad3x3"] == mid["wgrad3x3"]:
            raise RuntimeError(f"training: stage 2 (fused unit off) launches "
                               f"{ {k: after2[k] - mid[k] for k in mid} }, "
                               f"expected wgrad3x3 "
                               f"{want2['wgrad3x3'] - mid['wgrad3x3']} alone")
        torch.cuda.empty_cache()

        # part 4: stage 2 with --fused_block: the unit's exact launches, the
        # counts set to 0 just before and read just after
        n4 = STAGE2["fused_steps"]
        wrappers = _wrappers()
        for w in wrappers.values():
            w.launches = 0
        taps4 = c3.wgrad_taps.launches
        argv4 = ["--name", "s2f", "--keep_step", str(n4), "--tensorboard_count",
                 "100000", "--lpips_count", "100000", "--fused_block"] + common
        rec4 = _run_cli(f"stage 2 --fused_block ({n4} steps)", t2.main, argv4,
                        generator_trainer, "gan_loss", card)
        got = {k: w.launches for k, w in wrappers.items()}
        want = {k: 0 for k in got}
        want["spade_unit"] = want["instance_stats"] = UNITS_PER_FUSED_STEP * n4
        want["wgrad3x3"] = c3.wgrad_taps.launches - taps4
        log(f"training: stage 2 --fused_block launches over {n4} steps: "
            f"{ {k: v for k, v in got.items() if v} } (expect spade_unit and "
            f"instance_stats {UNITS_PER_FUSED_STEP} a step: 6 in the G loss's "
            f"forward, 6 in the remat recompute, 6 in the D step's "
            f"regeneration; wgrad3x3 one a wgrad_taps call)")
        if got != want or want["wgrad3x3"] <= 0:
            raise RuntimeError(f"training: --fused_block launches {got}, "
                               f"expected {want}")
        if len(rec4["metrics"]) != n4:
            raise RuntimeError("training: --fused_block steps missing")
        # its launches in the eager run are not of the main path: not counted
        saved = {k: w.launches for k, w in wrappers.items()}
        peaks["stage 2 --fused_block"] = (rec4, _run_cli(
            f"stage 2 --fused_block ({n4} steps)", t2.main,
            _renamed(argv4, "s2fe"), generator_trainer, "gan_loss", card,
            eager=True))
        for k, w in wrappers.items():
            w.launches = saved[k]

        # part 5: stage 2 with the library's weight gradient in place of
        # the tap products (--no_taps_wgrad), for the taps' cost
        op0 = [c.launches for c in taps_op]
        rec5 = _run_cli(
            f"stage 2 --no_taps_wgrad ({n4} steps)", t2.main,
            ["--name", "s2n", "--keep_step", str(n4), "--tensorboard_count",
             "100000", "--lpips_count", "100000", "--no_taps_wgrad"] + common,
            generator_trainer, "gan_loss", card)
        log("training: the CLIs' peak device memory from an emptied cache, "
            "GiB, allocated / reserved, recorded (a user's run) against "
            "eager: " + "; ".join(
                f"{k} {g['peak_gib'][0]:.2f} / {g['peak_gib'][1]:.2f} against "
                f"{e['peak_gib'][0]:.2f} / {e['peak_gib'][1]:.2f}"
                for k, (g, e) in peaks.items()) + f" | {card}")
        op5 = [(c.launches - b) / n4 for c, b in zip(taps_op, op0)]
        taps = statistics.median(rec2["step_ms"][1:])
        lib = statistics.median(rec5["step_ms"][1:])
        log(f"training: stage 2 median ms/step with the taps weight gradient "
            f"{taps:.2f} (taps backwards {op2[0]:g}, layout copies "
            f"{op2[1]:g} a step) against cuDNN's {lib:.2f} (taps backwards "
            f"{op5[0]:g}, layout copies {op5[1]:g} a step) "
            f"({taps - lib:+.2f} ms) | {card}")
        torch.cuda.empty_cache()

        # part 6: the recorded steps against eager, in turns; part 7: the
        # loader's host time
        recorded_steps(card, r1, r2)
        _loader_time(card, r2)
    return ({"spade_unit": got["spade_unit"],
             "instance_stats": got["instance_stats"], "wgrad3x3": wgrad[0]},
            {"stage 1": statistics.median(rec1["step_ms"][1:]),
             "stage 2": statistics.median(rec2["step_ms"][1:]),
             "stage 2 --fused_block": statistics.median(rec4["step_ms"][1:])})


# the recorded training steps (core/graphs.py) against eager, in turns
# (phases 9 and 10): the first pair records and is not timed
STEP_PAIRS = 11
NCCL_PAIRS = 4
# stage 1's eager step is not reproducible on the card (atomic adds in the
# backward of the tocg's grid_sample): its three states are set alike before
# each step, and the tensors that gradient reaches, the tocg's parameters and
# their Adam moments, are held to within this factor of two eager steps' own
# distance D from that state (the sum over those tensors of mean|x - y| /
# mean|y|); everything else of the step bit for bit
EAGER_SPREAD_FACTOR = 4.0


def _named_state(*nets):
    """(name, tensor) of every tensor a training step writes: each
    network's parameters and buffers, its Adam's moments and step counts."""
    out = []
    for tag, module, opt in nets:
        names = {id(p): n for n, p in module.named_parameters()}
        out += [(f"{tag}.{n}", t) for n, t in module.named_parameters()]
        out += [(f"{tag}.{n}", t) for n, t in module.named_buffers()]
        out += [(f"{tag}.{names[id(p)]}.{k}", t) for p in opt.params
                for k, t in opt.opt.state[p].items()]
    return out


def _distance(a, b):
    """D of two states' (name, tensor) lists (EAGER_SPREAD_FACTOR)."""
    total = 0.0
    for (_, x), (_, y) in zip(a, b):
        den = y.float().abs().mean().item()
        if den > 0:
            total += (x.float() - y.float()).abs().mean().item() / den
    return total


def _nondeterministic_ops(step, batch):
    """The ops of one eager step that torch names as having no
    deterministic CUDA implementation (deterministic mode, warnings only;
    a throwaway state)."""
    import warnings
    from hrviton_tpu_torch.core import graphs
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as seen, graphs.disabled():
            warnings.simplefilter("always")
            step(batch)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    ops = set()
    for w in seen:
        text = str(w.message)
        if "does not have a deterministic implementation" in text:
            ops.add(text.split(" does not have")[0])
        elif "CuBLAS" in text:
            ops.add("cuBLAS (CUBLAS_WORKSPACE_CONFIG unset)")
    return sorted(ops)


def _set_alike(run, ref):
    """``run``'s state tensors set to ``ref``'s (``run`` is stepped eagerly:
    no graph reads its tensors)."""
    with torch.no_grad():
        for (_, x), (_, y) in zip(run["tensors"](), ref["tensors"]()):
            x.copy_(y)


def _held_step(tag, i, runs, mets, varies):
    """Step ``i`` of a step that is not reproducible eagerly, its three
    states set alike before it: bit for bit the metrics of the three and
    every state tensor outside ``varies``; D of the ``varies`` tensors, the
    replay against each eager run, within EAGER_SPREAD_FACTOR times the two
    eager runs' own. Returns (D eager-eager, the larger D of the replay)."""
    m_e, m_r, m_2 = (mets[m][i] for m in ("eager", "replay", "eager2"))
    m_diff = [k for k in m_e if not (torch.equal(m_r[k], m_e[k])
                                     and torch.equal(m_2[k], m_e[k]))]
    s_e, s_r, s_2 = (runs[m]["tensors"]() for m in ("eager", "replay", "eager2"))
    t_diff = [n for (n, x), (_, y), (_, z) in zip(s_e, s_r, s_2)
              if n not in varies and not (torch.equal(x, y) and torch.equal(x, z))]
    pick = lambda s: [(n, t) for n, t in s if n in varies]
    d_ee = _distance(pick(s_2), pick(s_e))
    d_re = max(_distance(pick(s_r), pick(s_e)), _distance(pick(s_r), pick(s_2)))
    if m_diff or t_diff or d_re > EAGER_SPREAD_FACTOR * d_ee:
        raise RuntimeError(
            f"{tag}: step {i + 1} from one state: metrics {m_diff[:5]} and "
            f"tensors outside the varying set {t_diff[:5]} ({len(t_diff)}) "
            f"differ, or D(replay, eager) {d_re:.4g} > {EAGER_SPREAD_FACTOR:g} "
            f"x D(eager, eager) {d_ee:.4g}")
    return d_ee, d_re


def _steps_in_turns(card, tag, build, batches, pairs=STEP_PAIRS, expect=None,
                    spy=None, wgrad=False):
    """Training states built alike from one seed (``build()``: step,
    tensors, generators, counts, the step's Captured), one stepped eagerly
    under graphs.disabled() and one replayed, in turns on the same batches,
    cuDNN's algorithms deterministic (its defaults may sum a weight gradient
    by atomic adds, in another order each run, eager or replayed). Bit for
    bit: every step's metrics, the generators' states after every step,
    and, after the last, every tensor of the states, the Python counters,
    and the launch counters of every step (``expect``: the fused unit's and
    the statistics' a step; with ``wgrad``, a bf16 step, wgrad3x3 once a
    wgrad_taps call, as many eager as replayed). A build that names ``varies`` (the tensors a
    nondeterministic op reaches) gets a second eager state, and all three
    are held step by step (_held_step). Printed: ms/step by CUDA events of
    the pairs after the first (median, quartiles), the recording's seconds,
    the pool's MiB, the memory of the first eager step and of the first
    replayed call, the graph's kernel nodes (DOT dump) beside one eager
    step's launches. Returns the figures."""
    with _deterministic_cudnn(), _capture_clock() as capture_s:
        return _in_turns(card, tag, build, batches, pairs, expect, spy,
                         capture_s, wgrad)


@contextlib.contextmanager
def _capture_clock():
    """The port's tracer on for the block (``utils/profiling``): yields a
    function that gives the seconds of the ``graphs.capture`` spans (each
    warm-up and recording) closed in the block so far. A graph recorded in
    the block holds the device spans' event nodes, and no other node."""
    from hrviton_tpu_torch.utils import profiling
    was = profiling.enabled()
    profiling.enable()
    t0 = time.perf_counter_ns()
    try:
        yield lambda: sum(s.t1_ns - s.t0_ns for s in profiling.spans()
                          if s.name == "graphs.capture" and s.t0_ns >= t0) / 1e9
    finally:
        if not was:
            profiling.disable()


@contextlib.contextmanager
def _deterministic_cudnn():
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


@contextlib.contextmanager
def _memory_of(mem, key):
    """``mem[key]``: GiB of device memory above the start of the block, at
    its peak (allocated) and the cache's growth (reserved) from an emptied
    cache; a recording inside the block also gives ``mem['warm-up']`` (the
    peak allocated before it) and ``mem['recording']`` (while it runs)."""
    from unittest import mock
    from hrviton_tpu_torch.core import graphs
    _free()
    torch.cuda.reset_peak_memory_stats()
    a0, r0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    real = graphs.Captured._record
    gib = lambda b: b / 2 ** 30

    def record(self, *a, **k):
        mem["warm-up"] = gib(torch.cuda.max_memory_allocated() - a0)
        torch.cuda.reset_peak_memory_stats()
        try:
            return real(self, *a, **k)
        finally:
            mem["recording"] = gib(torch.cuda.max_memory_allocated() - a0)
    with mock.patch.object(graphs.Captured, "_record", record):
        yield
    mem[key] = (gib(torch.cuda.max_memory_allocated() - a0),
                gib(torch.cuda.max_memory_reserved() - r0))


def _in_turns(card, tag, build, batches, pairs, expect, spy, capture_s, wgrad):
    from hrviton_tpu_torch.core import graphs
    from hrviton_tpu_torch.ops import conv3x3 as c3
    wrappers = _wrappers()
    runs = {"eager": build(), "replay": build()}
    varies = runs["eager"].get("varies")
    if varies is not None:
        runs["eager2"] = build()
    modes = tuple(runs)
    eager, rep = runs["eager"], runs["replay"]
    capt = rep["capt"]
    caps0 = capt.captures
    ms = {m: [] for m in modes}
    mets = {m: [] for m in modes}
    launches = {m: [] for m in modes}
    taps = {m: [] for m in modes}
    first_s = hooks = recording_s = None
    held, gen_diff, mem = [], [], {}
    for i in range(pairs):
        batch = batches[i % len(batches)]
        if varies is not None and i:
            _set_alike(eager, rep)
            _set_alike(runs["eager2"], rep)
        for mode in modes:
            run = runs[mode]
            before = {k: w.launches for k, w in wrappers.items()}
            taps0 = c3.wgrad_taps.launches
            n_seen = len(spy) if spy is not None else 0
            ctx = contextlib.nullcontext() if mode == "replay" else graphs.disabled()
            watch = (_memory_of(mem, mode) if i == 0 and mode != "eager2"
                     else contextlib.nullcontext())
            with watch, ctx:
                torch.cuda.synchronize()
                t = time.perf_counter()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                mets[mode].append(run["step"](batch))
                e1.record()
                torch.cuda.synchronize()
            if mode == "replay" and i == 0:
                first_s = time.perf_counter() - t
                recording_s = capture_s()
                hooks = len(spy) - n_seen if spy is not None else None
            ms[mode].append(e0.elapsed_time(e1))
            launches[mode].append({k: w.launches - before[k]
                                   for k, w in wrappers.items()})
            taps[mode].append(c3.wgrad_taps.launches - taps0)
        for m in modes[1:]:
            if not all(torch.equal(a.get_state(), b.get_state())
                       for a, b in zip(runs[m]["gens"], eager["gens"])):
                gen_diff.append((i + 1, m))
        if varies is not None:
            held.append(_held_step(tag, i, runs, mets, varies))
    entry = capt.last_entry
    if capt.captures != caps0 + 1 or entry.replays != pairs:
        raise RuntimeError(f"{tag}: {capt.captures - caps0} recordings, "
                           f"{entry.replays} replays for {pairs} steps")
    if spy is not None and not hooks:
        raise RuntimeError(f"{tag}: no logit hook ran while recording")
    if rep["counts"]() != eager["counts"]() or rep["counts"]()[0] != pairs:
        raise RuntimeError(f"{tag}: counters {rep['counts']()} against "
                           f"{eager['counts']()}")
    if gen_diff:
        raise RuntimeError(f"{tag}: generator states differ after (step, "
                           f"state) {gen_diff[:5]}")
    want = dict.fromkeys(wrappers, 0)
    if expect:
        want.update(expect)
    if wgrad:
        want["wgrad3x3"] = taps["eager"][0]
    bad = [(i, launches["eager"][i], launches["replay"][i]) for i in range(pairs)
           if not launches["eager"][i] == launches["replay"][i] == want]
    if bad or (wgrad and not all(taps["eager"][0] == n > 0
                                 for m in modes for n in taps[m])):
        raise RuntimeError(f"{tag}: launches a step (step, eager, replay) "
                           f"{bad[:3]}, expected {want}; wgrad_taps' calls "
                           f"a step {taps}")
    s_e, s_r = eager["tensors"](), rep["tensors"]()
    steps = [n for n, _ in s_e if n.endswith(".step")]
    named = dict(s_r)
    if not all(torch.equal(named[n], dict(s_e)[n]) and float(named[n]) == pairs
               for n in steps):
        raise RuntimeError(f"{tag}: Adam's step counts differ from {pairs}")
    n_gens = len(eager["gens"])
    if varies is None:
        m_diff = [(i, k) for i in range(pairs) for k in mets["eager"][i]
                  if not torch.equal(mets["eager"][i][k], mets["replay"][i][k])]
        t_diff = [n for (n, x), (_, y) in zip(s_e, s_r) if not torch.equal(x, y)]
        if m_diff or t_diff:
            raise RuntimeError(f"{tag}: replay against eager: metrics "
                               f"{m_diff[:5]}, tensors {t_diff[:5]} "
                               f"({len(t_diff)} of {len(s_e)}) differ")
        how = (f"replay equal to eager bit for bit over {pairs} steps: "
               f"{len(mets['eager'][0])} metrics a step, {len(s_e)} state "
               f"tensors (parameters, buffers, Adam's moments and step "
               f"counts), {n_gens} generator states, the counters")
    else:
        ops = _nondeterministic_ops(build()["step"], batches[0])
        n_var = sum(n in varies for n, _ in s_e)
        how = (f"eager not reproducible (ops without a deterministic CUDA "
               f"implementation in its step: {ops}); {pairs} steps, each "
               f"from one state (the two eager states set to the replayed "
               f"one before it): bit for bit in all three the "
               f"{len(mets['eager'][0])} metrics of every step and "
               f"{len(s_e) - n_var} of {len(s_e)} state tensors after every "
               f"step (the tocg's buffers, the discriminator's parameters, "
               f"buffers and Adam state, every step count), {n_gens} "
               f"generator states, the counters; the tocg's parameters and "
               f"moments ({n_var} tensors) D(replay, eager) / D(eager, "
               f"eager) a step, limit {EAGER_SPREAD_FACTOR:g}x: "
               + " ".join(f"{r:.3g}/{e:.3g}" for e, r in held))
    log(f"{tag}: {how}; launches a step {({k: v for k, v in want.items() if v}) or 'none'}"
        + (f"; {hooks} logit hooks ran while recording" if spy is not None else ""))
    # the graph's nodes beside one eager step's launches (an extra step of
    # the eager state, after the comparison)
    gk, go = _graph_census(tag, [entry])
    with graphs.disabled():
        ek, eo, e_busy, e_wall = _profiled(lambda: eager["step"](batches[0]))
    rk, ro, r_busy, r_wall = _profiled(lambda: rep["step"](batches[0]))
    hw = _hand_written(gk)
    if expect and (hw.get("spade_unit_gb_kernel", 0) != expect["spade_unit"] or
                   hw.get("instance_stats_finalize_kernel", 0)
                   != expect["instance_stats"]):
        raise RuntimeError(f"{tag}: the graph's hand-written nodes {hw}")
    pool = _pool_sizes([capt])
    fig = dict(eager=statistics.median(ms["eager"][1:]),
               replay=statistics.median(ms["replay"][1:]),
               eager_ms=ms["eager"][1:], replay_ms=ms["replay"][1:],
               capture_s=recording_s, pool_mib=pool and pool[0],
               nodes=sum(gk.values()), launches=sum(ek.values()), memory=mem)
    log(f"{tag}: ms/step by CUDA events, {pairs - 1} pairs in turns after "
        f"the first: eager {_spread(ms['eager'][1:])}; replay "
        f"{_spread(ms['replay'][1:])}; first replayed call (warm-up, "
        f"recording, replay) {first_s * 1e3:.0f} ms, recording "
        f"{recording_s * 1e3:.0f} ms, pools "
        + ("not measured" if pool is None else f"{pool[0]:.0f} MiB") +
        f"; graph kernel nodes {fig['nodes']} (other nodes {go}; hand-written "
        f"{hw}) against one eager step's kernel launches {fig['launches']} "
        f"(a profiler window, a lower bound), the replay's window "
        f"{sum(rk.values())}; device busy eager {e_busy:.1f} of {e_wall:.1f} "
        f"ms, replay {r_busy:.1f} of {r_wall:.1f} ms | {card}")
    log(f"{tag}: device memory above the states, GiB (peak allocated / the "
        f"reserved cache's growth from an emptied cache): the first eager "
        f"step {mem['eager'][0]:.2f} / {mem['eager'][1]:.2f}; the first "
        f"replayed call {mem['replay'][0]:.2f} / {mem['replay'][1]:.2f}, "
        f"the warm-up's peak {mem['warm-up']:.2f}, the recording's "
        f"{mem['recording']:.2f}; the step's pool after it "
        + ("not measured" if pool is None else
           f"{pool[0] / 1024:.2f}, {pool[1] / 1024:.2f} of it allocated (the "
           f"graph's outputs, the gradients left in .grad)") + f" | {card}")
    del runs, entry, eager, rep
    _free()
    return fig


def _tree_batches(root, h, w, batch, n, cloth=None):
    """``n`` training batches of a synthetic tree through the CLIs' data
    path (the compact format, the loader, batch_to_device: the host's copy
    and the recorded expand), on the card."""
    from hrviton_tpu_torch.cli.common import batch_to_device
    from hrviton_tpu_torch.config import DataConfig
    from hrviton_tpu_torch.data.dataset import VitonHDDataset
    from hrviton_tpu_torch.data.loader import Loader
    ds = VitonHDDataset(DataConfig(dataroot=root, fine_height=h, fine_width=w),
                        mode="train", compact=True)
    loader = Loader(ds, batch, shuffle=False, num_workers=4)
    try:
        raws = [loader.next_batch() for _ in range(n)]
    finally:
        loader.close()
    out = []
    for raw in raws:
        if cloth:
            raw = dict(raw, cloth=raw["cloth"][cloth],
                       cloth_mask=raw["cloth_mask"][cloth])
        out.append(batch_to_device(raw, "cuda", True))
    return out


def _stage1_build(vgg, mesh=None):
    """Stage 1 as the CLI builds it (tocg ngf=96, the condition
    discriminator, batch 8, f32), with --Ddropout: its masks come from the
    trainer's generator inside the recorded step."""
    from hrviton_tpu_torch.config import (CondDiscriminatorConfig,
                                          ConditionTrainConfig, TOCGConfig)
    from hrviton_tpu_torch.train import condition_trainer as ct

    def build():
        trainer = ct.ConditionTrainer(
            TOCGConfig(ngf=96), CondDiscriminatorConfig(input_nc=33,
                                                        ddropout=True),
            ConditionTrainConfig(batch_size=STAGE1["batch"]), device="cuda",
            mesh=mesh)
        state = trainer.init(0)
        # what grid_sample's backward reaches: the tocg's parameters, their
        # Adam moments
        varies = {f"G.{n}{k}" for n, _ in state.g.module.named_parameters()
                  for k in ("", ".exp_avg", ".exp_avg_sq")}
        return dict(step=lambda b: trainer.train_step(state, b, vgg)[1],
                    varies=varies,
                    tensors=lambda: _named_state(
                        ("G", state.g.module, state.g.opt),
                        ("D", state.d.module, state.d.opt)),
                    gens=[trainer.dropout],
                    counts=lambda: (state.step, state.g.opt.count,
                                    state.d.opt.count),
                    capt=ct._step)
    return build


def _stage2_build(vgg, fused, mesh=None):
    """Stage 2 as the CLI builds it (SPADE ngf=64 'most' at 1024x768, batch
    2, bf16, remat, D remat, taps wgrad, the SPADE discriminator, the frozen
    tocg ngf=96 from seed 0), one noise generator for both forwards as the
    CLI feeds it. Each state has a tocg of its own: the bf16 step rounds the
    tocg's statistics in place and puts them back, a write from outside the
    other state's graph."""
    from hrviton_tpu_torch.config import (GeneratorTrainConfig, PipelineConfig,
                                          SPADEDiscriminatorConfig,
                                          SPADEGenConfig, TOCGConfig)
    from hrviton_tpu_torch.models.condition import ConditionGenerator
    from hrviton_tpu_torch.nn.layers import init_weights
    from hrviton_tpu_torch.train import generator_trainer as gt
    (h2, w2), (h1, w1) = STAGE2["hw"], STAGE1["hw"]

    def build():
        tocg = ConditionGenerator(TOCGConfig(ngf=96), device="cuda").eval()
        init_weights(tocg, torch.Generator().manual_seed(0))
        tocg.requires_grad_(False)
        trainer = gt.GeneratorTrainer(
            SPADEGenConfig(ngf=64, fine_height=h2, fine_width=w2,
                           fused_block=fused),
            SPADEDiscriminatorConfig(),
            GeneratorTrainConfig(batch_size=STAGE2["batch"], bf16=True),
            PipelineConfig(fine_height=h2, fine_width=w2, cond_height=h1,
                           cond_width=w1), TOCGConfig(ngf=96), device="cuda",
            mesh=mesh)
        state = trainer.init(0)
        noise = torch.Generator(device="cuda").manual_seed(1)
        frozen = {"vgg": vgg, "tocg": tocg}
        return dict(step=lambda b: trainer.train_step(state, b, noise, noise,
                                                      frozen)[1],
                    tensors=lambda: _named_state(
                        ("G", state.g.module, state.g.opt),
                        ("D", state.d.module, state.d.opt)),
                    gens=[noise],
                    counts=lambda: (state.step, state.g.opt.count,
                                    state.d.opt.count),
                    capt=gt._step)
    return build


def _loader_time(card, root):
    """Part 7 of phase 9: tools/bench_loader.py on stage 2's tree, on the
    card's host."""
    from hrviton_tpu_torch.tools import bench_loader
    h, w = STAGE2["hw"]
    out = bench_loader.main(root=root, n=8, h=h, w=w)
    log(f"loader host time (tools/bench_loader.py, one worker, {h}x{w}, 8 "
        f"samples): full f32 {out['full']['ms']:.1f} ms a sample "
        f"({out['full']['mb']:.1f} MB), compact uint8 "
        f"{out['compact']['ms']:.1f} ms ({out['compact']['mb']:.1f} MB); the "
        f"card's host has {os.cpu_count()} cores | {card}")


def recorded_steps(card, r1, r2, mesh=None):
    """Phase 9 part 6 (no mesh) and phase 10 part (d) (one NCCL rank): the
    recorded steps of stage 1, stage 2 and stage 2 --fused_block against
    eager. Returns their figures."""
    from hrviton_tpu_torch.cli.common import expandable_segments
    from hrviton_tpu_torch.losses.perceptual import make_vgg_loss
    from hrviton_tpu_torch.train import condition_trainer
    (h1, w1), (h2, w2) = STAGE1["hw"], STAGE2["hw"]
    where = "" if mesh is None else ", one NCCL rank"
    expandable_segments("cuda")         # as the training CLIs set it
    pairs = STEP_PAIRS if mesh is None else NCCL_PAIRS
    vgg = make_vgg_loss(None, device="cuda").vgg
    figs = {}
    b1 = _tree_batches(r1, h1, w1, STAGE1["batch"], 3)
    seen = []
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    _tf32(True, False)                       # torch's defaults
    try:
        with _tf32_spy(condition_trainer, "lsgan_loss", seen):
            figs["stage 1"] = _steps_in_turns(
                card, f"recorded steps: stage 1 (tocg ngf=96 {h1}x{w1}, "
                f"batch {STAGE1['batch']}, f32, condition D with "
                f"--Ddropout{where})", _stage1_build(vgg, mesh), b1, pairs,
                spy=seen)
    finally:
        _tf32(*saved)
    flags = sorted(set(seen))
    log(f"recorded steps: stage 1 TF32 flags (cudnn, matmul) in backward "
        f"at {len(seen)} logit maps, eager and while recording: {flags}")
    if flags != [(False, False)]:
        raise RuntimeError(f"recorded steps: TF32 in backward {flags}")
    del b1
    b2 = _tree_batches(r2, h2, w2, STAGE2["batch"], 3, cloth="paired")
    for fused in (False, True):
        if fused is False and mesh is not None:
            continue
        key = "stage 2 --fused_block" if fused else "stage 2"
        figs[key] = _steps_in_turns(
            card, f"recorded steps: {key} (SPADE ngf=64 'most' {h2}x{w2}, "
            f"batch {STAGE2['batch']}, bf16, the CLI's defaults{where})",
            _stage2_build(vgg, fused, mesh), b2, pairs,
            expect=({"spade_unit": UNITS_PER_FUSED_STEP,
                     "instance_stats": UNITS_PER_FUSED_STEP}
                    if fused else None), wgrad=True)
    return figs


# phase 10: data parallel through the multi-host flags (one NCCL rank), the
# alias norms, LPIPS head training
DP_STEPS = {"stage 1": 4, "stage 2": 3}
ALIAS_STEPS = 2
LPIPS_TRAIN = dict(net="alex", hw=64, batch=8, steps=10)
# SPADEResBlock with use_mask_norm at up_4's shape: (batch, h, w, cin, cout)
MASK_BLOCK = (1, 1024, 768, 80, 32)


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _same_first_step(label, plain, grouped, after_update=()):
    """The first step's losses of a run through the multi-host flags
    against the same CLI run without them: 1e-5 relative; a loss in
    ``after_update`` (computed after the step's G update, whose gradient
    cuDNN may sum in another order from run to run) 1e-3."""
    worst = {}
    for k, want in plain["metrics"][0].items():
        got = grouped["metrics"][0][k]
        rel = abs(got - want) / max(abs(want), 1e-12)
        lim = 1e-3 if k in after_update else 1e-5
        worst[k] = rel
        if rel > lim:
            raise RuntimeError(f"data parallel: {label} first-step {k} "
                               f"{got} against {want} without the flags "
                               f"(relative {rel:.3g} > {lim})")
    log(f"data parallel: {label} first-step losses against the run without "
        f"the flags, relative: " + " ".join(
            f"{k}={v:.3g}" for k, v in sorted(worst.items())) +
        " (limit 1e-5" + (f"; {', '.join(after_update)} after the G update "
                          f"1e-3" if after_update else "") + ") ok")


def _mask_block_check(card):
    """SPADEResBlock with use_mask_norm at up_4's shape, f32: the card
    against the same module on the CPU within 1e-4 x max|ref|."""
    from hrviton_tpu_torch.core.precision import no_tf32
    from hrviton_tpu_torch.models.spade import SPADEResBlock, noise_source
    from hrviton_tpu_torch.nn.layers import init_weights
    b, h, w, cin, cout = MASK_BLOCK
    gen = torch.Generator().manual_seed(21)
    blocks = {}
    for dev in ("cpu", "cuda"):
        blocks[dev] = SPADEResBlock(cin, cout, "spectralaliasinstance",
                                    use_mask_norm=True, device=dev)
    init_weights(blocks["cpu"], gen)
    blocks["cuda"].load_state_dict(blocks["cpu"].state_dict())
    x = torch.randn(b, cin, h, w, generator=gen)
    seg = torch.rand(b, 8, h // 2, w // 2, generator=gen)
    mask = (torch.rand(b, 1, h // 2, w // 2, generator=gen) > 0.5).float()
    fields = [torch.randn(b, h, w, 1, generator=gen) for _ in range(3)]
    out = {}
    for dev, blk in blocks.items():
        with torch.no_grad(), no_tf32():
            out[dev] = blk(x.to(dev), seg.to(dev),
                           noise_source([f.to(dev) for f in fields], dev),
                           misalign_mask=mask.to(dev)).cpu()
    _within(f"alias norms: SPADEResBlock use_mask_norm {cin}->{cout} at "
            f"{h}x{w} batch {b}, f32, card against the CPU", out["cuda"],
            out["cpu"], torch.float32)


def _lpips_build(batches):
    """LPIPSHeadTrainer (alex) stepped on ``batches``; the learning rate
    decays once, before the sixth step (update_learning_rate)."""
    from hrviton_tpu_torch.losses import lpips_train as lt

    def build():
        trainer = lt.LPIPSHeadTrainer(net=LPIPS_TRAIN["net"], lr=1e-4,
                                      device="cuda")
        nets = torch.nn.ModuleDict({"model": trainer.model,
                                    "rank": trainer.rank})

        def step(b):
            if trainer.opt.count == 5:
                trainer.update_learning_rate(10)
            # f32 values read back as Python floats: exact
            return {k: torch.tensor(v, dtype=torch.float64)
                    for k, v in zip(("loss", "acc"), trainer.train_step(*b))}
        return dict(step=step, tensors=lambda: _named_state(
                        ("lpips", nets, trainer.opt)),
                    gens=[trainer.dropout], counts=lambda: (trainer.opt.count,),
                    capt=lt._step, heads=trainer.heads)
    return build


def _lpips_head_training(card):
    """Part (c): LPIPSHeadTrainer steps on the card, eager against
    replayed in turns (the learning rate decayed once in between), then
    replayed steps of a new trainer: every lin kernel >= 0 after each."""
    cfg = LPIPS_TRAIN
    gen = torch.Generator(device="cuda").manual_seed(22)
    shape = (cfg["batch"], cfg["hw"], cfg["hw"], 3)
    batches = []
    for _ in range(cfg["steps"]):
        ref = torch.rand(shape, generator=gen, device="cuda") * 2 - 1
        p0 = (ref + 0.05 * torch.randn(shape, generator=gen, device="cuda")
              ).clamp(-1, 1)
        p1 = (ref + 0.5 * torch.randn(shape, generator=gen, device="cuda")
              ).clamp(-1, 1)
        judge = torch.rand(cfg["batch"], generator=gen, device="cuda")
        batches.append((ref, p0, p1, judge))
    build = _lpips_build(batches)
    fig = _steps_in_turns(
        card, f"LPIPS head training ({cfg['net']}, {cfg['hw']}x{cfg['hw']}, "
        f"batch {cfg['batch']})", build, batches, pairs=cfg["steps"] + 1)
    run = build()
    losses, lows = [], []
    for b in batches:
        losses.append(float(run["step"](b)["loss"]))
        lows.append(min(float(h.weight.detach().min()) for h in run["heads"]))
    if not (min(lows) >= 0.0 and
            all(v == v and abs(v) < float("inf") for v in losses)):
        raise RuntimeError(f"LPIPS head training: losses {losses}, smallest "
                           f"head weight after each step {lows}")
    log(f"LPIPS head training: losses {' '.join(f'{v:.5g}' for v in losses)}, "
        f"every lin kernel >= 0 after each step; ms/step eager "
        f"{fig['eager']:.3f}, replayed {fig['replay']:.3f} | {card}")
    return fig


def data_parallel_phase(card, tmp, r1, r2, earlier_ms):
    """Phase 10 (module docstring). Returns the fused unit's and the
    statistics' launches of its --fused_block run."""
    import torch.distributed as dist
    from hrviton_tpu_torch.cli import train_condition as t1
    from hrviton_tpu_torch.cli import train_generator as t2
    from hrviton_tpu_torch.core import mesh as mesh_lib
    from hrviton_tpu_torch.ops import conv3x3 as c3
    from hrviton_tpu_torch.train import condition_trainer, generator_trainer
    from hrviton_tpu_torch.train.checkpoint import load_pytree

    ck, tb = os.path.join(tmp, "ck10"), os.path.join(tmp, "tb10")
    (h1, w1), (h2, w2) = STAGE1["hw"], STAGE2["hw"]
    flags = lambda: ["--coordinator", f"127.0.0.1:{_free_port()}",
                     "--num_processes", "1", "--process_id", "0"]
    with _as_a_user_runs():
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            # (a) stage 1, f32, without and with the flags
            n1 = DP_STEPS["stage 1"]
            argv1 = ["--dataroot", r1, "--test_dataroot", r1,
                     "--fine_height", str(h1), "--fine_width", str(w1),
                     "-b", str(STAGE1["batch"]), "-j", "4", "--keep_step",
                     str(n1), "--display_count", "1", "--tensorboard_count",
                     "100000", "--val_count", "100000", "--save_count",
                     "100000", "--checkpoint_dir", ck, "--tensorboard_dir",
                     tb, "--allow_random_vgg", "--device", "cuda"]
            label1 = (f"stage 1 (tocg ngf=96 {h1}x{w1}, batch "
                      f"{STAGE1['batch']}, f32, condition D, {n1} steps)")
            plain1 = _run_cli(f"data parallel: {label1} without the flags",
                              t1.main, ["--name", "p1"] + argv1,
                              condition_trainer, "lsgan_loss", card)
            dp1 = _run_cli(f"data parallel: {label1} with --coordinator "
                           f"--num_processes 1 --process_id 0 (NCCL)",
                           t1.main, ["--name", "q1"] + argv1 + flags(),
                           condition_trainer, "lsgan_loss", card)
            if dist.is_initialized():
                raise RuntimeError("data parallel: stage 1 left its group")
            _same_first_step("stage 1", plain1, dp1)

            # stage 2 --fused_block, bf16: the unit's launches a step
            n2 = DP_STEPS["stage 2"]
            common2 = ["--dataroot", r2, "--test_dataroot", r2, "-b",
                       str(STAGE2["batch"]), "-j", "4", "--decay_step", "0",
                       "--display_count", "1", "--save_count", "100000",
                       "--checkpoint_dir", ck, "--tensorboard_dir", tb,
                       "--allow_random_vgg", "--bf16", "--tocg_checkpoint",
                       os.path.join(tmp, "ck", "s1", "tocg_final.ckpt"),
                       "--device", "cuda", "--tensorboard_count", "100000",
                       "--lpips_count", "100000"]
            argv2 = common2 + ["--keep_step", str(n2)]
            label2 = (f"stage 2 --fused_block (SPADE ngf=64 'most' {h2}x{w2}, "
                      f"batch {STAGE2['batch']}, bf16, {n2} steps)")
            wrappers = _wrappers()
            for w in wrappers.values():
                w.launches = 0
            taps2 = c3.wgrad_taps.launches
            dp2 = _run_cli(f"data parallel: {label2} with the flags (NCCL)",
                           t2.main, ["--name", "q2", "--fused_block"] + argv2
                           + flags(), generator_trainer, "gan_loss", card)
            got = {k: w.launches for k, w in wrappers.items()}
            want = {k: 0 for k in got}
            want["spade_unit"] = want["instance_stats"] = \
                UNITS_PER_FUSED_STEP * n2
            want["wgrad3x3"] = c3.wgrad_taps.launches - taps2
            log(f"data parallel: {label2} launches over {n2} steps: "
                f"{ {k: v for k, v in got.items() if v} } (expect spade_unit "
                f"and instance_stats {UNITS_PER_FUSED_STEP} a step, wgrad3x3 "
                f"one a wgrad_taps call)")
            if got != want or want["wgrad3x3"] <= 0:
                raise RuntimeError(f"data parallel: --fused_block launches "
                                   f"{got}, expected {want}")
            if dist.is_initialized():
                raise RuntimeError("data parallel: stage 2 left its group")
            plain2 = _run_cli(f"data parallel: {label2} without the flags",
                              t2.main, ["--name", "p2", "--fused_block"]
                              + argv2, generator_trainer, "gan_loss", card)
            _same_first_step("stage 2 --fused_block", plain2, dp2,
                             after_update=("loss/dis", "loss/dis/adv_fake",
                                           "loss/dis/adv_real"))
            for label, rec_dp, rec_plain, key in (
                    ("stage 1", dp1, plain1, "stage 1"),
                    ("stage 2 --fused_block", dp2, plain2,
                     "stage 2 --fused_block")):
                log(f"data parallel: {label} median ms/step after the first: "
                    f"{statistics.median(rec_dp['step_ms'][1:]):.2f} with the "
                    f"flags (one NCCL rank), "
                    f"{statistics.median(rec_plain['step_ms'][1:]):.2f} "
                    f"without, {earlier_ms[key]:.2f} in phase 9 | {card}")
        finally:
            torch.backends.cudnn.deterministic = deterministic
        torch.cuda.empty_cache()

        # (b) the alias norms: 'spectralaliasbatch' launches no kernel but
        # the weight gradient's (bf16), and its running statistics move
        before = _all_launches()
        taps_a = c3.wgrad_taps.launches
        rec = _run_cli(f"alias norms: stage 2 --norm_G spectralaliasbatch "
                       f"({ALIAS_STEPS} steps, fused unit off)", t2.main,
                       ["--name", "a2", "--norm_G", "spectralaliasbatch",
                        "--keep_step", str(ALIAS_STEPS)] + common2,
                       generator_trainer, "gan_loss", card)
        after = _all_launches()
        want = dict(before, wgrad3x3=before["wgrad3x3"] + c3.wgrad_taps.launches
                    - taps_a)
        if after != want or want["wgrad3x3"] == before["wgrad3x3"] or \
                len(rec["metrics"]) != ALIAS_STEPS:
            raise RuntimeError(f"alias norms: launches "
                               f"{ {k: after[k] - before[k] for k in after} }, "
                               f"{len(rec['metrics'])} steps")
        stats = load_pytree(os.path.join(ck, "a2", "gen_model_final.ckpt")
                            )["batch_stats"]
        means = [sub["param_free_norm"]["mean"] for norms in stats.values()
                 for sub in norms.values()]
        moved = sum(float(abs(m).max()) > 0 for m in means)
        log(f"alias norms: no kernel launched but wgrad3x3 "
            f"({want['wgrad3x3'] - before['wgrad3x3']}, one a wgrad_taps "
            f"call); the running means of "
            f"{moved} of {len(means)} 'aliasbatch' norms moved from 0 in "
            f"gen_model_final.ckpt")
        if not means or moved != len(means):
            raise RuntimeError("alias norms: running statistics did not move")
        _mask_block_check(card)
        torch.cuda.empty_cache()

        # (c) LPIPS head training
        _lpips_head_training(card)
        torch.cuda.empty_cache()

        # (d) the recorded steps through one NCCL rank, against eager
        dev = mesh_lib.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0,
                                        "cuda")
        try:
            recorded_steps(card, r1, r2, mesh_lib.make_mesh(dev))
        finally:
            mesh_lib.shutdown_distributed()
    torch.cuda.empty_cache()
    return {"spade_unit": got["spade_unit"],
            "instance_stats": got["instance_stats"]}


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
    flops = _conv_ops(B, h, w, c, c)
    strip_cols = -(-w // 62) * 64       # product columns of the shift kernels
    nbytes = (2 * x.numel() + wt.numel()) * x.element_size()
    totals = {}
    with _Clocks():
        for key, kname, ths in TOOL_CONVS:
            run, plain = tools[key]
            for th in ths:
                tot = {}
                _check_site(tot, f"{key} TH={th} {c}->{c} {h}x{w}", 1,
                            lambda: run(x, wt, th=th), lambda: plain(x, wt, th),
                            lambda: F.conv2d(xa, wl, None, 1, 1), kname, flops,
                            nbytes, 1)
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
                        + f"; bound {flops / PEAK_OPS * 1e3:.4f} ms"
                        + (f", with the products of the strips' overlapping "
                           f"columns {flops * strip_cols / w / PEAK_OPS * 1e3:.4f} ms"
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
    _check_site(tot, f"copy_probe TH={PROBE_TH} {TOOLS_X}", 1,
                lambda: probe(x, th=PROBE_TH), lambda: probe_ref(x, PROBE_TH),
                lambda: out.copy_(x), "band_copy_probe_kernel", 0,
                2 * x.numel() * x.element_size(), 1, exact=True)
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
    # no TPU kernel's counterpart: the JAX package's weight gradient of the
    # taps (hrviton_tpu/ops/conv3x3.py:_wgrad_taps :280) is XLA's
    ("wgrad3x3", "wgrad3x3 (the bf16 weight gradient of the stage-2 training "
     "step's 94 3x3 convs, batch 2 at 1024x768: TMA boxes of x and g, wgmma "
     "with both operands MN-major, f32 sums; times summed over the 94 calls; "
     "launches: the stage-2 CLI's of phase 9 (c), as many as wgrad_taps')",
     "wgrad3x3.cu", "none: hrviton_tpu/ops/conv3x3.py:280 (_wgrad_taps) is XLA's"),
]


# phase 13: the bf16 weight gradient of the training cell's 3x3 convs
WGRAD_LARGEST = (2, 1024, 768, 128, 80, "relu")   # up_4's gamma / beta convs
WGRAD_NCHW = ("nchw", "slice")    # the NCHW g's each call is also timed with


def _view_of(t):
    """(shape, strides, storage offset) of a view: what _strided_like
    rebuilds."""
    return tuple(t.shape), tuple(t.stride()), t.storage_offset()


def _strided_like(view, gen, scale=1.0):
    """A bf16 tensor of ``view``'s shape, strides and storage offset (a
    slice of a wider tensor stays one), drawn from ``gen``; returns (the
    view, its storage)."""
    shape, stride, offset = view
    size = offset + 1 + sum((n - 1) * st for n, st in zip(shape, stride))
    buf = (torch.randn(size, device="cuda", generator=gen) * scale).bfloat16()
    return buf.as_strided(shape, stride, offset), buf


def _g_layout(view):
    """How g arrives: "nhwc" (contiguous), "nhwc slice" (of a wider NHWC
    tensor, a concatenation's gradient), "nchw" (the NHWC view of a
    contiguous NCHW tensor), "slice" (of a wider NCHW tensor) or "other"."""
    (n, h, w, c), (sn, sh, sw, sc), offset = view
    if (sn, sh, sw, sc) == (h * w * c, w * c, c, 1) and offset == 0:
        return "nhwc"
    if sc == 1 and sw > c and (sn, sh) == (h * sh, w * sw):
        return "nhwc slice"
    if (sc, sh, sw) == (h * w, w, 1):
        return "nchw" if sn == c * h * w and offset == 0 else "slice"
    return "other"


def _g_nchw_view(n, h, w, c, layout):
    """The NHWC view (shape, strides, storage offset) of an NCHW g:
    "nchw" of a contiguous tensor, "slice" of the second half of a
    concatenation's gradient of 2c channels."""
    wide = 1 if layout == "nchw" else 2
    return (n, h, w, c), (wide * c * h * w, w, 1, h * w), (wide - 1) * c * h * w


def _wgrad_checked(c3, x, g, act, what):
    """The kernel's launcher for one call, after its checks: finite, within
    one bf16 ulp an element of wgrad3x3_ref, two launches bit for bit.
    Returns (launch, out, ref)."""
    from test_torch_wgrad3x3 import assert_within_one_ulp
    launch, out = c3.wgrad3x3_launcher(x, g, act, torch.bfloat16)
    launch()
    first = out.clone()
    launch()
    ref = c3.wgrad3x3_ref(x, g, act, torch.bfloat16)
    if not torch.isfinite(out.float()).all():
        raise RuntimeError(f"wgrad3x3 {what}: not finite")
    assert_within_one_ulp(out, ref, floor=2.0 ** -12)
    if not torch.equal(out, first):
        raise RuntimeError(f"wgrad3x3 {what}: two launches differ")
    return launch, out, ref


def wgrad_phase(card):
    """Phase 13 (module docstring). Returns (totals over the cell's 94
    calls, the launches of one eager step)."""
    import collections
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_wgrad3x3 import cell_sites
    from hrviton_tpu_torch.ops import conv3x3 as c3
    calls, n_step = _wgrad_step_calls(card)
    sites = collections.Counter()
    for (xv, gv, act), k in calls.items():
        sites[(*xv[0], gv[0][-1], act)] += k
    if sites != collections.Counter(cell_sites()):
        raise RuntimeError(f"wgrad3x3: the step's calls are not the cell's "
                           f"94 sites: {sorted(sites.items())}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tot = dict(ms=0.0, kernel_alone_ms=0.0, plain_ms=0.0, library_ms=0.0,
               ops_ms=0.0, bytes_ms=0.0, bound_ms=0.0, max_abs=0.0)
    # each call also with g NCHW, contiguous and a concatenation's slice
    # (the kernel's 5-D read of g, which the step no longer hands it)
    for lay in WGRAD_NCHW:
        tot.update({f"g_{lay}_ms": 0.0, f"g_{lay}_kernel_alone_ms": 0.0})
    by_layout = collections.Counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (xv, gv, act), k in sorted(calls.items(),
                                   key=lambda kv: (kv[0][0][0][1:], str(kv[0]))):
        (n, h, w, cin), cout = xv[0], gv[0][-1]
        site, layout = (n, h, w, cin, cout, act), _g_layout(gv)
        by_layout[layout] += k
        x, xbuf = _strided_like(xv, gen)
        g, gbuf = _strided_like(gv, gen, 0.1)
        launch, out, ref = _wgrad_checked(c3, x, g, act, f"{site} g {layout}")
        a = c3.activation(x, act).permute(0, 3, 1, 2)
        gn = g.permute(0, 3, 1, 2)
        times = dict(
            ms=_events_ms(lambda: c3.wgrad3x3(x, g, act, torch.bfloat16), 5),
            kernel_alone_ms=_events_ms(launch, 5),
            plain_ms=_events_ms(lambda: c3.wgrad3x3_ref(x, g, act, torch.bfloat16), 2),
            library_ms=_events_ms(lambda: torch.nn.grad.conv2d_weight(
                a, (cout, cin, 3, 3), gn, padding=1), 3),
            ops_ms=2 * n * h * w * 9 * cin * cout / PEAK_OPS * 1e3,
            bytes_ms=(2 * n * h * w * (cin + cout) + 2 * 9 * cin * cout)
            / PEAK_BYTES * 1e3)
        times["bound_ms"] = max(times["ops_ms"], times["bytes_ms"])
        err = (out.float() - ref.float()).abs().max().item()
        log(f"wgrad3x3 {site} g {layout} (strides {gv[1]}, offset {gv[2]}) "
            f"x{k} {launch.plan}: max_abs {err:.3e} of max|ref| "
            f"{ref.float().abs().max().item():.3e}, within one bf16 ulp an "
            f"element, two launches equal | " + ", ".join(
                f"{key} {v:.4f}" for key, v in times.items()))
        tot["max_abs"] = max(tot["max_abs"], err)
        del g, gbuf, out, ref, a, gn, launch
        nchw = {}
        for lay in WGRAD_NCHW:
            nv = _g_nchw_view(n, h, w, cout, lay)
            g, gbuf = _strided_like(nv, gen, 0.1)
            launch, out, ref = _wgrad_checked(c3, x, g, act, f"{site} g {lay}")
            err = (out.float() - ref.float()).abs().max().item()
            nchw[lay] = (_events_ms(lambda: c3.wgrad3x3(x, g, act, torch.bfloat16), 5),
                         _events_ms(launch, 5))
            log(f"wgrad3x3 {site} g {lay} (strides {nv[1]}, offset {nv[2]}) "
                f"{launch.plan}: max_abs {err:.3e} of max|ref| "
                f"{ref.float().abs().max().item():.3e}, within one bf16 ulp an "
                f"element, two launches equal | ms {nchw[lay][0]:.4f}, "
                f"kernel_alone_ms {nchw[lay][1]:.4f}")
            tot[f"g_{lay}_ms"] += k * nchw[lay][0]
            tot[f"g_{lay}_kernel_alone_ms"] += k * nchw[lay][1]
            tot["max_abs"] = max(tot["max_abs"], err)
            del g, gbuf, out, ref, launch
        if site == WGRAD_LARGEST:
            log(f"wgrad3x3 up_4's largest call {site}, g {layout}, x{k}: kernel "
                f"alone {times['kernel_alone_ms']:.4f} ms, wrapper "
                f"{times['ms']:.4f}; " + "; ".join(
                    f"g {lay}: kernel alone {alone:.4f} ms, wrapper {m:.4f}"
                    for lay, (m, alone) in nchw.items()) +
                f"; bound {times['bound_ms']:.4f}, plain "
                f"{times['plain_ms']:.4f}, cuDNN {times['library_ms']:.4f} | {card}")
        for key, v in times.items():
            tot[key] += k * v
        del x, xbuf
    log(f"wgrad3x3 over the cell's {sum(calls.values())} calls a step, each "
        f"with x and g as the step hands them (g: {dict(by_layout)}; "
        f"g_<layout>_*: the same calls with g NCHW): " +
        ", ".join(f"{key} {v:.3f}" for key, v in tot.items()) + f" | {card}")
    torch.cuda.empty_cache()
    return tot, n_step


def _wgrad_step_calls(card):
    """One eager step of the training cell (built by
    benchmark/drivers/train_closed_loop.py): the kernel's launches (94, as
    many as wgrad_taps' calls), the operands copied, and each call's x and
    g as the step hands them to the kernel's wrapper. Returns ({(x view, g
    view, pre_act): calls}, launches)."""
    import collections
    from benchmark import inputs
    from benchmark.drivers import train_closed_loop as tcl
    from hrviton_tpu_torch.cli import train_generator as tgen
    from hrviton_tpu_torch.core import graphs
    from hrviton_tpu_torch.ops import conv3x3 as c3
    bench = os.path.join(ROOT, "benchmark")
    config = json.load(open(os.path.join(bench, "configs",
                                         "hrviton-train-stage2-bf16.json")))
    traffic = json.load(open(os.path.join(bench, "traffic",
                                          "train-closed-b2.json")))
    built = tcl.build(config, traffic, 1, "cuda")
    p = config["pipeline"]
    raw = inputs.make_pool(1, traffic["batch"], p["fine_height"],
                           p["fine_width"], 2, "cuda")[0]
    calls = collections.Counter()
    real = c3.wgrad3x3_launcher

    def spy(x, g, pre_act=None, dtype=torch.bfloat16):
        calls[(_view_of(x), _view_of(g), pre_act)] += 1
        return real(x, g, pre_act, dtype)
    before = (c3.wgrad3x3.launches, c3.wgrad_taps.launches, c3.wgrad3x3.copies)
    c3.wgrad3x3_launcher = spy
    try:
        with graphs.disabled():
            tgen.train_step(built.trainer, built.state, raw, built.noise,
                            built.frozen, built.put)
        torch.cuda.synchronize()
    finally:
        c3.wgrad3x3_launcher = real
    got = [a - b for a, b in zip((c3.wgrad3x3.launches, c3.wgrad_taps.launches,
                                  c3.wgrad3x3.copies), before)]
    layouts = collections.Counter()
    for (_, gv, _), k in calls.items():
        layouts[_g_layout(gv)] += k
    log(f"wgrad3x3 in one eager step of train-stage2-b2: {got[0]} launches, "
        f"wgrad_taps {got[1]} calls, {got[2]} operands copied first; g as "
        f"handed over: {dict(layouts)} | {card}")
    if got[0] != got[1] or got[0] != 94 or sum(calls.values()) != 94:
        raise RuntimeError(f"wgrad3x3: {got[0]} launches in a step, wgrad_taps "
                           f"{got[1]}, {sum(calls.values())} seen (expected 94 "
                           f"each)")
    del built, raw
    _free()
    return calls, got[0]


# phase 11: the captured entry points (core/graphs.py)
GRAPH_PAIRS = 10            # eager / replay pairs timed in turns per entry point
GRAPH_DIR = os.path.join(ROOT, "build", "graphs")   # the graphs' DOT dumps
# the hand-written kernels, by the names their launches and graph nodes carry
HAND_WRITTEN = ("spade_unit_gb_kernel", "spade_unit_conv_kernel",
                "spade_modulate_kernel", "conv3x3_wide_kernel",
                "conv3x3_small_kernel", "instance_stats_partial_kernel",
                "instance_stats_finalize_kernel", "wgrad3x3_kernel",
                "wgrad3x3_sum_kernel")


def _free():
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _tree_leaves(tree, prefix="out"):
    """(name, tensor) of every tensor leaf of an entry point's output."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _tree_leaves(v, f"{prefix}.{k}")]
    if isinstance(tree, (list, tuple)):
        names = getattr(tree, "_fields", None) or range(len(tree))
        return [x for n, v in zip(names, tree)
                for x in _tree_leaves(v, f"{prefix}.{n}")]
    return []


def _held(label, got, want, main):
    """got against want leaf by leaf: bit for bit, or else every leaf that
    differs named and the main output held to the pipelines' limits (max 5%
    of max|ref|, mean 1% of mean|ref|). Returns what was found."""
    g, w = dict(_tree_leaves(got)), dict(_tree_leaves(want))
    if g.keys() != w.keys():
        raise RuntimeError(f"{label}: outputs {sorted(g)} against {sorted(w)}")
    differ = [k for k in w if g[k].shape != w[k].shape or g[k].dtype != w[k].dtype
              or not torch.equal(g[k], w[k])]
    if not differ:
        return "bit for bit"
    parts = []
    for k in differ:
        if g[k].shape != w[k].shape or g[k].dtype != w[k].dtype:
            raise RuntimeError(f"{label}: {k} {g[k].dtype} {tuple(g[k].shape)} "
                               f"against {w[k].dtype} {tuple(w[k].shape)}")
        d = (g[k].float() - w[k].float()).abs()
        parts.append(f"{k} max_abs {d.max().item():.3e}")
    d = (g[main].float() - w[main].float()).abs()
    ref = w[main].float().abs()
    lim_max, lim_mean = 0.05 * ref.max().item(), 0.01 * ref.mean().item()
    if d.max().item() > lim_max or d.mean().item() > lim_mean:
        raise RuntimeError(f"{label}: {main} max_abs {d.max().item():.3e} mean "
                           f"{d.mean().item():.3e} (limits {lim_max:.3e} / "
                           f"{lim_mean:.3e}); differing: {parts}")
    return (f"not bit for bit, within the pipelines' limits ({main} max_abs "
            f"{d.max().item():.3e} of {lim_max:.3e}); differing: "
            + ", ".join(parts))


def _profiled(fn):
    """fn() once in a profiler window: (kernel records by name, other device
    records (copies, memsets) by name, device busy ms, wall ms)."""
    with _window() as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    recs = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels, other = {}, {}
    for e in recs:
        d = other if e.name.startswith(("Memcpy", "Memset")) else kernels
        d[e.name] = d.get(e.name, 0) + 1
    return kernels, other, _busy_us(recs) / 1e3, wall


def _busy_us(recs):
    """The union of the device records' spans, us."""
    if not recs:
        return 0.0
    spans = sorted((e.time_range.start, e.time_range.end) for e in recs)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    return busy + cur_e - cur_s


def _kernel_diff(graph_names, eager_names):
    """{kernel: graph nodes - eager launches} for the kernels whose counts
    differ, the graph's mangled names demangled (cu++filt) to compare with
    the profiler's."""
    # GNU c++filt spells names as the profiler does (cu++filt does not)
    tool = shutil.which("c++filt") or "c++filt"
    mangled = list(graph_names)
    try:
        plain = subprocess.run([tool], input="\n".join(mangled), text=True,
                               capture_output=True, timeout=60,
                               check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        plain = mangled
    norm = lambda n: re.sub(r"\s+", "", n.removeprefix("void "))
    diff = {}
    for name, n in zip(plain, graph_names.values()):
        diff[norm(name)] = diff.get(norm(name), 0) + n
    for name, n in eager_names.items():
        diff[norm(name)] = diff.get(norm(name), 0) - n
    return {k[:160]: v for k, v in diff.items() if v}


def _hand_written(names):
    """{kernel: count} of the hand-written kernels among {name: count}."""
    out = {}
    for name, n in names.items():
        hit = next((k for k in HAND_WRITTEN if k in name), None)
        if hit:
            out[hit] = out.get(hit, 0) + n
    return out


def _graph_nodes(graph, path):
    """The nodes of a recorded graph (one that kept its cudaGraph_t):
    kernel nodes by mangled function name, other nodes by type (MEMSET,
    MEMCPY, ...), from its DOT dump written to ``path``."""
    graph.debug_dump(path)
    with open(path) as f:
        text = f.read()
    nodes = {}
    for kind, body in re.findall(r'label="\{([A-Z_]+)(.*?)"\]', text, flags=re.S):
        name = kind
        if kind == "KERNEL":        # {ID | n (topoId: m) | name\<\<\<grid...
            m = re.search(r"\{ID \|[^|]*\|\s*([A-Za-z_]\w*)", body)
            name = m.group(1) if m else kind
        nodes[name] = nodes.get(name, 0) + 1
    return nodes


_DUMPED = []


def _graph_census(tag, entries):
    """The kernel nodes of the graphs one call replays (their DOT dumps under
    GRAPH_DIR): ({kernel name: count}, {other node type: count})."""
    os.makedirs(GRAPH_DIR, exist_ok=True)
    kernels, other = {}, {}
    for i, entry in enumerate(entries):
        name = re.sub(r"[^A-Za-z0-9]+", "_", tag)
        path = os.path.join(GRAPH_DIR, f"{name}_{i}.dot")
        for name, n in _graph_nodes(entry.graph, path).items():
            d = kernels if name not in ("MEMSET", "MEMCPY", "EMPTY", "EVENT_RECORD",
                                        "WAIT_EVENT", "HOST", "MEM_ALLOC",
                                        "MEM_FREE", "GRAPH") else other
            d[name] = d.get(name, 0) + n
        if not _DUMPED:
            _DUMPED.append(path)
            with open(path) as f:
                log(f"graphs: the start of {path}:\n{f.read(1500)}")
    return kernels, other


def _graph_case(card, tag, call, inputs, capts, reload, main, expect=None):
    """One entry point, eager (graphs.disabled()) against replayed: outputs,
    launch counters, the graph's kernel nodes against eager's launches (the
    inputs are made so that the entry point launches nothing outside its
    graphs), outputs not overwritten by the next call, weights written in
    place after a replay, and GRAPH_PAIRS pairs timed in turns; the first
    call's warm-ups and recordings timed by the tracer. Returns its
    figures."""
    with _capture_clock() as capture_s:
        return _graph_case_traced(card, tag, call, inputs, capts, reload, main,
                                  expect, capture_s)


def _graph_case_traced(card, tag, call, inputs, capts, reload, main, expect,
                       capture_s):
    from hrviton_tpu_torch.core import graphs
    wrappers = _wrappers()

    def counted(fn):
        before = {k: w.launches for k, w in wrappers.items()}
        out = fn()
        torch.cuda.synchronize()
        return out, {k: w.launches - before[k] for k, w in wrappers.items()}

    captures = lambda: sum(c.captures for c in capts)
    with graphs.disabled():
        call(inputs[0])                      # cuDNN's choices, the packing
        eager, n_eager = counted(lambda: call(inputs[0]))
    caps0 = captures()
    t = time.perf_counter()
    _, n_first = counted(lambda: call(inputs[0]))
    first_s = time.perf_counter() - t
    recording_s = capture_s()
    rep, n_rep = counted(lambda: call(inputs[0]))
    entries = [c.last_entry for c in capts]
    if captures() == caps0 and not all(e.replays > 1 for e in entries):
        raise RuntimeError(f"{tag}: nothing was recorded or replayed")
    same = _held(f"{tag}: replay against eager", rep, eager, main)
    if not (n_eager == n_first == n_rep) or (expect is not None and n_rep != expect):
        raise RuntimeError(f"{tag}: launches eager {n_eager}, first call "
                           f"{n_first}, replay {n_rep}, expected {expect}")
    # outputs of call k are not overwritten by call k + 1
    snap = [(k, v.clone()) for k, v in _tree_leaves(rep)]
    nxt = call(inputs[1])
    torch.cuda.synchronize()
    kept = dict(_tree_leaves(rep))
    hit = [k for k, v in snap if not torch.equal(kept[k], v)]
    if hit:
        raise RuntimeError(f"{tag}: call k+1 overwrote call k's {hit}")
    if torch.equal(dict(_tree_leaves(nxt))[main], kept[main]):
        raise RuntimeError(f"{tag}: another input gave the same {main}")
    # the graphs' kernel nodes against one eager call's launches: a profiler
    # window may lose a record (PERF.md section 7), never gain one, so the
    # most of up to three eager windows
    gk, go = _graph_census(tag, entries)
    n_gk = sum(gk.values())
    ek, tries = None, []
    for _ in range(3):
        with graphs.disabled():
            got = _profiled(lambda: call(inputs[0]))
        tries.append(sum(got[0].values()))
        if ek is None or tries[-1] > sum(ek.values()):
            ek, eo, e_busy, e_wall = got
        if tries[-1] == n_gk:
            break
    rk, ro, r_busy, r_wall = _profiled(lambda: call(inputs[0]))
    hw_e, hw_g = _hand_written(ek), _hand_written(gk)
    n_ek = sum(ek.values())
    log(f"{tag}: graph kernel nodes {n_gk} (other nodes {go}), eager kernel "
        f"launches {n_ek} (most of the windows {tries}; copies, memsets "
        f"{eo}), replay's kernel records {sum(rk.values())} (copies, "
        f"memsets {ro}); hand-written: graph {hw_g}, eager {hw_e}")
    # a window may lose records, never gain one: every hand-written kernel
    # as often, and no fewer kernel nodes than eager's launches; a
    # difference is named kernel by kernel
    if hw_e != hw_g or n_gk < n_ek:
        raise RuntimeError(f"{tag}: the graphs' kernel nodes differ from eager's "
                           f"launches: {n_gk} against {n_ek}: "
                           f"{_kernel_diff(gk, ek)}")
    if n_gk != n_ek:
        log(f"{tag}: the graphs hold {n_gk - n_ek} kernel nodes more than "
            f"eager's launches: {_kernel_diff(gk, ek)}")
    if expect is not None:
        want = {k: v for k, v in expect.items() if v}
        got = {"spade_unit": hw_g.get("spade_unit_gb_kernel", 0),
               "spade_modulate": hw_g.get("spade_modulate_kernel", 0),
               "conv3x3_wide": hw_g.get("conv3x3_wide_kernel", 0),
               "conv3x3_small": hw_g.get("conv3x3_small_kernel", 0),
               "instance_stats": hw_g.get("instance_stats_finalize_kernel", 0)}
        if {k: v for k, v in got.items() if v} != want:
            raise RuntimeError(f"{tag}: hand-written nodes {got}, expected {want}")
    # weights written in place after a replay
    reload()
    caps1 = captures()
    fresh = call(inputs[0])
    torch.cuda.synchronize()
    if captures() == caps1:
        raise RuntimeError(f"{tag}: new weights, no new recording")
    with graphs.disabled():
        fresh_eager = call(inputs[0])
    same_new = _held(f"{tag}: replay with new weights against eager", fresh,
                     fresh_eager, main)
    if torch.equal(dict(_tree_leaves(fresh))[main], kept[main]):
        raise RuntimeError(f"{tag}: new weights gave the same {main}")
    # eager and replay in turns
    ms = {"eager": [], "replay": []}
    wall = {"eager": [], "replay": []}
    for _ in range(GRAPH_PAIRS):
        for mode in ("eager", "replay"):
            ctx = graphs.disabled() if mode == "eager" else contextlib.nullcontext()
            with ctx:
                torch.cuda.synchronize()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                t = time.perf_counter()
                e0.record()
                call(inputs[0])
                e1.record()
                torch.cuda.synchronize()
                wall[mode].append((time.perf_counter() - t) * 1e3)
                ms[mode].append(e0.elapsed_time(e1))
    pool = _pool_mib(capts)
    med = lambda v: statistics.median(v)
    fig = dict(eager_ms=med(ms["eager"]), replay_ms=med(ms["replay"]),
               eager_wall=med(wall["eager"]), replay_wall=med(wall["replay"]),
               eager_busy=e_busy, replay_busy=r_busy, eager_gap=e_wall - e_busy,
               replay_gap=r_wall - r_busy, launches=n_ek, nodes=n_gk, pool_mib=pool,
               capture_s=recording_s)
    log(f"{tag}: replay against eager {same}; with new weights {same_new}; "
        f"launch counters per call eager {n_eager}, replayed {n_rep}; first "
        f"call (warm-up and recording) {first_s * 1e3:.1f} ms, recording "
        f"{fig['capture_s'] * 1e3:.1f} ms, pools "
        + ("not measured" if pool is None else f"{pool:.1f} MiB"))
    log(f"{tag}: CUDA events ms per call, {GRAPH_PAIRS} pairs in turns: eager "
        f"{_spread(ms['eager'])}; replay {_spread(ms['replay'])}; wall eager "
        f"{fig['eager_wall']:.2f} replay {fig['replay_wall']:.2f} ms; device busy "
        f"eager {e_busy:.2f} of {e_wall:.2f} ms (host gap {e_wall - e_busy:.2f}), "
        f"replay {r_busy:.2f} of {r_wall:.2f} ms (host gap "
        f"{r_wall - r_busy:.2f}); launches {n_ek} eager, {n_gk} graph kernel "
        f"nodes | {card}")
    del eager, rep, nxt, fresh, fresh_eager, snap, kept
    return fig


def _pool_sizes(capts):
    """MiB of the device memory segments of the captured functions' private
    pools and MiB allocated in them (torch.cuda.memory_snapshot), or None
    where the snapshot does not name a segment's pool."""
    pools = {tuple(c.pool) for c in capts if c.pool is not None}
    segs = torch.cuda.memory_snapshot()
    if not segs or "segment_pool_id" not in segs[0]:
        return None
    mine = [sg for sg in segs if tuple(sg["segment_pool_id"]) in pools]
    return (sum(sg["total_size"] for sg in mine) / 2 ** 20,
            sum(sg["allocated_size"] for sg in mine) / 2 ** 20)


def _pool_mib(capts):
    """MiB of the captured functions' private pools, or None (_pool_sizes)."""
    sizes = _pool_sizes(capts)
    return None if sizes is None else sizes[0]


def _reseed(*modules, seed):
    from hrviton_tpu_torch.nn.layers import init_weights
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in modules:
            init_weights(m, g)


def _stacked(raws):
    """Compact CLI batches of 1 stacked into one batch."""
    import numpy as np

    def cat(vals):
        if isinstance(vals[0], dict):
            return {k: cat([v[k] for v in vals]) for k in vals[0]}
        return np.concatenate(vals)
    return cat(raws)


def captured_phase(card):
    """Phase 11 (module docstring): every inference entry point at full
    width, eager against replayed."""
    from hrviton_tpu_torch import SPADEGenConfig
    from hrviton_tpu_torch.cli import get_norm_const as gnc
    from hrviton_tpu_torch.cli import test_condition as tc
    from hrviton_tpu_torch.cli import test_generator as tg
    from hrviton_tpu_torch.config import CondDiscriminatorConfig, TOCGConfig
    from hrviton_tpu_torch.core import graphs
    from hrviton_tpu_torch.losses import lpips as lp
    from hrviton_tpu_torch.models import inception as inc
    from hrviton_tpu_torch.models.condition import ConditionGenerator
    from hrviton_tpu_torch.models.discriminators import CondMultiscaleDiscriminator
    from hrviton_tpu_torch.ops import conv3x3 as c3
    from hrviton_tpu_torch.pipelines import tryon

    figures = {}
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    # the two paths, batch 4, bf16
    on_cfg = SPADEGenConfig(ngf=64, num_upsampling_layers="most",
                            fused_block=False, fast_spade=True, fast_conv=True)
    for tag, cfg, views, expect in (("first path", None, False, FIRST_PATH),
                                    ("second path", on_cfg, True, SECOND_PATH)):
        pipe = _build_pipeline(f"captured {tag}", cfg)
        fh, fw = pipe.cfg.fine_height, pipe.cfg.fine_width
        # in the pipeline's dtype: its cast launches nothing
        batches = [{k: v.to(pipe.dtype) for k, v in
                    _synthetic_batch(fh, fw, seed).items()} for seed in (0, 1)]
        saved = c3._VIEWS
        c3._VIEWS = views
        try:
            figures[tag] = _graph_case(
                card, f"captured {tag}", lambda b: pipe(b), batches,
                [tryon._forward],
                lambda: _reseed(pipe.tocg, pipe.generator, seed=9), "out.0",
                {k: v for k, v in expect.items() if k in _wrappers()})
        finally:
            c3._VIEWS = saved
        del pipe, batches
        _free()

    # the inference CLI's step, batch 1, f32 and bf16, then a last batch
    base = ["--tocg_checkpoint", "", "--gen_checkpoint", "", "--device", "cuda"]
    fh, fw = 1024, 768
    raws = []
    for seed in range(3):
        raw = _compact_batch(fh, fw, seed)
        raw.pop("c_name")
        raw.pop("im_name")
        raws.append(raw)
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    _tf32(True, False)                      # torch's defaults
    try:
        for bf16 in (False, True):
            tag = f"captured cli step {'bf16' if bf16 else 'f32'}"
            pipe = tg.build_pipeline(tg.get_opt(base + (["--bf16"] if bf16 else [])))
            expect = ({k: v for k, v in FIRST_PATH.items() if k in _wrappers()}
                      if bf16 else dict.fromkeys(_wrappers(), 0))
            figures[tag] = _graph_case(
                card, tag, lambda r: tg.tryon_step(pipe, r), raws,
                [tg.prepare_batch, tryon._forward],
                lambda: _reseed(pipe.tocg, pipe.generator, seed=9), "out.output",
                expect)
            if bf16:
                # a new pipeline at batch 2, then the last, smaller batch:
                # a graph each
                del pipe
                _free()
                pipe = tg.build_pipeline(tg.get_opt(base + ["--bf16"]))
                two = _stacked(raws[:2])
                n0 = len(tryon._forward.entries)
                for b in (two, two, raws[2]):
                    got = tg.tryon_step(pipe, b)
                    with graphs.disabled():
                        want = tg.tryon_step(pipe, b)
                    how = _held(f"{tag}: batch {got.output.shape[0]}", got, want,
                                "out.output")
                    log(f"{tag}: batch {got.output.shape[0]} replay against "
                        f"eager {how}")
                if len(tryon._forward.entries) - n0 != 2:
                    raise RuntimeError(f"{tag}: batches of 2 and 1 recorded "
                                       f"{len(tryon._forward.entries) - n0} graphs")
                log(f"{tag}: batches of 2 and a last batch of 1: a graph each")
            del pipe
            _free()
    finally:
        _tf32(*saved)

    # the rejection steps, batch 8, 256x192, f32
    torch.backends.cudnn.benchmark = False  # the CLIs run with torch's default
    fh, fw = REJ_HW
    tocg = ConditionGenerator(TOCGConfig(ngf=96), device="cuda").eval()
    dm = CondMultiscaleDiscriminator(CondDiscriminatorConfig(input_nc=33),
                                     device="cuda").eval()
    _reseed(tocg, seed=0)
    _reseed(dm, seed=5)
    gen = torch.Generator(device="cuda").manual_seed(21)
    rn = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    ins = [(rn(REJ_BATCH, fh, fw, 4), rn(REJ_BATCH, fh, fw, 16),
            torch.softmax(rn(REJ_BATCH, fh, fw, 13), -1)) for _ in range(2)]
    figures["condition_step"] = _graph_case(
        card, "captured condition_step",
        lambda i: tc.condition_step(tocg, dm, *i[:2]),
        ins, [tc._condition_step], lambda: _reseed(tocg, dm, seed=3), "out.3")
    figures["norm_const_step"] = _graph_case(
        card, "captured norm_const_step",
        lambda i: gnc.norm_const_step(tocg, dm, *i), ins,
        [gnc._norm_const_step], lambda: _reseed(tocg, dm, seed=4), "out.1")
    del tocg, dm, ins
    _free()
    # evaluate's LPIPS (alex, 128x128) and Inception (299x299)
    lpf = lp.make_lpips(device="cuda")
    pairs = [(rn(1, 128, 128, 3).clamp(-1, 1), rn(1, 128, 128, 3).clamp(-1, 1))
             for _ in range(2)]
    figures["lpips"] = _graph_case(
        card, "captured LPIPS alex 128x128", lambda p: lpf(*p), pairs,
        [lp._distance], lambda: _reseed(lpf.model, seed=2), "out")
    net = inc.InceptionV3(device="cuda").eval()
    _reseed(net, seed=6)
    imgs = [rn(1, 299, 299, 3).clamp(-1, 1) for _ in range(2)]
    figures["inception"] = _graph_case(
        card, "captured Inception 299x299", lambda x: inc.inception_probs(net, x),
        imgs, [inc._probs], lambda: _reseed(net, seed=8), "out")
    del lpf, net
    _free()
    torch.backends.cudnn.benchmark = benchmark
    log("captured entry points, CUDA events ms per call (median of "
        f"{GRAPH_PAIRS} pairs in turns) eager -> replay, busy, host gap, "
        f"launches, pool: " + "; ".join(
            f"{k} {v['eager_ms']:.2f} -> {v['replay_ms']:.2f} ms (busy "
            f"{v['eager_busy']:.2f} / {v['replay_busy']:.2f}, gap "
            f"{v['eager_gap']:.2f} / {v['replay_gap']:.2f}, {v['launches']} "
            f"launches, {v['nodes']} nodes, pools "
            + ("not measured)" if v["pool_mib"] is None
               else f"{v['pool_mib']:.0f} MiB)")
            for k, v in figures.items()) + f" | {card}")
    return figures



# phase 12: the knockout attribution (timing only; hrviton_tpu_torch/tools/
# exp_*_knockout.py, profile_components.py)

# the knock variants of the unit's two kernels: (counter key of
# ops/spade_block.knock_counters, the tag set that launches it in (a), kernel
# name in the library, and what it removes)
KNOCK_VARIANTS = [
    ("gb/actv_dma", ("actv_dma",), "spade_unit_gb_knock_kernel", "actv's TMA loads"),
    ("gb/prod_dots", ("prod_dots",), "spade_unit_gb_knock_kernel",
     "the gamma|beta main loop (loads and wgmma)"),
    ("gb/prod_rolls", ("prod_rolls",), "spade_unit_gb_knock_kernel",
     "the gamma|beta taps' kx offsets"),
    ("gb/normalize", ("normalize",), "spade_unit_gb_knock_kernel",
     "the epilogue's normalize"),
    ("gb/modulate", ("modulate",), "spade_unit_gb_knock_kernel",
     "the epilogue's modulation (mod = norm + gamma)"),
    ("conv/cons_dots", ("cons_dots",), "spade_unit_conv_knock_kernel",
     "the consumer's main loop (3x3 units)"),
    ("conv/cons_rolls", ("cons_rolls",), "spade_unit_conv_knock_kernel",
     "the consumer taps' kx offsets (3x3 units)"),
]


def _kernel_key(fname):
    """A mangled kernel name without its anonymous namespace's hash (the
    hash differs from build to build of a changed source)."""
    return re.sub(r"_GLOBAL__N__[0-9a-f]+_", "", fname)


def _sass_text(func):
    """A function's instructions without their addresses and encodings."""
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*;)", func)
    return "\n".join(" ".join(op.split()) for op in ops)


# the engine kernels of the model path and the unit's knock variants, by
# source: (csrc/<source>.cu, names the functions contain)
ENGINE_SOURCES = (("spade_block", ("spade_unit_gb", "spade_unit_conv")),
                  ("spade_knock", ("spade_unit_gb_knock", "spade_unit_conv_knock")),
                  ("spade_fused", ("spade_modulate_kernel",)),
                  ("conv3x3", ("conv3x3_wide_kernel", "conv3x3_small_kernel")))


def _library_of(root, src):
    """The built library of csrc/<src>.cu of the checkout at ``root`` (this
    one's through its own _build; another's in a process with that root
    first on the path, built there under its own build/), or None where
    that checkout has no such source."""
    if os.path.realpath(root) == os.path.realpath(ROOT):
        from hrviton_tpu_torch.ops import _build
        return str(_build.build(src))
    if not os.path.exists(os.path.join(root, "hrviton_tpu_torch", "csrc",
                                       src + ".cu")):
        return None
    code = ("import sys; from hrviton_tpu_torch.ops import _build; "
            "print(_build.build(sys.argv[1]))")
    out = subprocess.run([sys.executable, "-c", code, src], cwd=root,
                         capture_output=True, text=True, check=True,
                         timeout=600,
                         env={**os.environ, "PYTHONPATH": os.path.abspath(root)})
    return out.stdout.strip().splitlines()[-1]


def sass_digest(root=ROOT):
    """{mangled name without its namespace hash: [sha256 of its SASS
    instructions (24 hex digits), the first five fields of its cuobjdump
    -res-usage line, HGMMA count]} of every engine kernel (ENGINE_SOURCES)
    of the checkout at ``root``."""
    import hashlib
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for src, names in ENGINE_SOURCES:
        lib = _library_of(root, src)
        if lib is None:
            continue
        res = subprocess.run([tool, "-res-usage", lib], capture_output=True,
                             text=True, check=True, timeout=300).stdout
        usage = dict(re.findall(r"Function (\S+):\s*\n\s*(REG:[^\n]*)", res))
        if not usage:
            log(f"cuobjdump -res-usage {src}: no REG line read from:\n{res[:2000]}")
        for _, fname, func in _sass_functions(src, names, lib):
            out[_kernel_key(fname)] = [
                hashlib.sha256(_sass_text(func).encode()).hexdigest()[:24],
                " ".join(usage.get(fname, "?").split()[:5]),
                len(re.findall(r"\bHGMMA\b", func))]
    return out


def sass_diff(other):
    """``--sass-diff OTHER``: the production engine kernels' SASS and
    resources of this checkout against those of the checkout at ``other``
    (e.g. a parent unpacked under build/), each built from its own sources;
    raises if one differs or is missing on either side."""
    here, there = sass_digest(), sass_digest(other)
    prod = lambda d: {n: v[:2] for n, v in d.items() if "knock" not in n}
    here, there = prod(here), prod(there)
    changed = sorted(n for n in set(here) | set(there)
                     if here.get(n) != there.get(n))
    log(f"sass diff: {len(there)} production engine kernels in {other}, "
        f"{len(here)} here, the same SASS and resources: "
        f"{sum(here[n] == there.get(n) for n in here)}")
    for n in changed:
        log(f"  differs: {n}: here {here.get(n)}, {other} {there.get(n)}")
    if changed or not here:
        raise RuntimeError(f"{len(changed)} production engine kernels differ")


def knockout_sass_phase():
    """(b) Every knock variant built, its wgmma unserialised (the build
    phase) and HGMMA in all but the no-products ones (knock mask 2). The
    production kernels against a parent's build: ``--sass-diff``."""
    variants = {n: d for n, d in sass_digest().items() if "knock" in n}
    for n, (sha, usage, hgmma) in sorted(variants.items()):
        # spade_unit_gb_knock_kernel<BN, MASK>, spade_unit_conv_knock_kernel<BN, MASK, Epi>
        mask = int(re.search(r"knock_kernelILi\d+ELi(\d+)E", n).group(1))
        no_dots = mask == 2
        log(f"  {n}: {usage}, {hgmma} HGMMA")
        if (hgmma == 0) != no_dots:
            raise RuntimeError(f"{n}: {hgmma} HGMMA with knock mask {mask}")
    log(f"knockout (b): {len(variants)} knock variants built, HGMMA in all but "
        f"the two without products")
    if len(variants) != 5 * 3 + 2 * 3:
        raise RuntimeError(f"{len(variants)} knock variants, expected 21")


def _knock_bound(h, w, c, cout, ks, residual, knock):
    """(operations, bytes) of the knocked unit at batch B: the products it
    still makes, the bytes it must still move."""
    px = B * h * w
    gb_ops = 0 if "prod_dots" in knock else 2 * px * 2 * 9 * 128 * c
    cons_ops = 0 if ks == 3 and "cons_dots" in knock else 2 * px * ks * ks * c * cout
    nbytes = unit_bytes(B, h, w, c, cout, ks, residual=residual)
    if {"actv_dma", "prod_dots"} & set(knock):
        nbytes -= px * 128 * 2
    return gb_ops + cons_ops, nbytes


def _knock_unit_inputs(gen, h, w, c, cout, ks, residual):
    """The unit's bf16 inputs with x's channel means and scales well away
    from 0 and 1 (x * (1 + 2u) + 3v per channel, u uniform in [0, 1), v
    standard normal), so that the statistics and the normalize step show in
    the output: on standard normal x (mu ~ 0, rsig ~ 1) the production unit
    is within the limit of the normalize- and stats-knocked ones."""
    args, res = _unit_inputs(gen, torch.bfloat16, h, w, c, cout, ks, residual)
    u = torch.rand(c, generator=gen, device="cuda")
    v = _randn(gen, c)
    args[0] = (args[0].float() * (1 + 2 * u) + 3 * v).to(torch.bfloat16)
    return args, res


def knockout_kernel_phase():
    """(a) Every knock variant of the unit's kernels against the plain
    knocked unit at the six unit shapes, batch 4, bf16 (2 ulps of max|ref|,
    as phase 3), on x with statistics far from mu = 0, rsig = 1; the
    production unit must fail each variant's limit against the knocked plain
    version (else the comparison could not tell them apart); actv_dma
    (undefined output) launched and timed only. Returns {variant key:
    totals over the six units}."""
    from hrviton_tpu_torch.ops import spade_block as sb
    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = {}
    for key, knock, _, _ in KNOCK_VARIANTS:
        tot = rows[key] = {"max_abs": None if knock == ("actv_dma",) else 0.0}
        for name, h, w, c, cout, ks, act, residual in UNITS:
            if key.startswith("conv/") and ks == 1:
                continue               # no consumer variant of a 1x1 unit
            args, res = _knock_unit_inputs(gen, h, w, c, cout, ks, residual)
            unit = lambda: sb.spade_conv_unit(act, *args, res, knock=knock)
            plain = lambda: sb.spade_conv_ref(*args, pre_act=act, residual=res,
                                              knock=knock)
            ops, nbytes = _knock_bound(h, w, c, cout, ks, residual, knock)
            out = unit()
            torch.cuda.synchronize()
            if tuple(out.shape) != (B, h, w, cout):
                raise RuntimeError(f"knock {key} {name}: shape {tuple(out.shape)}")
            ms, plain_ms = _events_ms(unit, 3), _events_ms(plain, 2)
            t_ops, t_bytes = ops / PEAK_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
            msg = f"knock {key} {name}: wrapper {ms:.3f} ms, plain {plain_ms:.3f} ms, " \
                f"bound {max(t_ops, t_bytes):.4f} ms"
            if tot["max_abs"] is not None:
                ref = plain()
                scale = ref.float().abs().max().item()
                err = (out.float() - ref.float()).abs().max().item()
                tol = 2 * 2 ** -7 * scale
                prod = sb.spade_conv_unit(act, *args, res)
                control = (prod.float() - ref.float()).abs().max().item()
                msg += (f", max_abs {err:.3e} (tol {tol:.3e}; the production "
                        f"unit {control:.3e})")
                if not torch.isfinite(out).all() or err > tol:
                    log(msg)
                    raise RuntimeError(f"knock {key} {name}: the variant disagrees "
                                       f"with its plain version ({err} > {tol})")
                if control <= tol:
                    log(msg)
                    raise RuntimeError(
                        f"knock {key} {name}: the production unit is within the "
                        f"variant's limit ({control} <= {tol}): the check cannot "
                        f"tell the variant from it")
                tot["max_abs"] = max(tot["max_abs"], err)
                del prod
            log(msg)
            for k, v in (("ms", ms), ("plain_ms", plain_ms), ("ops_ms", t_ops),
                         ("bytes_ms", t_bytes), ("bound_ms", max(t_ops, t_bytes))):
                tot[k] = tot.get(k, 0.0) + v
            del args, res, out
        tot["library_ms"] = None
    return rows


def knockout_path_phase(card):
    """(c) gen_knock through the replayed first path: one recording per tag
    set (the JAX tool's knocks, skeleton and the unit's eight sets), the
    production graph replayed after each context with no new recording and
    the production output bit for bit. The knock variants' counts are set to
    0 just before and read just after. Returns {variant key: launches}."""
    from hrviton_tpu_torch.models import spade as tspade
    from hrviton_tpu_torch.ops import spade_block as sb
    from hrviton_tpu_torch.pipelines import tryon
    pipe = _build_pipeline("knockout path")
    batch = _synthetic_batch(pipe.cfg.fine_height, pipe.cfg.fine_width, 12)
    want, _ = pipe(batch)
    want = want.clone()
    captures = lambda: tryon._forward.captures
    sets = ([(t,) for t in tspade.KNOCKS] + [tspade.KNOCKS]
            + [k for k in sb.KNOCK_SETS])
    for c in (*sb.knock_counters.values(), *sb.knock_production.values()):
        c.launches = 0
    t0 = time.perf_counter()
    for tags in sets:
        n0 = captures()
        with tspade.gen_knock(tags):
            pipe(batch)
            a, _ = pipe(batch)
            b, _ = pipe(batch)
        # actv_dma's output is undefined (the ring's stale bytes)
        same = tags == ("actv_dma",) or (torch.equal(a, b)
                                         and bool(torch.isfinite(a).all()))
        if captures() != n0 + 1 or not same:
            raise RuntimeError(f"gen_knock {tags}: {captures() - n0} recordings, "
                               f"replays equal and finite: {same}")
        n1 = captures()
        again, _ = pipe(batch)
        if captures() != n1 or not torch.equal(again, want):
            raise RuntimeError(f"after gen_knock {tags}: {captures() - n1} "
                               f"recordings, production output equal: "
                               f"{torch.equal(again, want)}")
    launches = {k: c.launches for k, c in sb.knock_counters.items()}
    production = {k: c.launches for k, c in sb.knock_production.items()}
    log(f"knockout (c): {len(sets)} tag sets through the replayed first path in "
        f"{time.perf_counter() - t0:.1f} s, one recording each, the production "
        f"graph and output after each; variant launches {launches}; the "
        f"production kernels of the stages a knocked call left unknocked "
        f"{production} | {card}")
    if any(n <= 0 for n in launches.values()):
        raise RuntimeError(f"a knock variant did not launch: {launches}")
    # each set with a unit tag (and no `unit` stub) runs, in its three
    # calls, both stages of the six units once, each through its variant
    # or its production kernel (`stats` through both production kernels)
    want = 3 * len(UNITS) * sum(
        "unit" not in tags and bool(set(tags) & set(sb.UNIT_KNOCKS))
        for tags in sets)
    per_stage = {st: production[st] + sum(n for k, n in launches.items()
                                          if k.startswith(st + "/"))
                 for st in production}
    if any(n != want for n in per_stage.values()):
        raise RuntimeError(f"knocked calls' kernels a stage {per_stage}, "
                           f"expected {want} each")
    del pipe
    return launches


# the knockout tool's stage-2 step against the stage-2 CLI's of phase 9
# (the same program: the CLI's defaults, cuDNN's autotuning off): at most
# this far apart, relative, in their medians
TRAIN_TOOL_SPREAD = 0.25


def knockout_tools_phase(card, pairs, train_variants=(), cli_ms=None):
    """(d) Each knockout tool's main at full size, ``pairs`` pairs; the
    training step's with ``train_variants`` (all if empty), after it holds
    the full variant's step against the production step bit for bit, its
    production step against ``cli_ms`` (the stage-2 CLI's median ms/step)
    where given."""
    from hrviton_tpu_torch.tools import (exp_block_knockout, exp_cond_knockout,
                                         exp_gen_knockout, exp_train_knockout,
                                         profile_components)
    os.environ["KNOCK_PAIRS"] = str(pairs)
    results = {}
    for name, main in (("exp_block_knockout", exp_block_knockout.main),
                       ("exp_gen_knockout", lambda: exp_gen_knockout.main()),
                       ("exp_cond_knockout", exp_cond_knockout.main),
                       ("profile_components", profile_components.main),
                       ("exp_train_knockout",
                        lambda: exp_train_knockout.main(train_variants))):
        t0 = time.perf_counter()
        results[name] = main()
        _free()
        log(f"knockout (d): {name}.main at full size, {pairs} pairs, in "
            f"{time.perf_counter() - t0:.1f} s | {card}")
    if cli_ms is not None:
        tool_ms = results["exp_train_knockout"]["prod"]["ms"]
        log(f"knockout (d): the tool's stage-2 production step {tool_ms:.2f} ms "
            f"against the stage-2 CLI's {cli_ms:.2f} (phase 9) | {card}")
        if abs(tool_ms - cli_ms) > TRAIN_TOOL_SPREAD * cli_ms:
            raise RuntimeError(f"the knockout tool's stage-2 step ({tool_ms:.2f} "
                               f"ms) is not the CLI's ({cli_ms:.2f} ms)")
    return results


def knockout_phase(card, pairs=2, train_variants=("prod", "skeleton"),
                   cli_ms=None):
    """Phase 12: (a), (c), (d), (b). Returns (rows, launches) of the knock
    variants for the record."""
    rows = knockout_kernel_phase()
    launches = knockout_path_phase(card)
    _free()
    knockout_tools_phase(card, pairs, train_variants, cli_ms)
    knockout_sass_phase()
    return rows, launches


KNOCK_KERNELS = [
    (key, f"{kernel} knock variant {key.split('/')[1]} (timing only; removes "
     f"{removes}): the knocked unit at the six units of one batch-4 request "
     f"({'the 3x3 four' if key.startswith('conv/') else 'all six'} launch it), "
     f"bf16, wrapper time; launches through the replayed first path under "
     f"gen_knock (phase 12 (c))"
     + ("; output undefined, max_abs_err not compared" if tags == ("actv_dma",)
        else ""),
     "spade_knock.cu", "hrviton_tpu/ops/spade_block.py:337")
    for key, tags, kernel, removes in KNOCK_VARIANTS]


def captured_process():
    """Phase 11 in a process of its own (chip_smoke.py --captured): its
    launch counts read profiler windows, and a long process's windows lose
    records, the more after CUDA graphs have been recorded and profiled
    (PERF.md section 7). Its output is logged but for its last line."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--captured"], capture_output=True, text=True,
                          timeout=900, cwd=ROOT)
    lines = proc.stdout.splitlines()
    for line in lines[:-1] if proc.returncode == 0 else lines:
        log(line)
    if proc.returncode != 0:
        log(proc.stderr[-6000:])
        raise RuntimeError(f"phase 11 (chip_smoke.py --captured) exited "
                           f"{proc.returncode}")


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
    if sys.argv[1:] == ["--captured"]:
        captured_phase(card)
        _contract_line()
        return
    if sys.argv[1:] == ["--steps"]:
        tmp = tempfile.mkdtemp(prefix="chip_smoke_steps_")
        try:
            r1, r2 = training_trees(tmp)
            with _as_a_user_runs():
                recorded_steps(card, r1, r2)
                _loader_time(card, r2)
                _lpips_head_training(card)
                from hrviton_tpu_torch.core import mesh as mesh_lib
                dev = mesh_lib.init_distributed(
                    f"127.0.0.1:{_free_port()}", 1, 0, "cuda")
                try:
                    recorded_steps(card, r1, r2, mesh_lib.make_mesh(dev))
                finally:
                    mesh_lib.shutdown_distributed()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        _contract_line()
        return
    if sys.argv[1:] == ["--alone"]:
        log(card)
        alone_phase()
        _contract_line()
        return
    if sys.argv[1:2] == ["--sass-diff"] and len(sys.argv) == 3:
        sass_diff(sys.argv[2])
        _contract_line()
        return
    if sys.argv[1:] == ["--knockout"]:
        knockout_phase(card, pairs=10, train_variants=())
        _contract_line()
        return
    if sys.argv[1:] == ["--wgrad"]:
        t, n = wgrad_phase(card)
        log(json.dumps({"name": "wgrad3x3", "launches_a_step": n, **t}))
        _contract_line()
        return
    if sys.argv[1:]:
        sys.exit(f"chip_smoke: unknown arguments {sys.argv[1:]}")
    sass_phase()
    totals = kernel_phase()
    wgrad_totals, _ = wgrad_phase(card)
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
    rows = dict(totals)
    rows["wgrad3x3"] = wgrad_totals
    rows["spade_unit_cli_bf16"] = cli_units
    launches["spade_unit_cli_bf16"] = cli_launches[torch.bfloat16]["spade_unit"]
    torch.cuda.empty_cache()
    tool_totals, tool_launches = tools_phase(card)
    rows.update({k: v[torch.bfloat16] for k, v in tool_totals.items()})
    launches.update(tool_launches)
    torch.cuda.empty_cache()
    rejection_phase(card)
    _free()                 # the graphs of phases 4-8 with their objects
    # phase 9's and phase 10's --fused_block steps are main paths of the
    # unit and the statistics: their launches join those rows
    tmp = tempfile.mkdtemp(prefix="chip_smoke_training_")
    try:
        trees = training_trees(tmp)
        trained, step_ms = training_phase(card, tmp, *trees)
        for key, n in trained.items():
            launches[key] = launches.get(key, 0) + n
        for key, n in data_parallel_phase(card, tmp, *trees, step_ms).items():
            launches[key] += n
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"profiler windows: {WINDOWS['windows']} windows of kernel records, "
        f"{len(WINDOWS['short'])} short: {WINDOWS['short']}")
    _free()
    knock_rows, knock_launches = knockout_phase(card,
                                                cli_ms=step_ms["stage 2"])
    rows.update(knock_rows)
    launches.update(knock_launches)
    _free()
    captured_process()
    record = {"kernels": []}
    ths = {key: t for key, _, t in TOOL_CONVS}
    for key, name, source, replaces in KERNELS + KNOCK_KERNELS:
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
