#!/usr/bin/env python
"""Per-component timing of the try-on pipeline on the card.

PyTorch counterpart of ``tools/profile_components.py``: each component of
the first path alone (the tocg at the condition size, the blur chain, the
full-size warp, the SPADE generator, each SPADEResBlock of the generator at
its own scale), then the whole pipeline and the condition stage, each as a
replayed CUDA graph (``core/graphs.captured``, the counterpart of the JAX
tool's ``jit``) timed by CUDA events, median of KNOCK_PAIRS calls. The
blocks are built as the first path builds them (the fused unit where its gate
admits them). The difference between the whole and its parts is the glue
between them.

    python -m hrviton_tpu_torch.tools.profile_components

Sizes from the KNOCK_* variables (``tools/_knockout.py``).
"""

from __future__ import annotations

import statistics

import torch

from hrviton_tpu_torch.core import graphs
from hrviton_tpu_torch.device import resolve_device
from hrviton_tpu_torch.models.spade import SPADEResBlock, noise_source
from hrviton_tpu_torch.nn.layers import init_weights
from hrviton_tpu_torch.ops.blur import gaussian_blur
from hrviton_tpu_torch.ops.grid_sample import flow_warp
from hrviton_tpu_torch.ops.parse import onehot, parse13_to_7
from hrviton_tpu_torch.ops.resize import interpolate, resize_flow
from hrviton_tpu_torch.pipelines.tryon import condition_forward
from hrviton_tpu_torch.tools._knockout import (card_name, first_path_pipeline,
                                               knock_size, randn,
                                               synthetic_batch, time_call)

__all__ = ["main"]


def _blur_chain(seg, fh, fw):
    return parse13_to_7(onehot(torch.argmax(gaussian_blur(
        interpolate(seg, (fh, fw), mode="bilinear")[..., :13], (15, 15),
        (3.0, 3.0)), dim=-1), 13, dtype=seg.dtype))


def _warp(cloth, flow, fh, fw, cfg):
    return flow_warp(cloth, resize_flow(flow, (fh, fw), mode="bilinear"),
                     cfg.flow_norm_w, cfg.flow_norm_h)


def _block(blk, x, seg, fields):
    return blk(x, seg, noise_source(fields, x.device))


_tocg = graphs.captured(lambda tocg, a, b: tocg(a, b)[1],
                        weights=lambda tocg, *a: graphs.module_tensors(tocg))
_chain = graphs.captured(_blur_chain)
_warped = graphs.captured(_warp)
_gen = graphs.captured(
    lambda gen, x, s, fields: gen(x, s, fields),
    weights=lambda gen, *a: graphs.module_tensors(gen))
_blk = graphs.captured(_block, weights=lambda blk, *a: graphs.module_tensors(blk))
_cond = graphs.captured(
    lambda pipe, b: (lambda c: c.warped_cloth.float().mean()
                     + c.parse7.float().mean())(
        condition_forward(pipe.tocg, b, pipe.cfg)).reshape(1),
    weights=lambda pipe, *a: graphs.module_tensors(pipe.tocg))


def _ms(fn, pairs, dev):
    fn()
    return statistics.median(time_call(fn, dev) for _ in range(pairs))


def main(device="cuda"):
    """Time each component; returns {component: ms per batch}."""
    dev = resolve_device(device)
    size = knock_size()
    b, fh, fw, ch, cw = size.batch, size.fh, size.fw, size.ch, size.cw
    dt = torch.bfloat16
    rng = torch.Generator(device=dev).manual_seed(0)
    pipe = first_path_pipeline(size, dev)
    gen = pipe.generator
    card = card_name(dev)
    times = {}

    def put(name, ms):
        times[name] = ms
        print(f"{name:46s} {ms:9.3f} ms/batch  {ms / b:8.3f} ms/img {card}",
              flush=True)

    with torch.inference_mode():
        in1, in2 = randn(rng, (b, ch, cw, 4), dt), \
            randn(rng, (b, ch, cw, 16), dt)
        put(f"tocg fwd @{ch}x{cw}",
            _ms(lambda: _tocg(pipe.tocg, in1, in2), size.pairs, dev))
        seg = randn(rng, (b, ch, cw, 13), dt)
        put(f"blur+argmax+regroup+seg-resize @{fh}x{fw}",
            _ms(lambda: _chain(seg, fh, fw), size.pairs, dev))
        cloth4 = randn(rng, (b, fh, fw, 4), dt)
        flow = randn(rng, (b, ch // 2, cw // 2, 2), torch.float32, 3.0)
        put(f"flow resize + grid_sample warp @{fh}x{fw} (4ch)",
            _ms(lambda: _warped(cloth4, flow, fh, fw, pipe.cfg), size.pairs, dev))
        gen_in = randn(rng, (b, fh, fw, 9), dt)
        labels = torch.randint(0, 7, (b, fh, fw), generator=rng, device=dev)
        fields = pipe.noise_fields(b)
        put(f"SPADE generator @{fh}x{fw}",
            _ms(lambda: _gen(gen, gen_in, labels, fields), size.pairs, dev))

        # each block alone at its own scale, as the generator builds it
        sh, sw = gen.cfg.latent_hw
        for i, name in enumerate(gen.block_names):
            ref = getattr(gen, name)
            blk = SPADEResBlock(ref.conv_0.weight.shape[1],
                                ref.conv_1.weight.shape[0], gen.cfg.norm_g,
                                gen.cfg.gen_semantic_nc, fused=ref.fused,
                                device=dev, dtype=dt).eval()
            init_weights(blk, torch.Generator().manual_seed(i))
            h, w = sh * 2 ** i, sw * 2 ** i
            cin = blk.conv_0.weight.shape[1]
            # NCHW views of NHWC memory, as the generator hands them over
            x = randn(rng, (b, h, w, cin), dt).permute(0, 3, 1, 2)
            s = randn(rng, (b, h, w, gen.cfg.gen_semantic_nc),
                      dt).permute(0, 3, 1, 2)
            nf = [randn(rng, shape, torch.float32)
                  for shape in blk.noise_shapes(x.shape)]
            put(f"SPADEResBlock {name} {cin}->{blk.conv_1.weight.shape[0]} @{h}x{w}",
                _ms(lambda: _blk(blk, x, s, nf), size.pairs, dev))
            del blk

        batch = synthetic_batch(size, dev)
        put(f"FULL pipeline @{fh}x{fw}",
            _ms(lambda: pipe(batch), size.pairs, dev))
        put("condition stage (tocg+blur+warp+glue)",
            _ms(lambda: _cond(pipe, batch), size.pairs, dev))
    return times


if __name__ == "__main__":
    main()
