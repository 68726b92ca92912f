"""What the knockout tools share: their size from the environment, the
first path's models, and the timing in pairs.

A knockout times a program whole, then with one piece stubbed (timing only),
and credits the difference to that piece (the JAX tools'
``tools/exp_*_knockout.py``). Here each variant is timed in pairs
alternated with the full program (full, variant, full, variant, ...), by
CUDA events on the card (the host clock on the CPU, where the tools run only
as a smoke); a variant's attribution is the median of its pairs'
differences. The tools run on the card unless ``device="cpu"`` is given.

Sizes (the defaults are ``bench.py``'s configuration): KNOCK_BATCH (4),
KNOCK_H, KNOCK_W (1024, 768: the fine size), KNOCK_COND_H, KNOCK_COND_W (256,
192), KNOCK_NGF (64: the SPADE generator, 'most'), KNOCK_TOCG_NGF (96),
KNOCK_PAIRS (10), read when a ``main`` runs.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Dict

import torch

from hrviton_tpu_torch.tools._common import env_int

__all__ = ["Size", "knock_size", "unit_shapes", "first_path_pipeline",
           "synthetic_batch", "randn", "time_call", "in_pairs", "report",
           "card_name"]


@dataclasses.dataclass(frozen=True)
class Size:
    batch: int
    fh: int
    fw: int
    ch: int
    cw: int
    ngf: int
    tocg_ngf: int
    pairs: int


def knock_size() -> Size:
    return Size(env_int("KNOCK_BATCH", 4), env_int("KNOCK_H", 1024),
                env_int("KNOCK_W", 768), env_int("KNOCK_COND_H", 256),
                env_int("KNOCK_COND_W", 192), env_int("KNOCK_NGF", 64),
                env_int("KNOCK_TOCG_NGF", 96), env_int("KNOCK_PAIRS", 10))


def unit_shapes(size: Size):
    """The fused units of the first path, (name, h, w, c, cout, ksize,
    pre_act, residual): up_3 and up_4's norm_s -> conv_s, norm_0 -> conv_0,
    norm_1 -> conv_1 with the shortcut as the residual (models/spade.py)."""
    nf = size.ngf
    out = []
    for name, h, w, cin, cout in (("up_3", size.fh // 2, size.fw // 2,
                                   2 * nf + 16, nf),
                                  ("up_4", size.fh, size.fw, nf + 16, nf // 2)):
        mid = min(cin, cout)
        out += [(f"{name}.norm_s", h, w, cin, cout, 1, None, False),
                (f"{name}.norm_0", h, w, cin, mid, 3, "leaky0.2", False),
                (f"{name}.norm_1", h, w, mid, cout, 3, "leaky0.2", True)]
    return out


def first_path_pipeline(size: Size, device, dtype=torch.bfloat16, seed=0):
    """``TryOnPipeline`` at ``bench.py``'s configuration (tocg at the
    condition size, SPADE 'most' at the fine size with the fused unit), random
    weights from ``seed``, the SPADE noise scales random too (they
    initialise to zero)."""
    from hrviton_tpu_torch import (PipelineConfig, SPADEGenConfig, TOCGConfig,
                                   TryOnPipeline)
    from hrviton_tpu_torch.models.spade import SPADENorm
    pcfg = PipelineConfig(fine_height=size.fh, fine_width=size.fw,
                          cond_height=size.ch, cond_width=size.cw)
    pipe = TryOnPipeline(
        pcfg, TOCGConfig(ngf=size.tocg_ngf),
        SPADEGenConfig(ngf=size.ngf, num_upsampling_layers="most",
                       fused_block=True, fine_height=size.fh,
                       fine_width=size.fw),
        device=device, dtype=dtype, seed=seed)
    g = torch.Generator().manual_seed(seed + 7)
    with torch.no_grad():
        for m in pipe.generator.modules():
            if isinstance(m, SPADENorm):
                m.noise_scale.copy_(torch.randn(m.noise_scale.shape,
                                                generator=g) * 0.1)
    return pipe


def randn(gen: torch.Generator, shape, dtype=torch.bfloat16, scale=1.0):
    """Standard normals times ``scale`` in ``dtype``, drawn on ``gen``'s
    device: in bulk there (a host draw of the full-size activations takes
    seconds each)."""
    return (torch.randn(shape, generator=gen, device=gen.device)
            * scale).to(dtype)


def synthetic_batch(size: Size, device, dtype=torch.bfloat16, seed=0):
    """A try-on batch of standard normals from ``seed`` (the JAX tools'
    ``arr``), the cloth mask uniform in [0, 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (size.batch, size.fh, size.fw)
    return {"cloth": randn(gen, (*shape, 3), dtype),
            "cloth_mask": torch.rand((*shape, 1), generator=gen,
                                     device=device).to(dtype),
            "parse_agnostic": randn(gen, (*shape, 13), dtype),
            "densepose": randn(gen, (*shape, 3), dtype),
            "agnostic": randn(gen, (*shape, 3), dtype)}


def time_call(fn: Callable, device) -> float:
    """ms of one call of ``fn()``: CUDA events on the card's current stream,
    the host clock on the CPU."""
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t = time.perf_counter()
    fn()
    return (time.perf_counter() - t) * 1e3


def in_pairs(full: Callable, variants: Dict[str, Callable], pairs: int,
             device) -> Dict[str, dict]:
    """Each variant timed in ``pairs`` pairs alternated with ``full`` (one
    warm-up call of each first). Returns {name: {"ms": median of its calls,
    "full_ms": median of the full calls paired with it, "attributed_ms":
    median of the pairs' full - variant}}, with "full" the median of all the
    full calls."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    full()
    for fn in variants.values():
        fn()
    out, fulls = {}, []
    for name, fn in variants.items():
        f_ms, v_ms = [], []
        for _ in range(pairs):
            f_ms.append(time_call(full, device))
            v_ms.append(time_call(fn, device))
        fulls += f_ms
        out[name] = {"ms": statistics.median(v_ms),
                     "full_ms": statistics.median(f_ms),
                     "attributed_ms": statistics.median(
                         f - v for f, v in zip(f_ms, v_ms))}
    if not variants:
        fulls = [time_call(full, device) for _ in range(pairs)]
    out["full"] = {"ms": statistics.median(fulls), "full_ms": None,
                   "attributed_ms": None}
    return out


def report(tag: str, times: Dict[str, dict], card: str = "") -> None:
    """Print ms per variant and what it attributes."""
    print(f"{tag}: full {times['full']['ms']:.3f} ms {card}".rstrip(),
          flush=True)
    for name, t in times.items():
        if name != "full":
            print(f"  {tag} {name:32s} {t['ms']:9.3f} ms  (full {t['full_ms']:.3f})"
                  f"  -> attributed {t['attributed_ms']:8.3f} ms", flush=True)


def card_name(device) -> str:
    if torch.device(device).type != "cuda":
        return "(CPU: no device time)"
    return f"| {torch.cuda.get_device_name(torch.device(device))}"
