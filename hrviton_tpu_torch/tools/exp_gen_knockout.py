#!/usr/bin/env python
"""Composed knockout attribution of the generator stage (timing only).

PyTorch counterpart of ``tools/exp_gen_knockout.py``: the first path
(``TryOnPipeline`` at ``bench.py``'s configuration: tocg ngf=96 at 256x192,
SPADE ngf=64 'most' at 1024x768 with the fused unit, bf16, batch 4) timed
whole, then with one generator piece stubbed (``models/spade.py:gen_knock``),
and the difference credited to that piece. The knocks are the JAX tool's
(``spade.KNOCKS``) and "skeleton" (all of them at once). The pipeline's call
replays one CUDA graph per knock set (``core/graphs.py``), as a user's call
does; the same variants run eagerly (``graphs.disabled()``) are the second
figure.

    python -m hrviton_tpu_torch.tools.exp_gen_knockout [knock ...]

Sizes from the KNOCK_* variables (``tools/_knockout.py``).
"""

from __future__ import annotations

import sys

from hrviton_tpu_torch.core import graphs
from hrviton_tpu_torch.device import resolve_device
from hrviton_tpu_torch.models.spade import KNOCKS, gen_knock
from hrviton_tpu_torch.tools._knockout import (card_name, first_path_pipeline,
                                               in_pairs, knock_size, report,
                                               synthetic_batch)

__all__ = ["variant_tags", "main"]


def variant_tags(names):
    """{name: tag set} of the named variants ("skeleton": every knock)."""
    return {n: KNOCKS if n == "skeleton" else (n,) for n in names}


def main(which=(), device="cuda"):
    """Time the first path and its knocked variants, replayed and eager;
    returns {"replayed": times, "eager": times} (``in_pairs``)."""
    dev = resolve_device(device)
    size = knock_size()
    pipe = first_path_pipeline(size, dev)
    batch = synthetic_batch(size, dev)
    tags = variant_tags(which or (*KNOCKS, "skeleton"))
    card = card_name(dev)

    def request(knock=()):
        with gen_knock(knock):
            return pipe(batch)[0]
    variants = {n: (lambda t=t: request(t)) for n, t in tags.items()}
    out = {"replayed": in_pairs(request, variants, size.pairs, dev)}
    report(f"first path b{size.batch} {size.fh}x{size.fw} replayed",
           out["replayed"], card)
    with graphs.disabled():
        out["eager"] = in_pairs(request, variants, size.pairs, dev)
    report(f"first path b{size.batch} {size.fh}x{size.fw} eager",
           out["eager"], card)
    return out


if __name__ == "__main__":
    main(tuple(sys.argv[1:]))
