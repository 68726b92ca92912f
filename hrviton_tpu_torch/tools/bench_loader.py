"""Host loader time: the full f32 sample against the compact uint8 wire
format (the counterpart of the JAX ``tools/bench_loader.py``).

One worker (the calling thread) decodes ``VitonHDDataset`` training samples
of a synthetic tree (``data/synthetic.make_synthetic_dataset``) at 1024x768
in both formats and prints the host milliseconds per sample and the bytes a
sample carries to the device. CPU only: it measures what the host spends
between two training steps, not the card::

    python -m hrviton_tpu_torch.tools.bench_loader      # BL_SAMPLES=8

``main(root=...)`` times an existing tree (its ``train`` split) instead of
writing one under the temporary directory.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Dict, Optional

from hrviton_tpu_torch.config import DataConfig

__all__ = ["main"]


def _leaves(d):
    for v in d.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        elif hasattr(v, "nbytes"):
            yield v


def main(root: Optional[str] = None, n: Optional[int] = None, h: int = 1024,
         w: int = 768) -> Dict[str, Dict[str, float]]:
    """{'full' | 'compact': {'ms': host ms per sample, 'mb': MB a sample}}
    over ``n`` samples (``BL_SAMPLES``, default 8) after one warm-up
    sample."""
    from hrviton_tpu_torch.data.dataset import VitonHDDataset
    from hrviton_tpu_torch.data.synthetic import make_synthetic_dataset
    n = int(os.environ.get("BL_SAMPLES", "8")) if n is None else n
    with tempfile.TemporaryDirectory(prefix="viton_loader_bench_") as tmp:
        if root is None:
            root = make_synthetic_dataset(tmp, n=4, w=w, h=h, modes=("train",))
        cfg = DataConfig(dataroot=root, datamode="train",
                         data_list="train_pairs.txt", fine_height=h,
                         fine_width=w)
        out = {}
        for compact in (False, True):
            ds = VitonHDDataset(cfg, mode="train", compact=compact)
            ds[0]                                   # warm the caches
            t0 = time.perf_counter()
            for i in range(n):
                ds[i % len(ds)]
            dt = (time.perf_counter() - t0) / n
            mb = sum(a.nbytes for a in _leaves(ds[0])) / 1e6
            name = "compact" if compact else "full"
            out[name] = {"ms": dt * 1e3, "mb": mb}
            print(f"{name:8s} {dt * 1e3:7.1f} ms/sample/core   wire "
                  f"{mb:6.1f} MB   ({h}x{w}, {n} samples, one worker, "
                  f"{os.cpu_count()} cores)", flush=True)
    return out


if __name__ == "__main__":
    main()
