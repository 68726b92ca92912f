"""Profiling hooks (``hrviton_tpu/utils/profiling.py``): a
``torch.profiler`` trace of a block that is a no-op without a directory,
and per-interval wall-clock timing.

  with trace_if("/tmp/trace"):          # no-op when the dir is falsy
      step(...)
  timer = StepTimer(); ...; timer.lap()
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

__all__ = ["trace_if", "StepTimer"]


@contextlib.contextmanager
def trace_if(trace_dir: Optional[str]):
    """A ``torch.profiler`` trace of the block (CPU, and CUDA where a card
    is present) written as a Chrome trace under ``trace_dir``; nothing when
    ``trace_dir`` is falsy."""
    if not trace_dir:
        yield
        return
    os.makedirs(trace_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


class StepTimer:
    """Wall-clock time per interval (the reference prints time per
    display_count, train_condition.py:134,440)."""

    def __init__(self):
        self._t0 = time.time()

    def lap(self) -> float:
        now = time.time()
        dt = now - self._t0
        self._t0 = now
        return dt
