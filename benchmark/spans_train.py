"""The training step's spans read from the timed window of a traced run.

Importing this module imports ``benchmark/spans.py``, which turns the
program's tracer on (in traced runs only: the harness loads the per-layer
metrics, and so this module, before the driver's set-up). A step of the
window is a ``train_step`` root span (``cli/train_generator.train_step``)
that started in ``[t0 + setup_s, t0 + setup_s + window_wall_s)``: the
window on the host clock, the copies around the sampled steps included.
A window metric is the mean over those steps of the spans each step
caused. Nothing is read (None) where ``benchmark/spans.py`` reads nothing:
the ring dropped records, a recording or a kernel's first load fell in the
window, fewer device spans were harvested than there were steps, or the
program has no tracer.
"""

from __future__ import annotations

from typing import Iterable, Optional

from benchmark import spans

ROOT = "train_step"


def per_step_ms(ctx, rec, names: Iterable[str],
                device: bool = True) -> Optional[float]:
    """Milliseconds a step of the window in the spans named ``names`` (the
    device's spans where ``device``), summed over each step."""
    names = set(names)
    records = spans._records()
    if records is None:
        return None
    lo = int((ctx.t0 + rec["setup_s"]) * 1e9)
    hi = lo + int(rec.get("window_wall_s", rec["window_s"]) * 1e9)
    inside = [s for s in records if lo <= s.t0_ns < hi]
    if any(s.name in spans.SET_UP for s in inside):
        return None
    steps = {s.request for s in inside if s.name == ROOT and s.parent is None}
    if not steps:
        return None
    chosen = [s for s in records if s.request in steps and s.name in names
              and s.device == device]
    if device and len(chosen) < len(steps):
        return None
    return sum(s.t1_ns - s.t0_ns for s in chosen) / len(steps) / 1e6
