"""The program's own spans (``hrviton_tpu_torch/utils/profiling``) read from
the timed window of a traced run.

Importing this module turns the program's tracer on. The harness
(``run.cell_metrics``) loads the per-layer metric modules, which import this
one, in ``--trace 1`` runs only, and before ``driver.run``: in a traced run
the tracer is then on from the set-up onward (the pipeline's construction,
the kernels' first loads, the graphs' warm-ups and recordings, the window),
and in every end-to-end run it stays off. The tracing switch joins each
graph's signature, so a traced run's graphs hold the device spans' event
nodes and an untraced run's hold none.

The window is ``[t0 + setup_s, t0 + setup_s + window_s)`` on the host clock
the harness times the set-up with (``time.perf_counter``, the tracer's
clock). A request of the window is a ``tryon_step`` root span that started
in it; a window metric is the mean over those requests of the spans the
requests caused. Set-up metrics read the spans that started before the
window. Nothing is read (None) where the ring dropped records, where a
recording or a kernel's first load fell inside the window, or, for the
device spans, where fewer were harvested than there were requests. A
program without the tracer (an older checkout of the port) gives None too.
"""

from __future__ import annotations

from typing import Iterable, Optional

from hrviton_tpu_torch.utils import profiling

if hasattr(profiling, "enable"):
    profiling.enable()
else:
    profiling = None

ROOT = "tryon_step"
SET_UP = ("graphs.capture", "ops.load")     # none of these in the window


def _records():
    """The tracer's records after a flush, or None if the ring dropped any
    (or the program has no tracer)."""
    if profiling is None:
        return None
    profiling.flush()
    if profiling.counters()["dropped"]:
        return None
    return profiling.spans()


def _bounds(ctx, rec):
    t_start = ctx.t0 + rec["setup_s"]
    return int(t_start * 1e9), int((t_start + rec["window_s"]) * 1e9)


def per_request_ms(ctx, rec, names: Iterable[str],
                   device: bool = False) -> Optional[float]:
    """Milliseconds a request of the window in the spans named ``names``
    (the device's spans where ``device``), summed over each request."""
    names = set(names)
    records = _records()
    if records is None:
        return None
    lo, hi = _bounds(ctx, rec)
    inside = [s for s in records if lo <= s.t0_ns < hi]
    if any(s.name in SET_UP for s in inside):
        return None
    requests = {s.request for s in inside if s.name == ROOT and s.parent is None}
    if not requests:
        return None
    chosen = [s for s in records if s.request in requests and s.name in names
              and s.device == device]
    if device and len(chosen) < len(requests):
        return None
    return sum(s.t1_ns - s.t0_ns for s in chosen) / len(requests) / 1e6


def set_up_s(ctx, rec, name: str, less: Optional[str] = None) -> Optional[float]:
    """Seconds before the window in the spans named ``name``, less the spans
    named ``less`` inside them (their self time)."""
    records = _records()
    if records is None:
        return None
    lo, _ = _bounds(ctx, rec)
    before = [s for s in records if s.t0_ns < lo]
    chosen = [s for s in before if s.name == name]
    if not chosen:
        return None
    total = sum(s.t1_ns - s.t0_ns for s in chosen)
    if less is not None:
        inner = [s for s in before if s.name == less]
        total -= sum(s.t1_ns - s.t0_ns for c in chosen for s in inner
                     if c.t0_ns <= s.t0_ns and s.t1_ns <= c.t1_ns)
    return total / 1e9


def probed(rec, name: str) -> Optional[float]:
    """What the metric ``name``'s probe returned."""
    return (rec.get("probes") or {}).get(name)
