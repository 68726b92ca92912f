"""The port's tracer: host spans and device spans, kept in memory.

Off by default. ``enable()`` / ``disable()`` switch it, ``enabled()`` reads
it, and ``HRVITON_TRACE=1`` in the environment turns it on when this module
is first imported. The switch joins every graph signature
(``core/graphs.register_state``): a graph recorded with tracing off has no
tracing nodes, and turning tracing on records it anew.

- **Host spans**, ``with span(name, owner):``. Off, ``span`` returns one
  shared no-op context (no allocation, no clock read). On, each span
  appends one ``Span`` to a bounded ring when it closes: its name, its
  ``owner`` (the entry point, where there is one), its request, its parent
  and its start and end on ``time.perf_counter_ns()``. A span opened while
  no other is open on its thread is a request's root and takes a new
  request id; every span inside it carries that id. A full ring drops its
  oldest records and counts them (``counters()["dropped"]``). While a
  ``torch.profiler`` session is active, and only then, a span also opens
  ``record_function("<name>[<owner>]")`` (the brackets empty without an
  owner, so that no range takes the name of a caller's own), so that the
  program's spans are on the device trace's clock.
- **Device spans**, ``with device_span(name, device):`` around work
  launched on ``device``. Off, nothing. Inside a graph being recorded
  (``Captured``, which opens ``collect()``), a timing event is recorded
  before and after the block, as event nodes of the graph, and the pair is
  kept with the graph (``Marks``). At each replay the graph's marks are
  pending with the launch's request; before the next launch of the same
  graph, which overwrites its events, they are harvested with
  ``elapsed_time``: if that replay has not ended, the harvest waits for its
  last event and counts the wait (``counters()["waits"]``). ``flush()``
  harvests whatever is pending. An eager call on the card records fresh
  events, harvested once they have completed or by ``flush()``. Elsewhere
  (the CPU) a device span is timed by the host clock, as a host span.
  ``EVENTS`` is the event source; a test replaces it to let the CPU stand
  in for the card, as ``Captured.device_type`` does.

Readers: ``spans()`` (a snapshot, oldest first), ``counters()``, ``flush()``
and ``clear()``. A ``Span``'s ``device`` is true when the device's events
timed it; its ``t0_ns`` is then the launch's host time and ``t1_ns - t0_ns``
the device time.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
import weakref
from typing import List, NamedTuple, Optional

import torch

__all__ = ["Span", "Marks", "CudaEvents", "EVENTS", "RING", "enable",
           "disable", "enabled", "span", "device_span", "collect", "spans",
           "counters", "flush", "clear"]

RING = 1 << 18          # records kept; the oldest are dropped beyond it


class Span(NamedTuple):
    id: int
    name: str
    owner: Optional[str]
    request: int
    parent: Optional[int]
    t0_ns: int
    t1_ns: int
    device: bool            # timed by the device's events


class CudaEvents:
    """The event source of device spans on the card."""

    device_type = "cuda"

    @staticmethod
    def event():
        return torch.cuda.Event(enable_timing=True, external=True)


EVENTS = CudaEvents()

_ON = os.environ.get("HRVITON_TRACE") == "1"
_NOOP = contextlib.nullcontext()
_RING: collections.deque = collections.deque(maxlen=RING)
_LOCK = threading.Lock()
_COUNTS = {"dropped": 0, "waits": 0}
_IDS = itertools.count(1)
_REQUESTS = itertools.count(1)
_LOCAL = threading.local()       # .stack: the open spans' (id, request)
_COLLECT: Optional[list] = None  # the marks of the graph being recorded
_PENDING: "weakref.WeakSet[Marks]" = weakref.WeakSet()
_EAGER: collections.deque = collections.deque()   # (record, start, end)


def enable() -> None:
    global _ON
    _ON = True


def disable() -> None:
    global _ON
    _ON = False


def enabled() -> bool:
    return _ON


def _append(rec: Span) -> None:
    with _LOCK:
        if len(_RING) == _RING.maxlen:
            _COUNTS["dropped"] += 1
        _RING.append(rec)


def _stack() -> list:
    s = getattr(_LOCAL, "stack", None)
    if s is None:
        s = _LOCAL.stack = []
    return s


def _open(push: bool = True):
    """(id, request, parent) of a span opening now on this thread, pushed
    on its stack of open spans with ``push``."""
    stack = _stack()
    sid = next(_IDS)
    if stack:
        parent, request = stack[-1]
    else:
        parent, request = None, next(_REQUESTS)
    if push:
        stack.append((sid, request))
    return sid, request, parent


class _Host:
    __slots__ = ("name", "owner", "sid", "request", "parent", "t0", "rf")

    def __init__(self, name, owner):
        self.name, self.owner = name, owner

    def __enter__(self):
        self.sid, self.request, self.parent = _open()
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(
                f"{self.name}[{self.owner or ''}]")
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _stack().pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _append(Span(self.sid, self.name, self.owner, self.request,
                     self.parent, self.t0, t1, False))
        return False


def span(name: str, owner: Optional[str] = None):
    """A host span around the block (module docstring); the shared no-op
    when tracing is off."""
    if not _ON:
        return _NOOP
    return _Host(name, owner)


class Marks:
    """The device spans recorded into one graph, ``(name, start, end)`` in
    recording order, and the replay whose times they hold (``pending``)."""

    def __init__(self, owner: Optional[str] = None):
        self.owner = owner
        self.pairs: List[tuple] = []
        self.pending = None

    def launched(self) -> None:
        """After a replay: its times are pending under the open span (the
        launch; a graph with marks was recorded with tracing on, and only
        then replays) and its request."""
        if not self.pairs:
            return
        parent, request = _stack()[-1]
        self.pending = (request, parent, time.perf_counter_ns())
        _PENDING.add(self)

    def harvest(self) -> None:
        """The pending replay's spans into the ring, waiting for its last
        event if it has not completed (call before the next replay)."""
        if self.pending is None:
            return
        request, parent, t = self.pending
        self.pending = None
        _PENDING.discard(self)
        last = self.pairs[-1][2]
        if not last.query():
            _COUNTS["waits"] += 1
            last.synchronize()
        for name, a, b in self.pairs:
            _append(Span(next(_IDS), name, self.owner, request, parent, t,
                         t + round(a.elapsed_time(b) * 1e6), True))


@contextlib.contextmanager
def collect(marks: Marks):
    """Device spans opened inside the block are recorded into ``marks`` (the
    graph being recorded)."""
    global _COLLECT
    saved, _COLLECT = _COLLECT, marks.pairs
    try:
        yield marks
    finally:
        _COLLECT = saved


class _Device:
    __slots__ = ("name", "device", "start", "host", "t0")

    def __init__(self, name, device):
        self.name, self.device = name, torch.device(device)

    def __enter__(self):
        self.start = self.host = None
        if self.device.type == EVENTS.device_type:
            self.t0 = time.perf_counter_ns()
            self.start = EVENTS.event()
            self.start.record()
        elif _COLLECT is None:
            self.host = _Host(self.name, None).__enter__()
        return self

    def __exit__(self, *exc):
        if self.host is not None:
            return self.host.__exit__(*exc)
        if self.start is None:
            return False
        end = EVENTS.event()
        end.record()
        if _COLLECT is not None:
            _COLLECT.append((self.name, self.start, end))
            return False
        while _EAGER and _EAGER[0][2].query():
            _harvest_eager()
        sid, request, parent = _open(push=False)
        _EAGER.append((Span(sid, self.name, None, request, parent, self.t0,
                            self.t0, True), self.start, end))
        return False


def _harvest_eager() -> None:
    rec, a, b = _EAGER.popleft()
    b.synchronize()
    _append(rec._replace(t1_ns=rec.t0_ns + round(a.elapsed_time(b) * 1e6)))


def device_span(name: str, device):
    """A device span around work launched on ``device`` (module docstring);
    nothing when tracing is off."""
    if not _ON:
        return _NOOP
    return _Device(name, device)


def flush() -> None:
    """Harvest every pending device span (waits for its work to end)."""
    for marks in list(_PENDING):
        marks.harvest()
    while _EAGER:
        _harvest_eager()


def spans() -> List[Span]:
    """The records in the ring, oldest first."""
    with _LOCK:
        return list(_RING)


def counters() -> dict:
    """``dropped``: records the ring lost; ``waits``: harvests that waited
    for a replay to end."""
    return dict(_COUNTS)


def clear() -> None:
    """Empty the ring, forget pending device spans, zero the counters."""
    with _LOCK:
        _RING.clear()
        _COUNTS.update(dropped=0, waits=0)
    for marks in list(_PENDING):
        marks.pending = None
    _PENDING.clear()
    _EAGER.clear()
