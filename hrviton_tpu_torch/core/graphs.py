"""Capture cache: the port's counterpart of ``jax.jit`` for its entry
points, inference and training.

The JAX package runs each entry point as one compiled program per input
signature (``pipelines/tryon.py``, the CLIs' ``run_impl``s, evaluate's LPIPS
and Inception; the trainers' steps, eval calls and ``expand``s).
``captured(fn)`` gives a function the same on the card: the first call with
a new signature records ``fn`` once as a ``torch.cuda.CUDAGraph`` and every
later call with that signature replays it. On the CPU, and inside
``disabled()`` (the counterpart of ``jax.disable_jit``), it is the plain
call. A captured function called inside another's warm-up or recording is
its plain call, recorded into the other's graph (a jitted function called
inside a jit is inlined).

- **Signature** (``jit``'s cache key, with its static arguments): the
  shapes, dtypes and devices of the tensor leaves of the arguments
  (nested dicts, lists, tuples and named tuples), every other leaf by value
  if it hashes by value, else by identity (a module, a pipeline: the entries
  of an object are dropped when it dies), the ``context(*args)`` the caller
  names (a generator's config, its blocks' fused flags), the grad mode,
  cuDNN's and the matmuls' TF32 and algorithm flags and every switch a
  module registered (``register_state``: the dispatch knobs).
- **Weights**: ``weights(*args)`` names the tensors the function reads
  besides its arguments (a module's parameters and buffers). A graph reads
  them in place; when one of them is written (its version counter moves) or
  replaced (another data pointer), the graph of that signature is captured
  anew, so it never computes with a stale weight or a stale packed copy of
  one (``ops/conv_engine.packed``).
- **Capture**: the arguments are copied into static buffers; one eager call
  on the capture stream warms up (it builds the kernels, fills the packing
  cache, lets cuDNN choose its algorithms, sets the kernels' attributes,
  creates NCCL's communicators); then the call is recorded. Everything the
  graph reads that it did not allocate is held with it (``hold``). A
  capture that fails raises: there is no eager substitute on the card.
- **Replay**: the arguments are copied into the static buffers, the graph
  runs, and the outputs are cloned out (a jitted function's results are
  fresh arrays, a replay overwrites its static outputs). The kernels'
  Python-side launch counters (``register_counters``) count in a replay what
  the call launched when it was recorded, so a request counts the same
  eager and replayed; the warm-up and the recording count once, as the
  first call.
- **Memory**: the graphs of one ``Captured`` share one private pool, or
  those of several given one ``Pool`` (a trainer's step and eval calls: a
  recording takes what the others leave free between their runs). A failed
  capture leaves the pool to its graphs, and so does one whose graphs all
  died; the next capture takes a new one. A pool keeps the segments its
  recordings allocated: with the allocator's fixed segments, as much as one
  eager call's cache grows by from an emptied cache, well above the call's
  peak (eagerly the allocator gives the rest back when an allocation
  fails); with expandable segments, about the peak.
- **Tracing** (``utils/profiling``): a call's phases are host spans owned
  by the entry point's name, ``graphs.signature``, ``graphs.weights``,
  ``graphs.capture`` (the warm-up and the recording), ``graphs.copy_in``,
  ``graphs.launch`` and ``graphs.clone_out``. The tracing switch joins the
  signature; the device spans a recording makes are kept with its entry,
  and each launch first harvests the last replay's.

**Steps** (``donated``: the counterpart of ``donate_argnums``). A training
step advances state in place: ``donated(*args)`` names it, the tensors (the
parameters, Adam's moments and step counts, BatchNorm's running statistics,
the spectral u/v) and the ``torch.Generator``s it draws from. Each call
takes exactly one step, the first too: the state is copied before the
warm-up and put back after it, and the new graph is then replayed once.
(The other way, the warm-up's own step kept and the recording left out,
would return the first call's results from another program than every later
call's and leave what the body assigns on the host, the parameters'
``.grad``, pointing at the graph's buffers before any replay has written
them.) The donated tensors and the weights are watched together, and their
signature is taken after each call: what the step wrote is the graph's own,
a replay moves no version counter, and a write from outside (a checkpoint
loaded in place, ``cast_floating``'s ``.data``, a caller's ``clamp_``)
records anew. Python counters (``state.step``, ``Adam.count``) and host
reads stay out of the body: the caller moves them around the call, once.
A donated CUDA generator is registered with the graph
(``CUDAGraph.register_generator_state``), so each replay draws at its
offset and advances it as an eager call does; the default generator is the
capture's own (its state is put back after the warm-up too); noise the
caller can draw before the call (the SPADE fields) comes in as arguments.

On the card (torch 2.11, CUDA 12.8, NCCL 2.28.9; tests/test_torch_cuda.py
and ``chip_smoke.py``): a step that takes its gradients with
``torch.autograd.grad`` and recomputes blocks under
``torch.utils.checkpoint`` (``preserve_rng_state=False``) records under
each of the three ``capture_error_mode``s. The autograd engine runs
backward on its own device thread, on the capture stream (the stream of the
forward), and the allocator routes that thread's allocations to the pool;
``thread_local`` is kept, so that only the recording thread's own unsafe
calls (a sync, a pageable copy) fail it, not a loader thread's. NCCL
collectives inside a step (``core/mesh.average_grads``, ``mean_metrics``,
BatchNorm's global moments) record as nodes of the graph with no setting
changed: the warm-up creates the communicator, and torch does not hand work
enqueued during a capture to its watchdog.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Any, Callable, Dict, Iterable, List, NamedTuple, Optional

import numpy as np
import torch

from hrviton_tpu_torch.utils import profiling

__all__ = ["captured", "Captured", "Pool", "disabled", "enabled", "Count",
           "register_counters", "register_state", "hold", "module_tensors",
           "constant"]

_OFF = 0                 # depth of disabled() blocks
_COUNTERS: List[Any] = []          # wrappers with a ``launches`` count
_STATES: List[Callable[[], Any]] = []   # readers of module-level switches
_HOLD: Optional[list] = None       # what the graph being recorded reads
_TRACING = 0             # depth of warm-ups and recordings under way
CAPTURE_ERROR_MODE = "thread_local"
_CONSTANTS: Dict[Any, torch.Tensor] = {}


@contextlib.contextmanager
def disabled():
    """Inside the block every captured function runs its plain call (the
    counterpart of ``jax.disable_jit``): the checks' and the tests' eager
    reference."""
    global _OFF
    _OFF += 1
    try:
        yield
    finally:
        _OFF -= 1


def enabled() -> bool:
    return _OFF == 0


class Count:
    """A count that no wrapper holds (a kernel variant's launches, an op's
    calls), read and replayed as a wrapper's ``launches``."""
    launches = 0


def register_counters(*wrappers) -> None:
    """Kernel wrappers (or ``Count``s) whose ``launches`` count a replay
    adds to."""
    for w in wrappers:
        if not any(w is c for c in _COUNTERS):
            _COUNTERS.append(w)


def register_state(reader: Callable[[], Any]) -> None:
    """A module-level switch a traced function would read: ``reader()``
    (hashable) joins every signature."""
    _STATES.append(reader)


# a graph recorded with tracing on holds its device spans' event nodes
register_state(profiling.enabled)


def hold(value):
    """Keep ``value`` alive as long as the graph being recorded, if one is
    (a cached operand made outside the graph that the graph reads)."""
    if _HOLD is not None:
        _HOLD.append(value)
    return value


def constant(array, device, dtype=None) -> torch.Tensor:
    """A host constant (a numpy array or a sequence of numbers) as a tensor
    on ``device`` (in ``dtype``, else the array's), copied there once per
    (device, dtype, contents), as XLA folds constants into its program: a
    copy per call is a pageable host-to-device copy, which synchronises the
    host in eager mode and is forbidden inside a capture."""
    a = np.ascontiguousarray(array)
    key = (torch.device(device), dtype, a.dtype.str, a.shape, a.tobytes())
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.from_numpy(a).to(key[0], dtype)
    return t


def module_tensors(*modules) -> List[torch.Tensor]:
    """The parameters and buffers of the modules (None skipped)."""
    out: List[torch.Tensor] = []
    for m in modules:
        if m is not None:
            out.extend(m.parameters())
            out.extend(m.buffers())
    return out


def _global_state():
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    return (torch.is_grad_enabled(), torch.is_inference_mode_enabled(),
            cudnn.enabled, cudnn.benchmark, cudnn.deterministic,
            cudnn.allow_tf32, matmul.allow_tf32,
            torch.get_float32_matmul_precision(),
            tuple(r() for r in _STATES))


def _version(t: torch.Tensor):
    return None if t.is_inference() else t._version


def _weights_signature(tensors: Iterable[torch.Tensor]):
    return tuple((t.data_ptr(), _version(t), t.dtype) for t in tensors)


class _Static(NamedTuple):
    """A non-tensor leaf: by value, or by identity (``ref``)."""
    value: Any
    ref: bool


def _by_identity(x) -> bool:
    return type(x).__hash__ is object.__hash__


def _flatten(tree, leaves: list, objects: list):
    """The structure of ``tree`` (hashable) with its tensors appended to
    ``leaves`` and the leaves held by identity to ``objects``."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (type(tree), tuple(_flatten(v, leaves, objects) for v in tree))
    if isinstance(tree, (list, tuple)):
        return (type(tree), tuple(_flatten(v, leaves, objects) for v in tree))
    if isinstance(tree, dict):
        return (dict, tuple((k, _flatten(v, leaves, objects))
                            for k, v in tree.items()))
    if _by_identity(tree):
        objects.append(tree)
        return _Static(id(tree), True)
    return _Static(tree, False)


def _unflatten(spec, tensors, objects):
    """Rebuild what ``_flatten`` took apart: tensors from the iterator
    ``tensors``, identity leaves from ``objects`` (id -> object)."""
    if spec is None:
        return next(tensors)
    if isinstance(spec, _Static):
        return objects[spec.value] if spec.ref else spec.value
    kind, items = spec
    if kind is dict:
        return {k: _unflatten(v, tensors, objects) for k, v in items}
    vals = [_unflatten(v, tensors, objects) for v in items]
    if hasattr(kind, "_fields"):
        return kind(*vals)
    return kind(vals)


class _Entry:
    """One recorded signature: the graph, its static buffers, the counters'
    increase per call, what it holds, its weights' signature."""

    def __init__(self, graph, inputs, out_spec, outputs, out_objects, counts,
                 held, marks):
        self.graph, self.inputs = graph, inputs
        self.out_spec, self.outputs = out_spec, outputs
        self.out_objects = out_objects
        self.counts, self.held = counts, held
        self.marks = marks              # its device spans (utils/profiling)
        self.weights_sig = None         # set by the call that records it
        self.replays = 0


def _counts() -> List[int]:
    return [c.launches for c in _COUNTERS]


def _set_counts(values: List[int]) -> None:
    for c, v in zip(_COUNTERS, values):
        c.launches = v


class Pool:
    """A private memory pool for the graphs of several captured functions
    (module docstring, "Memory"), with the side stream they are warmed up
    and recorded on (the allocator reuses a freed block on its own stream
    only). They run one at a time, and each keeps in the pool only its
    static outputs, which a replay clones out: what a graph writes and a
    caller reads later (a step's gradients) lives outside (``hold``)."""

    def __init__(self):
        self.handle = None
        self.stream = None
        self.users: List["Captured"] = []

    def in_use(self) -> bool:
        """Whether a graph of the pool is cached."""
        return any(c.entries for c in self.users)


class Captured:
    """``fn`` recorded once per signature and replayed on a CUDA device
    (module docstring); the plain call on the CPU and under ``disabled()``.
    ``weights(*args, **kwargs)``: the tensors ``fn`` reads besides its
    arguments; ``context(*args, **kwargs)``: hashable state of identity
    arguments that changes what ``fn`` does; ``donated(*args, **kwargs)``:
    the state ``fn`` advances in place (tensors and ``torch.Generator``s),
    which makes each call one step (module docstring, "Steps"); ``pool``: a
    ``Pool`` shared with other captured functions (else one of its own)."""

    device_type = "cuda"    # the device whose calls are recorded

    def __init__(self, fn: Callable, weights: Optional[Callable] = None,
                 context: Optional[Callable] = None,
                 donated: Optional[Callable] = None,
                 pool: Optional[Pool] = None):
        self.fn, self.weights, self.context = fn, weights, context
        self.donated = donated
        self.entries: Dict[Any, _Entry] = {}
        self.captures = 0
        self._last = None               # the entry of the last replay, weakly
        self._pool = Pool() if pool is None else pool
        self._pool.users.append(self)
        self._watched: Dict[int, Any] = {}
        self.__name__ = getattr(fn, "__name__", "captured")
        self.__doc__ = getattr(fn, "__doc__", None)

    @property
    def pool(self):
        """The handle of the graphs' private memory pool (None before a
        recording)."""
        return self._pool.handle

    @property
    def last_entry(self) -> Optional[_Entry]:
        """The entry of the last replay while it is cached (a dropped entry's
        graph and pool memory are not held here)."""
        return None if self._last is None else self._last()

    # -- signature

    def _signature(self, args, kwargs):
        leaves: list = []
        objects: list = []
        spec = _flatten((args, kwargs), leaves, objects)
        dev = next((t.device for t in leaves), None)
        key = (spec, tuple((tuple(t.shape), t.dtype, t.device) for t in leaves),
               _global_state(),
               None if self.context is None else self.context(*args, **kwargs))
        return key, leaves, objects, dev

    def _weights_sig(self, args, kwargs):
        """The signature of what the graphs read in place: the weights and
        the donated tensors."""
        tensors: list = []
        if self.weights is not None:
            tensors.extend(self.weights(*args, **kwargs))
        if self.donated is not None:
            tensors.extend(t for t in self.donated(*args, **kwargs)
                           if isinstance(t, torch.Tensor))
        return _weights_signature(tensors)

    def _watch(self, objects) -> None:
        """Drop the entries of an identity argument when it dies (its id
        may then name another object)."""
        for obj in objects:
            oid = id(obj)
            if oid not in self._watched:
                try:
                    self._watched[oid] = weakref.finalize(obj, self._forget, oid)
                except TypeError:       # not weakly referable: held for good
                    self._watched[oid] = obj

    def _forget(self, oid: int) -> None:
        self._watched.pop(oid, None)
        for key in [k for k in self.entries if _mentions(k[0], oid)]:
            del self.entries[key]

    # -- calls

    def __call__(self, *args, **kwargs):
        if not enabled() or _TRACING:
            return self.fn(*args, **kwargs)
        with profiling.span("graphs.signature", self.__name__):
            key, leaves, objects, dev = self._signature(args, kwargs)
        if dev is None or dev.type != self.device_type:
            return self.fn(*args, **kwargs)
        with profiling.span("graphs.weights", self.__name__):
            wsig = self._weights_sig(args, kwargs)
        entry = self.entries.get(key)
        fresh = entry is None or entry.weights_sig != wsig
        if fresh:
            # the graph being replaced lives until the new one is recorded:
            # its pool is then still in use, and the new graph takes the
            # memory of its temporaries (a pool whose graphs have all died
            # cannot take another: the next capture starts a new pool)
            old = self.entries.pop(key, None)
            if old is None and not self._pool.in_use():
                self._pool.handle = None
            self._watch(objects)
            with profiling.span("graphs.capture", self.__name__):
                entry = self.entries[key] = self._capture(
                    key[0], leaves, objects, dev)
            del old
        self._last = weakref.ref(entry)
        out = self._replay(entry, leaves)
        if fresh or self.donated is not None:
            # the signature after the call: what the call itself wrote (the
            # warm-up, the restore and the recording move version counters;
            # a replay moves none) is the graph's own, and only a write from
            # outside records anew
            with profiling.span("graphs.weights", self.__name__):
                entry.weights_sig = self._weights_sig(args, kwargs)
        return out

    def _capture(self, spec, leaves, objects, dev) -> _Entry:
        global _TRACING
        inputs = [torch.empty_like(t) for t in leaves]
        for s, t in zip(inputs, leaves):
            s.copy_(t)
        s_args, s_kwargs = _unflatten(spec, iter(inputs),
                                      {id(o): o for o in objects})
        state = ([] if self.donated is None
                 else list(self.donated(*s_args, **s_kwargs)))
        gens = [g for g in state if isinstance(g, torch.Generator)]
        if self.donated is not None and dev.type == "cuda":
            # a draw from the default generator moves it too
            gens.append(torch.cuda.default_generators[dev.index or 0])
        tensors = [t for t in state if isinstance(t, torch.Tensor)]
        before = _counts()
        _TRACING += 1
        try:
            saved = _snapshot(tensors, gens)
            self._warm_up(s_args, s_kwargs, dev)
            warm = _counts()
            # the warm-up's step undone: the call's step is the replay's
            _restore(tensors, gens, saved)
            del saved
            with profiling.collect(profiling.Marks(self.__name__)) as marks:
                graph, out, held = self._record(s_args, s_kwargs, dev, gens)
            recorded = [a - b for a, b in zip(_counts(), warm)]
        finally:
            _TRACING -= 1
            _set_counts(before)
        outputs: list = []
        out_objects: list = []
        out_spec = _flatten(out, outputs, out_objects)
        self.captures += 1
        return _Entry(graph, inputs, out_spec, outputs,
                      {id(o): o for o in out_objects}, recorded, held, marks)

    def _warm_up(self, s_args, s_kwargs, dev) -> None:
        """One eager call on the capture stream (it builds the kernels, fills
        the packing cache, lets cuDNN choose its algorithms, sets the
        kernels' attributes, joins NCCL's communicators)."""
        pool = self._pool
        if pool.handle is None:
            pool.handle = torch.cuda.graph_pool_handle()
        if pool.stream is None or pool.stream.device != dev:
            pool.stream = torch.cuda.Stream(dev)
        stream = pool.stream
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self.fn(*s_args, **s_kwargs)
        stream.synchronize()

    def _record(self, s_args, s_kwargs, dev, gens):
        """``fn`` recorded into a graph of this entry point's pool: (graph,
        its outputs, what it holds)."""
        global _HOLD
        held: list = []
        # the cudaGraph_t is kept after capture, so that the graph can be
        # dumped (debug_dump) and its nodes counted
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for g in gens:
            _register(graph, g)
        stream = self._pool.stream
        stream.wait_stream(torch.cuda.current_stream(dev))
        _HOLD = held
        # the outer stream block restores the caller's stream even when a
        # failed capture leaves torch.cuda.graph's own block open
        try:
            with torch.cuda.stream(stream), torch.cuda.graph(
                    graph, pool=self._pool.handle, stream=stream,
                    capture_error_mode=CAPTURE_ERROR_MODE):
                out = self.fn(*s_args, **s_kwargs)
        except BaseException:
            self._abandon_pool(dev)
            raise
        finally:
            _HOLD = None
        graph.instantiate()
        torch.cuda.current_stream(dev).wait_stream(stream)
        return graph, out, held

    def _abandon_pool(self, dev) -> None:
        """After a failed capture: the allocator stops routing to the pool
        (torch's capture_end raises before it would), and later captures
        take a new pool."""
        try:
            torch._C._cuda_endAllocateToPool(dev.index, self._pool.handle)
        except RuntimeError:
            pass
        self._pool.handle = None

    def _replay(self, entry: _Entry, leaves):
        name = self.__name__
        with profiling.span("graphs.copy_in", name):
            for s, t in zip(entry.inputs, leaves):
                s.copy_(t)
        with profiling.span("graphs.launch", name):
            # the last replay's device spans, before this one overwrites them
            entry.marks.harvest()
            entry.graph.replay()
            entry.marks.launched()
        entry.replays += 1
        for c, n in zip(_COUNTERS, entry.counts):
            c.launches += n
        clones: Dict[int, torch.Tensor] = {}     # an output returned twice
        with profiling.span("graphs.clone_out", name):
            for t in entry.outputs:              # is cloned once
                if id(t) not in clones:
                    clones[id(t)] = t.clone()
        return _unflatten(entry.out_spec, (clones[id(t)] for t in entry.outputs),
                          entry.out_objects)


def _snapshot(tensors, gens):
    """Copies of the donated tensors and the generators' states."""
    with torch.no_grad():
        return [t.detach().clone() for t in tensors], [g.get_state() for g in gens]


def _restore(tensors, gens, saved) -> None:
    with torch.no_grad():
        for t, s in zip(tensors, saved[0]):
            t.copy_(s)
    for g, s in zip(gens, saved[1]):
        g.set_state(s)


def _register(graph, generator) -> None:
    """Let ``graph`` draw from ``generator`` (the default CUDA generator is
    the capture's own): each replay then draws at the generator's offset
    and advances it, as an eager call does."""
    if generator.device.type != "cuda" or \
            generator is torch.cuda.default_generators[generator.device.index or 0]:
        return
    register = getattr(graph, "register_generator_state", None)
    if register is None:
        raise RuntimeError("this torch cannot record a draw from a generator "
                           "of the caller's (CUDAGraph.register_generator_state)")
    register(generator)


def _mentions(spec, oid: int) -> bool:
    if isinstance(spec, _Static):
        return spec.ref and spec.value == oid
    if spec is None:
        return False
    return any(_mentions(v, oid) for v in (
        (x for _, x in spec[1]) if spec[0] is dict else spec[1]))


def captured(fn: Optional[Callable] = None, *, weights: Optional[Callable] = None,
             context: Optional[Callable] = None,
             donated: Optional[Callable] = None, pool: Optional[Pool] = None):
    """``Captured(fn, weights, context, donated, pool)``; usable as a
    decorator with or without keyword arguments."""
    if fn is None:
        return lambda f: Captured(f, weights, context, donated, pool)
    return Captured(fn, weights, context, donated, pool)
