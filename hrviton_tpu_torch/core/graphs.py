"""Capture cache: the port's counterpart of ``jax.jit`` for its inference
entry points.

The JAX package runs each inference entry point as one compiled program per
input signature (``pipelines/tryon.py``, the CLIs' ``run_impl``s,
evaluate's LPIPS and Inception). ``captured(fn)`` gives a function the same
on the card: the first call with a new signature records ``fn`` once as a
``torch.cuda.CUDAGraph`` and every later call with that signature replays
it. On the CPU, and inside ``disabled()`` (the counterpart of
``jax.disable_jit``), it is the plain call.

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
  cache, lets cuDNN choose its algorithms, sets the kernels' attributes);
  then the call is recorded. Everything the graph reads that it did not
  allocate is held with it (``hold``). A capture that fails raises: there is
  no eager substitute on the card.
- **Replay**: the arguments are copied into the static buffers, the graph
  runs, and the outputs are cloned out (a jitted function's results are
  fresh arrays, a replay overwrites its static outputs). The kernels'
  Python-side launch counters (``register_counters``) count in a replay what
  the call launched when it was recorded, so a request counts the same
  eager and replayed; the warm-up and the recording count once, as the
  first call.
- **Memory**: the graphs of one ``Captured`` share one private pool (a
  failed capture leaves it to its graphs; the next capture takes a new one).
"""

from __future__ import annotations

import contextlib
import time
import weakref
from typing import Any, Callable, Dict, Iterable, List, NamedTuple, Optional

import numpy as np
import torch

__all__ = ["captured", "Captured", "disabled", "enabled", "register_counters",
           "register_state", "hold", "module_tensors", "constant"]

_OFF = 0                 # depth of disabled() blocks
_COUNTERS: List[Any] = []          # wrappers with a ``launches`` count
_STATES: List[Callable[[], Any]] = []   # readers of module-level switches
_HOLD: Optional[list] = None       # what the graph being recorded reads
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


def register_counters(*wrappers) -> None:
    """Kernel wrappers whose ``launches`` count a replay adds to."""
    for w in wrappers:
        if not any(w is c for c in _COUNTERS):
            _COUNTERS.append(w)


def register_state(reader: Callable[[], Any]) -> None:
    """A module-level switch a traced function would read: ``reader()``
    (hashable) joins every signature."""
    _STATES.append(reader)


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
                 held, weights_sig, seconds):
        self.graph, self.inputs = graph, inputs
        self.out_spec, self.outputs = out_spec, outputs
        self.out_objects = out_objects
        self.counts, self.held, self.weights_sig = counts, held, weights_sig
        self.seconds = seconds          # warm-up and recording
        self.replays = 0


def _counts() -> List[int]:
    return [c.launches for c in _COUNTERS]


def _set_counts(values: List[int]) -> None:
    for c, v in zip(_COUNTERS, values):
        c.launches = v


class Captured:
    """``fn`` recorded once per signature and replayed on a CUDA device
    (module docstring); the plain call on the CPU and under ``disabled()``.
    ``weights(*args, **kwargs)``: the tensors ``fn`` reads besides its
    arguments; ``context(*args, **kwargs)``: hashable state of identity
    arguments that changes what ``fn`` does."""

    device_type = "cuda"    # the device whose calls are recorded

    def __init__(self, fn: Callable, weights: Optional[Callable] = None,
                 context: Optional[Callable] = None):
        self.fn, self.weights, self.context = fn, weights, context
        self.entries: Dict[Any, _Entry] = {}
        self.captures = 0
        self.last_entry: Optional[_Entry] = None   # the entry of the last replay
        self.pool = None                # the graphs' private memory pool
        self._stream = None
        self._watched: Dict[int, Any] = {}
        self.__name__ = getattr(fn, "__name__", "captured")
        self.__doc__ = getattr(fn, "__doc__", None)

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
        if not enabled():
            return self.fn(*args, **kwargs)
        key, leaves, objects, dev = self._signature(args, kwargs)
        if dev is None or dev.type != self.device_type:
            return self.fn(*args, **kwargs)
        wsig = (None if self.weights is None
                else _weights_signature(self.weights(*args, **kwargs)))
        entry = self.entries.get(key)
        if entry is None or entry.weights_sig != wsig:
            self.entries.pop(key, None)
            self._watch(objects)
            entry = self.entries[key] = self._capture(
                key[0], leaves, objects, dev, wsig)
        self.last_entry = entry
        return self._replay(entry, leaves)

    def _capture(self, spec, leaves, objects, dev, wsig) -> _Entry:
        global _HOLD
        t0 = time.perf_counter()
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(dev)
        inputs = [torch.empty_like(t) for t in leaves]
        for s, t in zip(inputs, leaves):
            s.copy_(t)
        s_args, s_kwargs = _unflatten(spec, iter(inputs),
                                      {id(o): o for o in objects})
        before = _counts()
        held: list = []
        # the cudaGraph_t is kept after capture, so that the graph can be
        # dumped (debug_dump) and its nodes counted
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        stream = self._stream
        try:
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                self.fn(*s_args, **s_kwargs)              # warm-up
            stream.synchronize()
            warm = _counts()
            _HOLD = held
            # the outer stream block restores the caller's stream even when
            # a failed capture leaves torch.cuda.graph's own block open
            try:
                with torch.cuda.stream(stream), torch.cuda.graph(
                        graph, pool=self.pool, stream=stream,
                        capture_error_mode="thread_local"):
                    out = self.fn(*s_args, **s_kwargs)
            except BaseException:
                self._abandon_pool(dev)
                raise
            finally:
                _HOLD = None
            graph.instantiate()
            recorded = [a - b for a, b in zip(_counts(), warm)]
        finally:
            _set_counts(before)
        torch.cuda.current_stream(dev).wait_stream(stream)
        outputs: list = []
        out_objects: list = []
        out_spec = _flatten(out, outputs, out_objects)
        self.captures += 1
        return _Entry(graph, inputs, out_spec, outputs,
                      {id(o): o for o in out_objects}, recorded, held, wsig,
                      time.perf_counter() - t0)

    def _abandon_pool(self, dev) -> None:
        """After a failed capture: the allocator stops routing to the pool
        (torch's capture_end raises before it would), and later captures
        take a new pool."""
        try:
            torch._C._cuda_endAllocateToPool(dev.index, self.pool)
        except RuntimeError:
            pass
        self.pool = None

    def _replay(self, entry: _Entry, leaves):
        for s, t in zip(entry.inputs, leaves):
            s.copy_(t)
        entry.graph.replay()
        entry.replays += 1
        for c, n in zip(_COUNTERS, entry.counts):
            c.launches += n
        clones: Dict[int, torch.Tensor] = {}     # an output returned twice
        for t in entry.outputs:                  # is cloned once
            if id(t) not in clones:
                clones[id(t)] = t.clone()
        return _unflatten(entry.out_spec, (clones[id(t)] for t in entry.outputs),
                          entry.out_objects)


def _mentions(spec, oid: int) -> bool:
    if isinstance(spec, _Static):
        return spec.ref and spec.value == oid
    if spec is None:
        return False
    return any(_mentions(v, oid) for v in (
        (x for _, x in spec[1]) if spec[0] is dict else spec[1]))


def captured(fn: Optional[Callable] = None, *, weights: Optional[Callable] = None,
             context: Optional[Callable] = None):
    """``Captured(fn, weights, context)``; usable as a decorator with or
    without keyword arguments."""
    if fn is None:
        return lambda f: Captured(f, weights, context)
    return Captured(fn, weights, context)
