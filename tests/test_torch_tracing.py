"""The port's tracer (``utils/profiling.py``) on the CPU.

Host spans: the shared no-op when tracing is off, one request id and the
parents of the spans of one ``tryon_step``, ``Captured``'s phases through the
``_Rerun`` stand-in of ``test_torch_graphs.py``, the switch in the graph
signature, the bounded ring, the names a ``torch.profiler`` session sees,
and the CLI's summary. Device spans through a stand-in event source (the CPU
standing in for the card): recorded into a graph, pending after a replay,
harvested before the next one, flushed by ``flush()``. Device spans on the
card are checked in ``tests/test_torch_cuda.py``.
"""

import collections
import threading

import numpy as np
import pytest
import torch

from hrviton_tpu_torch import PipelineConfig, SPADEGenConfig, TOCGConfig
from hrviton_tpu_torch import TryOnPipeline
from hrviton_tpu_torch.cli import test_generator as tg
from hrviton_tpu_torch.core import graphs
from hrviton_tpu_torch.ops import _build
from hrviton_tpu_torch.utils import profiling
from test_torch_graphs import _Rerun, _Static

FH, FW = 128, 128
PHASES = ("graphs.signature", "graphs.weights", "graphs.capture",
          "graphs.copy_in", "graphs.launch", "graphs.clone_out")


@pytest.fixture(autouse=True)
def _tracer_off_and_empty():
    was = profiling.enabled()
    profiling.disable()
    profiling.clear()
    yield
    profiling.clear()
    (profiling.enable if was else profiling.disable)()


def _pipeline():
    return TryOnPipeline(
        PipelineConfig(fine_height=FH, fine_width=FW, cond_height=64,
                       cond_width=64),
        TOCGConfig(ngf=8), SPADEGenConfig(ngf=8, fine_height=FH, fine_width=FW),
        device="cpu")


def _raw(n=1, seed=0, size=FH):
    """A compact loader batch (uint8 and label indices) of ``n`` at
    ``size`` x ``size``."""
    rng = np.random.default_rng(seed)
    u8 = lambda c: rng.integers(0, 256, (n, size, size, c), dtype=np.uint8)
    mask = lambda: rng.integers(0, 2, (n, size, size, 1), dtype=np.uint8)
    idx = lambda: rng.integers(0, 13, (n, size, size), dtype=np.uint8)
    return {"cloth": {"paired": u8(3), "unpaired": u8(3)},
            "cloth_mask": {"paired": mask(), "unpaired": mask()},
            "parse_idx": idx(), "parse_agnostic_idx": idx(), "image": u8(3),
            "densepose": u8(3), "pose": u8(3), "agnostic": u8(3)}


def _by_name(records):
    out = collections.defaultdict(list)
    for s in records:
        out[s.name].append(s)
    return out


def test_off_span_is_the_shared_noop_and_records_nothing():
    """Off: ``span`` and ``device_span`` return one shared no-op, and a
    whole try-on step leaves the ring empty."""
    assert not profiling.enabled()
    assert profiling.span("a") is profiling.span("b", "owner")
    assert profiling.device_span("a", "cpu") is profiling.span("a")
    pipe = _pipeline()
    tg.tryon_step(pipe, _raw())
    profiling.flush()
    assert profiling.spans() == []
    assert profiling.counters() == {"dropped": 0, "waits": 0}


def test_switch_joins_the_signature_and_off_leaves_it_unchanged():
    cap = graphs.Captured(lambda x: x * 2)
    x = torch.ones(3)
    off = cap._signature((x,), {})[0]
    profiling.enable()
    on = cap._signature((x,), {})[0]
    profiling.disable()
    assert on != off
    assert cap._signature((x,), {})[0] == off


def test_spans_of_one_tryon_step_share_a_request_and_name_parents():
    """``tryon_step`` is the root: the upload, the graphs' signatures and
    the three device spans (timed by the host clock on the CPU) carry its
    request and name it as their parent; the three device spans are
    contiguous; the next step takes a new request; building the pipeline is
    ``pipeline.init``."""
    profiling.enable()
    pipe = _pipeline()
    tg.tryon_step(pipe, _raw())
    tg.tryon_step(pipe, _raw(seed=1))
    profiling.flush()
    got = _by_name(profiling.spans())
    (init,) = got["pipeline.init"]
    assert init.parent is None
    roots = got["tryon_step"]
    assert len(roots) == 2 and all(r.parent is None for r in roots)
    assert len({r.request for r in roots} | {init.request}) == 3
    for root in roots:
        mine = [s for s in profiling.spans() if s.request == root.request]
        names = [s.name for s in mine]
        assert names.count("to_device") == 1
        assert names.count("graphs.signature") == 2      # both entry points
        assert {s.owner for s in mine if s.name == "graphs.signature"} == {
            "prepare_batch", "_pipeline_forward"}
        assert all(s.parent == root.id for s in mine if s is not root)
        assert all(root.t0_ns <= s.t0_ns <= s.t1_ns <= root.t1_ns for s in mine)
        tocg, lift, gen = (next(s for s in mine if s.name == n) for n in (
            "tryon.tocg", "tryon.lift", "tryon.generator"))
        assert tocg.t1_ns <= lift.t0_ns and lift.t1_ns <= gen.t0_ns
        assert not any(s.device for s in mine)            # host clock here


def test_captured_call_emits_its_phases():
    """A recording call: signature, weights, capture, copy in, launch, clone
    out, and the weights after it; a replay: the same without the capture
    and the second weights. Each owned by the entry point's name, inside
    the open span's request."""
    w = torch.ones(3)

    def body(x):
        return x * w
    cap = _Rerun(body, weights=lambda *a: [w])
    profiling.enable()
    with profiling.span("request"):
        cap(torch.ones(3))
    with profiling.span("request"):
        cap(torch.ones(3))
    records = profiling.spans()
    roots = [s for s in records if s.name == "request"]
    first, second = ([s.name for s in records
                      if s.request == r.request and s is not r] for r in roots)
    assert sorted(first) == sorted(PHASES + ("graphs.weights",))
    assert sorted(second) == sorted(set(PHASES) - {"graphs.capture"})
    assert {s.owner for s in records if s.name in PHASES} == {"body"}
    launch = [s for s in records if s.name == "graphs.launch"]
    assert all(s.parent in {r.id for r in roots} for s in launch)


def test_enabling_records_the_entry_anew_exactly_once():
    cap = _Rerun(lambda x: x + 1)
    cap(torch.ones(2))
    assert cap.captures == 1
    profiling.enable()
    cap(torch.ones(2))
    cap(torch.ones(2))
    assert cap.captures == 2
    profiling.disable()
    cap(torch.ones(2))
    profiling.enable()
    cap(torch.ones(2))
    assert cap.captures == 2 and len(cap.entries) == 2


class _Clock:
    ns = 0


class _Event:
    """A stand-in timing event on a clock that each record moves by 1 us."""

    done = True

    def record(self):
        _Clock.ns += 1000
        self.t = _Clock.ns

    def query(self):
        return _Event.done

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) / 1e6


class _CpuEvents:
    device_type = "cpu"

    @staticmethod
    def event():
        return _Event()


class _Marked(_Rerun):
    """``_Rerun`` whose graph replays like the card's: it runs the body on
    its static inputs with tracing off (a replay runs no Python) and records
    the marks' events again, as a replay runs a graph's event nodes."""

    def _record(self, s_args, s_kwargs, dev, gens):
        pairs = profiling._COLLECT
        graph, out, held = super()._record(s_args, s_kwargs, dev, gens)
        return _Replays(graph, pairs), out, held


class _Replays:
    def __init__(self, graph: _Static, pairs):
        self.graph, self.pairs = graph, pairs

    def replay(self):
        profiling.disable()
        try:
            self.graph.replay()
        finally:
            profiling.enable()
        for _, a, b in self.pairs:
            a.record()
            _Clock.ns += 5000
            b.record()


def _two_spans(x):
    with profiling.device_span("a", x.device):
        y = x * 2
    with profiling.device_span("b", x.device):
        return y + 1


def test_device_spans_pending_harvested_and_flushed(monkeypatch):
    """Recorded into the graph as event pairs; a replay leaves them pending
    with its request; the next launch harvests them first (and counts a
    wait when the replay had not ended); ``flush()`` harvests the rest, the
    warm-up's eager spans among them."""
    monkeypatch.setattr(profiling, "EVENTS", _CpuEvents())
    profiling.enable()
    cap = _Marked(_two_spans)
    with profiling.span("request"):
        cap(torch.ones(2))
    entry = cap.last_entry
    assert [n for n, _, _ in entry.marks.pairs] == ["a", "b"]
    assert entry.marks.pending is not None
    capture = next(s for s in profiling.spans() if s.name == "graphs.capture")
    device = [s for s in profiling.spans() if s.device]
    # only the warm-up's eager spans: the replay's are pending
    assert {s.parent for s in device} <= {capture.id}
    _Event.done = False
    try:
        with profiling.span("request"):
            cap(torch.ones(2))
    finally:
        _Event.done = True
    replayed = lambda: [s for s in profiling.spans()
                        if s.device and s.parent != capture.id]
    first = replayed()
    assert [s.name for s in first] == ["a", "b"]
    assert profiling.counters()["waits"] == 1
    assert all(s.t1_ns - s.t0_ns == 6000 for s in first)
    roots = [s for s in profiling.spans() if s.name == "request"]
    launches = {s.request: s.id for s in profiling.spans()
                if s.name == "graphs.launch"}
    assert {s.request for s in first} == {roots[0].request}
    assert all(s.parent == launches[s.request] for s in first)
    assert entry.marks.pending is not None
    profiling.flush()
    assert entry.marks.pending is None
    assert [(s.name, s.request) for s in replayed()] == [
        ("a", roots[0].request), ("b", roots[0].request),
        ("a", roots[1].request), ("b", roots[1].request)]
    warm = [s.name for s in profiling.spans() if s.device and s.parent == capture.id]
    assert warm == ["a", "b"]
    profiling.flush()
    assert len([s for s in profiling.spans() if s.device]) == 6


def test_ring_keeps_the_newest_and_counts_the_dropped(monkeypatch):
    monkeypatch.setattr(profiling, "_RING", collections.deque(maxlen=4))
    profiling.enable()
    for i in range(7):
        with profiling.span(f"s{i}"):
            pass
    assert [s.name for s in profiling.spans()] == ["s3", "s4", "s5", "s6"]
    assert profiling.counters()["dropped"] == 3
    profiling.clear()
    assert profiling.spans() == [] and profiling.counters()["dropped"] == 0


def test_threads_keep_their_own_requests_and_the_count(monkeypatch):
    """Each thread's root takes its own request; spans from eight threads
    into a ring of 64 are all counted, kept or dropped."""
    monkeypatch.setattr(profiling, "_RING", collections.deque(maxlen=64))
    profiling.enable()
    n, per = 8, 200

    def work():
        for _ in range(per):
            with profiling.span("root"):
                with profiling.span("child"):
                    pass
    threads = [threading.Thread(target=work) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    kept = profiling.spans()
    assert len(kept) + profiling.counters()["dropped"] == 2 * n * per
    roots = {s.id: s for s in kept if s.name == "root"}
    for s in kept:
        if s.name == "child" and s.parent in roots:
            assert s.request == roots[s.parent].request


def test_profiler_sees_the_spans_only_while_it_runs():
    profiling.enable()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("graphs.launch", "entry"):
            torch.ones(2).sum()
        with profiling.span("to_device"):
            pass
    names = {e.key for e in prof.key_averages()}
    assert {"graphs.launch[entry]", "to_device[]"} <= names
    assert len(profiling.spans()) == 2


def test_first_load_of_a_library_is_a_span(monkeypatch):
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "build", lambda name: f"/nonexistent/{name}.so")
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    profiling.enable()
    _build.load("spade_block", lambda lib: None)
    _build.load("spade_block", lambda lib: None)
    loads = [s for s in profiling.spans() if s.name == "ops.load"]
    assert [s.owner for s in loads] == ["spade_block"]


def test_cli_summary_is_a_batch_mean_of_each_span():
    profiling.enable()
    pipe = _pipeline()
    since = profiling.spans()[-1].t1_ns
    for seed in range(2):
        tg.tryon_step(pipe, _raw(seed=seed))
    lines = tg.trace_summary(since, 2)
    by = {line.split(":")[0]: line for line in lines}
    assert set(by) >= {"trace tryon_step", "trace to_device",
                       "trace tryon.generator"}
    assert "trace pipeline.init" not in by
    assert lines[-1] == "trace counters: 0 dropped, 0 harvests waited for a replay"
    roots = [s for s in profiling.spans() if s.name == "tryon_step"]
    want = sum(s.t1_ns - s.t0_ns for s in roots) / 1e6 / 2
    assert by["trace tryon_step"] == f"trace tryon_step: {want:.3f} ms a batch (2 spans)"


# -- the stage-2 training step --------------------------------------------------

STEP = ("train.condition", "train.g_forward", "train.g_backward",
        "train.g_update", "train.regenerate", "train.d_step", "train.d_update")


def _training(device="cpu", size=FH, ngf="8", extra=()):
    """The stage-2 CLI's training at a small size ('more', SPADE ngf 8, D
    ndf 8, batch 1), as ``build_training`` builds it."""
    from hrviton_tpu_torch.cli import train_generator as t2
    from hrviton_tpu_torch.cli.common import start_mesh
    opt = t2.get_opt(["--name", "t", "--device", device, "-b", "1",
                      "--fine_height", str(size), "--fine_width", str(size),
                      "--cond_height", "64", "--cond_width", "64", "--ngf", ngf,
                      "--num_upsampling_layers", "more", "--ndf", "8", *extra])
    return t2, t2.build_training(opt, start_mesh(opt))


def _taps_of_more(blocks=7):
    """3x3 weight gradients of one G backward of 'more', by hand: the head
    (two norms of three convs, conv_0, conv_1), six blocks with a learned
    shortcut (three norms), a feature conv a block, conv_img."""
    return 8 + 11 * (blocks - 1) + blocks + 1


def _ancestors(span, by_id):
    while span.parent is not None:
        span = by_id[span.parent]
        yield span


def test_training_spans_nest_under_train_step():
    """``build_training`` is the set-up span ``trainer.init`` (a root of its
    own, before the first step); each ``train_step`` is a root whose upload,
    graph signatures and the step's seven spans (timed by the host clock on
    the CPU, one after another) carry its request and descend from it; the
    tap-product weight gradients nest in ``train.g_backward``."""
    profiling.enable()
    t2, built = _training()
    for seed in (0, 1):
        built = built._replace(state=t2.train_step(
            built.trainer, built.state, _raw(seed=seed), built.noise,
            built.frozen, built.put).state)
    profiling.flush()
    records = profiling.spans()
    by_id = {s.id: s for s in records}
    got = _by_name(records)
    (init,) = got["trainer.init"]
    roots = got["train_step"]
    assert init.parent is None and len(roots) == 2
    assert init.t1_ns <= roots[0].t0_ns
    assert len({r.request for r in roots} | {init.request}) == 3
    for root in roots:
        mine = [s for s in records if s.request == root.request and s is not root]
        assert all(root in _ancestors(s, by_id) for s in mine)
        assert all(root.t0_ns <= s.t0_ns <= s.t1_ns <= root.t1_ns for s in mine)
        names = [s.name for s in mine]
        assert names.count("to_device") == 1
        assert {s.owner for s in mine if s.name == "graphs.signature"} == {
            "expand", "_train_step"}
        step = [next(s for s in mine if s.name == n) for n in STEP]
        assert all(a.t1_ns <= b.t0_ns for a, b in zip(step, step[1:]))
        backward = step[2]
        taps = [s for s in mine if s.name == "train.wgrad_taps"]
        assert len(taps) == _taps_of_more()
        assert all(s.parent == backward.id for s in taps)
        assert not any(s.device for s in mine)


def test_tracing_off_records_no_events_into_the_training_step(monkeypatch):
    """The recorded body of the step, as a recording runs it: with tracing
    off no event pair is kept for the graph; with it on the seven spans in
    order (a pair is kept as its span closes: the try-on condition stage's
    two inside the first come before it) and one pair a tap-product weight
    gradient."""
    from hrviton_tpu_torch.train import generator_trainer as gt
    monkeypatch.setattr(profiling, "EVENTS", _CpuEvents())
    t2, built = _training()
    trainer, state = built.trainer, built.state
    batch = built.put(_raw())
    gen = state.g.module

    def recorded():
        fields = [trainer.noise_fields(gen, built.noise, 1) for _ in range(2)]
        for opt in (state.g.opt, state.d.opt):
            opt.prepare()
        with profiling.collect(profiling.Marks("_train_step")) as marks:
            gt._train_step(trainer, state.g, state.d, batch, *fields,
                           built.frozen)
        return [name for name, _, _ in marks.pairs]
    assert recorded() == []
    profiling.enable()
    names = recorded()
    assert [n for n in names if n in STEP] == list(STEP)
    assert names[:3] == ["tryon.tocg", "tryon.lift", "train.condition"]
    assert names.count("train.wgrad_taps") == _taps_of_more()


def test_wgrad_taps_counter_is_the_models_count():
    """``wgrad_taps.launches`` moves by the model's count of 3x3 convs with
    weight gradients each step (the benchmark driver's count from the
    modules, and by hand), and replays add to it (a registered counter)."""
    from benchmark.drivers.train_closed_loop import taps_per_step
    from hrviton_tpu_torch.ops.conv3x3 import wgrad_taps
    assert any(c is wgrad_taps for c in graphs._COUNTERS)
    t2, built = _training()
    gen = built.state.g.module
    assert taps_per_step(gen) == _taps_of_more(len(gen.block_names))
    before = wgrad_taps.launches
    t2.train_step(built.trainer, built.state, _raw(), built.noise,
                  built.frozen, built.put)
    assert wgrad_taps.launches - before == taps_per_step(gen)


def test_taps_backward_counters_are_registered(monkeypatch):
    """``conv3x3_taps.backwards`` and ``conv3x3_taps.layout_copies`` are
    counters that replays add to; in a step of the CLI's f32 training the
    first moves by G's 3x3 convs with weight gradients and VGG19's 13 on
    G's output, the second by two for each call that takes an input
    gradient (x and g arrive channels_last; the f32 dgrad copies g to
    NCHW and its result back)."""
    from benchmark.drivers.train_closed_loop import taps_per_step
    from hrviton_tpu_torch.ops.conv3x3 import conv3x3_taps
    from test_torch_wgrad3x3 import spy_taps_backward
    counters = (conv3x3_taps.backwards, conv3x3_taps.layout_copies)
    assert all(any(c is k for k in graphs._COUNTERS) for c in counters)
    t2, built = _training()
    seen = spy_taps_backward(monkeypatch)
    before = [c.launches for c in counters]
    t2.train_step(built.trainer, built.state, _raw(), built.noise,
                  built.frozen, built.put)
    dgrads = [s for s in seen if s[0]]
    assert dgrads and all(x_cl and g_cl for _, x_cl, g_cl in dgrads)
    assert [c.launches - b for c, b in zip(counters, before)] == [
        taps_per_step(built.state.g.module) + 13, 2 * len(dgrads)]
    assert len(seen) == taps_per_step(built.state.g.module) + 13


class _TimedGraph:
    """A recorded graph whose replays are timed by CUDA events around them."""

    def __init__(self, graph):
        self.graph, self.ms = graph, []

    def replay(self):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        self.graph.replay()
        b.record()
        self.ms.append((a, b))


@pytest.mark.gpu
def test_training_device_spans_cover_the_recorded_step():
    """On the card: the step's seven device spans, harvested from replays of
    its graph, are contiguous (each starts where the last ended, within a
    few microseconds) and sum to within 2% of the replay's CUDA-event time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from hrviton_tpu_torch.train import generator_trainer as gt
    profiling.enable()
    t2, built = _training("cuda", 256, "16", ("--bf16",))
    step = lambda seed: t2.train_step(built.trainer, built.state,
                                      _raw(seed=seed, size=256), built.noise,
                                      built.frozen, built.put)
    step(0)                                  # records the step's graph
    entry = gt._step.last_entry
    timed = entry.graph = _TimedGraph(entry.graph)
    for seed in (1, 2, 3):
        step(seed)
    profiling.flush()
    torch.cuda.synchronize()
    records = profiling.spans()
    roots = [s for s in records if s.name == "train_step"][1:]
    assert len(roots) == len(timed.ms) == 3
    for root, (a, b) in zip(roots, timed.ms):
        mine = [s for s in records if s.request == root.request and s.device]
        spans = [next(s for s in mine if s.name == n) for n in STEP]
        assert [n for n, _, _ in entry.marks.pairs if n in STEP] == list(STEP)
        total = sum(s.t1_ns - s.t0_ns for s in spans) / 1e6
        assert total == pytest.approx(a.elapsed_time(b), rel=0.02)
    # contiguity on the last replay's own events: the gaps between spans
    pairs = [p for p in entry.marks.pairs if p[0] in STEP]
    gaps = [pairs[k][2].elapsed_time(pairs[k + 1][1]) for k in range(len(pairs) - 1)]
    assert all(-1e-3 <= g <= 0.02 for g in gaps), gaps
