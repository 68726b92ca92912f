"""The program's spans read from the window (``benchmark/spans.py``): the
selection over a synthetic ring, each case where nothing is read, the
tracer switched on by a traced run before its set-up and left off by an
untraced one (the tiny cell of ``tiny.py``, on the CPU), and the harness's
profiler ranges left as they were."""

import json
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import benchmark
from benchmark import run as bench_run
from benchmark import spans
from benchmark.drivers import tryon_closed_loop as driver
from benchmark.tests.tiny import tiny_root
from hrviton_tpu_torch.data.device import to_device
from hrviton_tpu_torch.utils import profiling
from hrviton_tpu_torch.utils.profiling import Span

S = 10 ** 9
CTX = SimpleNamespace(t0=1.0)
REC = {"setup_s": 1.0, "window_s": 2.0}      # the window is [2 s, 4 s)


@pytest.fixture(autouse=True)
def _tracer_restored():
    was = profiling.enabled()
    profiling.clear()
    yield
    profiling.clear()
    (profiling.enable if was else profiling.disable)()


def _ring(*, drop_device=False, capture_inside=False):
    """Four requests at 1.5, 2.5, 3.5 and 4.5 s (the window holds the
    second and the third), each with its upload, a graph check and a device
    span, and the set-up's spans before them."""
    out, ids = [], iter(range(1, 10 ** 6))

    def add(name, request, parent, t0, dur, owner=None, device=False):
        out.append(Span(next(ids), name, owner, request, parent, t0,
                        t0 + dur, device))
        return out[-1].id
    add("pipeline.init", 1, None, int(0.1 * S), int(0.3 * S))
    cap = add("graphs.capture", 2, None, int(0.5 * S), int(0.4 * S), "fwd")
    add("ops.load", 2, cap, int(0.6 * S), int(0.1 * S), "spade_block")
    for k, t in enumerate((1.5, 2.5, 3.5, 4.5)):
        r = 10 + k
        t0 = int(t * S)
        root = add("tryon_step", r, None, t0, 50_000_000)
        add("to_device", r, root, t0 + 1000, 2_000_000 * (k + 1))
        add("graphs.signature", r, root, t0 + 2000, 100_000, "fwd")
        add("graphs.weights", r, root, t0 + 3000, 300_000, "fwd")
        if not (drop_device and k == 2):
            add("tryon.tocg", r, root, t0 + 4000, 7_000_000 * (k + 1),
                "fwd", device=True)
    if capture_inside:
        add("graphs.capture", 12, None, int(3.6 * S), 1000, "fwd")
    return out


def _with(monkeypatch, records, dropped=0):
    monkeypatch.setattr(profiling, "spans", lambda: list(records))
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"dropped": dropped, "waits": 0})


def test_window_selection(monkeypatch):
    _with(monkeypatch, _ring())
    # requests 2 and 3 of the window: uploads of 4 and 6 ms
    assert spans.per_request_ms(CTX, REC, ("to_device",)) == 5.0
    assert spans.per_request_ms(CTX, REC, ("graphs.signature",
                                           "graphs.weights")) == 0.4
    assert spans.per_request_ms(CTX, REC, ("tryon.tocg",), device=True) == 17.5
    # a device metric reads only what the device timed
    assert spans.per_request_ms(CTX, REC, ("tryon.tocg",)) == 0.0
    assert spans.set_up_s(CTX, REC, "pipeline.init") == pytest.approx(0.3)
    assert spans.set_up_s(CTX, REC, "graphs.capture",
                          less="ops.load") == pytest.approx(0.3)
    assert spans.set_up_s(CTX, REC, "graphs.capture") == pytest.approx(0.4)


@pytest.mark.parametrize("case", ["dropped", "capture_inside", "few_device",
                                  "no_request", "no_set_up_span"])
def test_nothing_is_read(monkeypatch, case):
    _with(monkeypatch, _ring(drop_device=case == "few_device",
                             capture_inside=case == "capture_inside"),
          dropped=int(case == "dropped"))
    if case == "no_request":
        late = {"setup_s": 10.0, "window_s": 2.0}
        assert spans.per_request_ms(CTX, late, ("to_device",)) is None
    elif case == "no_set_up_span":
        assert spans.set_up_s(CTX, REC, "graphs.recording") is None
    elif case == "few_device":
        assert spans.per_request_ms(CTX, REC, ("tryon.tocg",), device=True) is None
        assert spans.per_request_ms(CTX, REC, ("to_device",)) == 5.0
    else:
        assert spans.per_request_ms(CTX, REC, ("to_device",)) is None
        if case == "dropped":
            assert spans.set_up_s(CTX, REC, "pipeline.init") is None


def _fresh_spans_module(monkeypatch):
    """The helper imported anew by the next traced run (a run's process
    imports it once)."""
    monkeypatch.delitem(sys.modules, "benchmark.spans", raising=False)
    monkeypatch.delattr(benchmark, "spans", raising=False)


def test_traced_run_traces_from_set_up_and_untraced_run_does_not(
        tmp_path, monkeypatch):
    root, bench = tiny_root(tmp_path, "float32", batch=1)
    profiling.disable()
    rec, out = bench_run.execute(bench, "tiny", 2 ** 33 + 5, 1.0, False, "cpu",
                                 root=root, log=lambda m: None)
    assert not profiling.enabled() and profiling.spans() == []
    assert out["correct"]

    _fresh_spans_module(monkeypatch)
    rec, out = bench_run.execute(bench, "tiny", 2 ** 33 + 6, 1.0, True, "cpu",
                                 root=root, log=lambda m: None)
    assert profiling.enabled()
    t_start = int((bench_run.T0 + rec["setup_s"]) * 1e9)
    records = profiling.spans()
    before = [s for s in records if s.t0_ns < t_start]
    # on before the pipeline was built and before the warm-up's requests
    assert [s.name for s in before if s.name == "pipeline.init"] == [
        "pipeline.init"]
    assert sum(s.name == "tryon_step" for s in before) == 2
    got = out["metrics"]
    for name in ("upload_host_ms", "graph_check_ms", "graph_replay_ms",
                 "init_s"):
        assert got[name]["value"] >= 0, name
    assert got["upload_host_ms"]["value"] > 0 and got["init_s"]["value"] > 0
    # no device events and no recording on the CPU
    assert not {"tocg_ms", "lift_ms", "generator_ms", "capture_s"} & set(got)
    assert out["correct"]


def test_program_spans_leave_the_harness_ranges_alone(tmp_path):
    """Under the profiler the program's spans are ranges of their own
    (``to_device[]``), so ``reduce_trace`` counts the harness's
    ``to_device`` ranges alone as requests."""
    profiling.enable()
    batch = {"image": np.zeros((1, 4, 4, 3), np.uint8)}
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with torch.profiler.record_function("to_device"):
                to_device(batch, "cpu")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert names.count("to_device") == 2 and names.count("to_device[]") == 2
    assert driver.reduce_trace(events)["requests"] == 2
