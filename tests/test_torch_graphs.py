"""The capture cache (``core/graphs.py``), on the CPU.

A CUDA graph is recorded and replayed on the card only (``tests/
test_torch_cuda.py`` and ``chip_smoke.py`` phase 11). Here the cache's
logic runs with the CPU standing in for the card: ``_Rerun`` is a
``Captured`` whose "recording" is one call (its writes to the donated state
undone) and whose "replay" calls the function again on the static input
buffers and writes its static outputs in place, as a replay overwrites a
graph's outputs. The signature (shapes,
dtypes, static arguments, switches, TF32 flags; new values make no new
entry), the recapture after weights are written, the launch counters, the
outputs cloned out, ``disabled()``, the constants copied to a device once,
and the pipeline's fixed SPADE noise are checked. No JAX: the JAX parity
tests of the pipeline, the CLI and the rejection steps run through the same
entry points in their own files.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from hrviton_tpu_torch import PipelineConfig, SPADEGenConfig, TOCGConfig
from hrviton_tpu_torch import TryOnPipeline
from hrviton_tpu_torch.core import graphs
from hrviton_tpu_torch.ops import blur, parse
from hrviton_tpu_torch.ops import conv3x3 as c3
from hrviton_tpu_torch.ops import spade_block as sb
from hrviton_tpu_torch.pipelines import tryon

FH, FW = 128, 128       # 'most' needs fine sizes divisible by 128


class _Static:
    """A graph stand-in: replay() calls the function on the static inputs,
    its launch counts left as they were and the captured functions it calls
    plain (a replay runs no Python), and copies the results into the static
    outputs. Identity arguments are held weakly, as a recorded graph does
    not hold them."""

    def __init__(self, fn, spec, inputs, objects, outputs):
        self.fn, self.spec, self.inputs, self.outputs = fn, spec, inputs, outputs
        self.refs = {id(o): weakref.ref(o) for o in objects}

    def replay(self):
        args, kwargs = graphs._unflatten(
            self.spec, iter(self.inputs), {k: r() for k, r in self.refs.items()})
        before = graphs._counts()
        leaves = []
        graphs._TRACING += 1
        try:
            graphs._flatten(self.fn(*args, **kwargs), leaves, [])
        finally:
            graphs._TRACING -= 1
        graphs._set_counts(before)
        for o, t in zip(self.outputs, leaves):
            o.copy_(t)


class _Rerun(graphs.Captured):
    """A Captured that records CPU calls (module docstring): ``_capture`` is
    the card's (static inputs, the donated state's snapshot, warm-up,
    restore, recording, counters); the warm-up is a plain call and the
    "recording" is one call whose writes to the donated state are undone, as
    a recording writes nothing."""

    device_type = "cpu"

    def _warm_up(self, s_args, s_kwargs, dev):
        self.fn(*s_args, **s_kwargs)

    def _record(self, s_args, s_kwargs, dev, gens):
        state = ([] if self.donated is None
                 else list(self.donated(*s_args, **s_kwargs)))
        tensors = [t for t in state if isinstance(t, torch.Tensor)]
        saved = graphs._snapshot(tensors, gens)
        out = self.fn(*s_args, **s_kwargs)
        graphs._restore(tensors, gens, saved)
        outputs, objects = [], []
        spec = graphs._flatten((s_args, s_kwargs), [], objects)
        graphs._flatten(out, outputs, [])
        inputs = []
        graphs._flatten((s_args, s_kwargs), inputs, [])
        return _Static(self.fn, spec, inputs, objects, outputs), out, []


def _t(*shape, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def test_signature_keys_like_jit():
    """New shape, dtype or static argument: another key; new values: the
    same key; a switch a module registered and the TF32 flags join it."""
    cap = graphs.Captured(lambda x, mode: x)
    key = lambda *a: cap._signature(a, {})[0]
    k = key(_t(2, 3), "a")
    assert key(_t(2, 3, seed=1), "a") == k
    assert key(_t(2, 4), "a") != k
    assert key(_t(2, 3, dtype=torch.bfloat16), "a") != k
    assert key(_t(2, 3), "b") != k
    assert key({"x": _t(2, 3)}, "a") != key([_t(2, 3)], "a")
    saved = c3._VIEWS
    try:
        c3._VIEWS = not saved
        assert key(_t(2, 3), "a") != k
    finally:
        c3._VIEWS = saved
    cudnn = torch.backends.cudnn
    saved = cudnn.allow_tf32
    try:
        cudnn.allow_tf32 = not saved
        assert key(_t(2, 3), "a") != k
    finally:
        cudnn.allow_tf32 = saved
    assert key(_t(2, 3), "a") == k


def test_entries_recapture_and_replay():
    """One entry per signature; a replay copies the arguments in, clones
    the outputs out (call k's outputs survive call k+1), and a written or
    replaced weight records the signature anew."""
    w = torch.nn.Parameter(_t(3))

    def fn(x, scale):
        return {"y": x * w * scale, "same": x}
    cap = _Rerun(fn, weights=lambda *a: [w])
    with torch.no_grad():
        a = cap(_t(2, 3), 2.0)
        assert cap.captures == 1
        b = cap(_t(2, 3, seed=1), 2.0)
        assert cap.captures == 1 and len(cap.entries) == 1
        assert torch.equal(b["y"], _t(2, 3, seed=1) * w * 2.0)
        assert torch.equal(a["y"], _t(2, 3) * w * 2.0)       # not overwritten
        assert a["y"] is not cap.last_entry.outputs[0]
        cap(_t(5, 3), 2.0)                                    # new shape
        cap(_t(2, 3), 3.0)                                    # new static
        assert cap.captures == 3 and len(cap.entries) == 3
        w.mul_(2.0)                                           # written
        c = cap(_t(2, 3), 2.0)
        assert cap.captures == 4 and len(cap.entries) == 3
        assert torch.equal(c["y"], _t(2, 3) * w * 2.0)
    with graphs.disabled():
        cap(_t(7, 3), 2.0)
    assert cap.captures == 4


def test_replay_counts_the_recorded_launches():
    """A replay adds to each registered wrapper's count what the recorded
    call launched; the first call counts once."""
    assert any(w is sb.spade_conv_unit for w in graphs._COUNTERS)

    def fn(x):
        sb.spade_conv_unit.launches += 2
        return x + 1
    cap = _Rerun(fn)
    before = sb.spade_conv_unit.launches
    cap(_t(2))
    assert sb.spade_conv_unit.launches == before + 2
    cap(_t(2))
    cap(_t(2))
    assert sb.spade_conv_unit.launches == before + 6
    with graphs.disabled():
        cap(_t(2))
    assert sb.spade_conv_unit.launches == before + 8


def test_aliased_outputs_stay_aliased_and_identity_arguments_expire():
    """An output returned twice is cloned once; the entries of an argument
    held by identity go when it dies."""
    class Model:
        k = 3.0
    cap = _Rerun(lambda m, x: (lambda y: (y, y))(x * m.k))
    m = Model()
    out = cap(m, _t(4))
    out = cap(m, _t(4))
    assert out[0] is out[1]
    assert len(cap.entries) == 1
    del m
    gc.collect()
    assert not cap.entries


def test_disabled_nests_and_restores():
    assert graphs.enabled()
    with graphs.disabled():
        assert not graphs.enabled()
        with graphs.disabled():
            assert not graphs.enabled()
        assert not graphs.enabled()
    assert graphs.enabled()
    with pytest.raises(ValueError):
        with graphs.disabled():
            raise ValueError
    assert graphs.enabled()


def test_cpu_calls_are_plain_calls():
    """On the CPU a captured function records nothing."""
    cap = graphs.Captured(lambda x: x * 2)
    assert torch.equal(cap(_t(3)), _t(3) * 2)
    assert cap.captures == 0 and not cap.entries


class _Spy:
    """Counts host-to-device copies of constants: torch.from_numpy,
    torch.as_tensor, torch.tensor, and Tensor.to with a device."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("from_numpy", "as_tensor", "tensor"):
            orig = getattr(torch, name)
            monkeypatch.setattr(torch, name, self._wrap(name, orig))
        orig_to = torch.Tensor.to

        def to(t, *a, **k):
            if any(isinstance(v, (str, torch.device)) for v in (*a, *k.values())):
                self.calls.append("to")
            return orig_to(t, *a, **k)
        monkeypatch.setattr(torch.Tensor, "to", to)

    def _wrap(self, name, orig):
        def spy(*a, **k):
            self.calls.append(name)
            return orig(*a, **k)
        return spy


def test_gaussian_blur_copies_its_kernels_once(monkeypatch):
    x = _t(1, 16, 16, 3)
    first = blur.gaussian_blur(x, (15, 15), (3.0, 3.0))
    spy = _Spy(monkeypatch)
    again = blur.gaussian_blur(x, (15, 15), (3.0, 3.0))
    assert spy.calls == []
    assert torch.equal(first, again)
    k = blur.gaussian_kernel1d(15, 3.0)
    assert graphs.constant(k, "cpu") is graphs.constant(k.copy(), torch.device("cpu"))
    assert graphs.constant(k, "cpu", torch.float64).dtype == torch.float64


def test_condition_forward_copies_no_constant_twice(monkeypatch):
    """The blur kernels and the 13 -> 7 lookup table are copied to a device
    once: a second condition_forward makes no host-to-device constant copy."""
    pipe = _pipeline()
    batch = _batch(1)
    with torch.inference_mode():
        first = tryon.condition_forward(pipe.tocg, batch, pipe.cfg)
        spy = _Spy(monkeypatch)
        again = tryon.condition_forward(pipe.tocg, batch, pipe.cfg)
    assert spy.calls == []
    assert torch.equal(first.parse7, again.parse7)
    lut = parse.group_index_of_label13()
    labels = torch.tensor([[0, 3, 12]])
    assert parse.lut_lookup(labels, lut).tolist() == [[0, 2, 6]]


def _pipeline(noise_scale=0.3):
    pipe = TryOnPipeline(
        PipelineConfig(fine_height=FH, fine_width=FW, cond_height=64,
                       cond_width=64),
        TOCGConfig(ngf=8), SPADEGenConfig(ngf=8, fine_height=FH, fine_width=FW),
        device="cpu")
    with torch.no_grad():
        for m in pipe.generator.modules():
            if hasattr(m, "noise_scale"):
                m.noise_scale.fill_(noise_scale)
    return pipe


def _batch(n, seed=0):
    rng = np.random.default_rng(seed)
    a = lambda c: torch.from_numpy(
        rng.standard_normal((n, FH, FW, c)).astype(np.float32))
    return {"cloth": a(3), "cloth_mask": a(1).sigmoid(), "parse_agnostic": a(13),
            "densepose": a(3), "agnostic": a(3)}


def test_pipeline_noise_is_fixed_per_batch_size():
    """Two calls with a non-zero noise_scale give the same rgb, as the JAX
    CLI's one noise key does; it is the noise a generator seeded with
    noise_seed draws inside the forward, and other noise changes it."""
    pipe = _pipeline()
    batch = _batch(2)
    a, _ = pipe(batch)
    b, _ = pipe(batch)
    assert torch.equal(a, b)
    gen = torch.Generator().manual_seed(pipe.noise_seed)
    with torch.inference_mode():
        inside, _ = tryon.tryon_forward(
            pipe.tocg, lambda x, s: pipe.generator(x, s, gen), batch, pipe.cfg)
    assert torch.equal(a, inside)
    other, _ = pipe(batch, noise=torch.Generator().manual_seed(99))
    assert not torch.equal(a, other)


@pytest.mark.parametrize("layers,s2d", [("most", False), ("most", True),
                                        ("more", False)])
def test_noise_shapes_are_the_forwards_draws(layers, s2d):
    """SPADEGenerator.noise_shapes lists the fields one forward draws, in
    its order, for both depths and the s2d tail."""
    from hrviton_tpu_torch.models.spade import SPADEGenerator
    gen = SPADEGenerator(SPADEGenConfig(ngf=8, fine_height=FH, fine_width=FW,
                                        num_upsampling_layers=layers,
                                        s2d_tail=s2d), device="cpu")
    seen = []

    def draw(shape):
        seen.append(tuple(shape))
        return torch.zeros(shape)
    with torch.no_grad():
        gen(_t(2, FH, FW, 9), torch.zeros(2, FH, FW, dtype=torch.long), draw)
    assert seen == [tuple(s) for s in gen.noise_shapes(2)]
