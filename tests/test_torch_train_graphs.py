"""The training entry points as recorded steps (``core/graphs.py``,
``Captured(donated=...)``), on the CPU.

The CPU stands in for the card as in ``tests/test_torch_graphs.py``
(``_Rerun``: the card's ``_capture`` with a plain warm-up, a "recording"
whose writes to the donated state are undone, and a "replay" that runs the
function again). Each point of a step's contract is held bit for bit
against the plain calls (``graphs.disabled()``) from the same initial
state: N recorded calls equal N plain calls from the first call on (the
parameters, Adam's moments and step counts, the running statistics, the
spectral u/v, the generators' states, the outputs); the Python counters
(``state.step``, ``Adam.count``) move once a call, outside the body; the
step's own writes record nothing anew, a write from outside does; draws
from a donated generator and noise drawn before the call come in the plain
calls' order. Then both trainers' steps, their eval calls, the CLIs'
``expand`` and ``lpips_resize`` and the LPIPS head step run through the
stand-in at tiny shapes (the tocg at 64x64, SPADE at 128x128). No JAX: the
trainers' JAX parity tests run the same entry points in their own files.
"""

import numpy as np
import pytest
import torch

from hrviton_tpu_torch.config import (CondDiscriminatorConfig,
                                      ConditionTrainConfig,
                                      GeneratorTrainConfig, PipelineConfig,
                                      SPADEDiscriminatorConfig, SPADEGenConfig,
                                      TOCGConfig)
from hrviton_tpu_torch.core import graphs
from hrviton_tpu_torch.models.backbones import Vgg19Features
from hrviton_tpu_torch.nn.layers import (BatchNorm2d, Conv2d, commit_state,
                                         init_weights)
from hrviton_tpu_torch.train import condition_trainer as ct
from hrviton_tpu_torch.train import generator_trainer as gt
from hrviton_tpu_torch.train.optim import adam
from test_torch_graphs import _Rerun

torch.set_num_threads(2)


def _stand_in(monkeypatch, module, name):
    """``module.name`` (a Captured) replaced by the CPU stand-in; returns
    it."""
    c = getattr(module, name)
    rerun = _Rerun(c.fn, weights=c.weights, context=c.context,
                   donated=c.donated)
    monkeypatch.setattr(module, name, rerun)
    return rerun


def _same(a, b, what):
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and torch.equal(x, y), (what, i)


# ------------------------------------------------- a small module and Adam

class _Net(torch.nn.Module):
    def __init__(self, seed):
        super().__init__()
        self.conv = Conv2d(3, 4, 3, padding=1, device="cpu")
        self.bn = BatchNorm2d(4, device="cpu")
        init_weights(self, torch.Generator().manual_seed(seed))


def _body(net, opt, x, gen):
    """A training step: a dropout mask drawn inside from ``gen``, the batch
    norm's statistics written, one Adam update; returns the loss."""
    h = net.conv(x)
    mask = torch.bernoulli(torch.full(h.shape, 0.5), generator=gen)
    loss = net.bn(h * mask, train=True).square().mean()
    grads = torch.autograd.grad(loss, opt.params)
    for p, g in zip(opt.params, grads):
        p.grad = g
    opt.update()
    commit_state(net)
    return {"loss": loss.detach(), "h": h.detach()}


class _Small:
    """A net, its Adam with a multiplier that changes every update, a
    dropout generator, and the batches' noise generator."""

    def __init__(self, seed=0):
        self.net = _Net(seed)
        self.opt = adam(self.net.parameters(), 1e-2, 0.5, 0.999,
                        schedule=lambda c: 1.0 / (1.0 + c))
        self.gen = torch.Generator().manual_seed(5)
        self.noise = torch.Generator().manual_seed(6)

    def state(self):
        return graphs.module_tensors(self.net) + self.opt.state_tensors()

    def step(self, fn, k):
        x = torch.from_numpy(np.random.default_rng(k).standard_normal(
            (2, 3, 8, 8)).astype(np.float32))
        x = x + torch.randn(x.shape, generator=self.noise)   # drawn outside
        self.opt.prepare()
        out = fn(self.net, self.opt, x, self.gen)
        self.opt.advance()
        return out


def _recorded():
    return _Rerun(_body, donated=lambda net, opt, x, gen: graphs.module_tensors(
        net) + opt.state_tensors() + [gen])


def _held(rec, plain, outs_r, outs_p):
    _same(rec.state(), plain.state(), "state")
    assert torch.equal(rec.gen.get_state(), plain.gen.get_state())
    assert torch.equal(rec.noise.get_state(), plain.noise.get_state())
    assert rec.opt.count == plain.opt.count
    for a, b in zip(outs_r, outs_p):
        _same([a["loss"], a["h"]], [b["loss"], b["h"]], "outputs")


def test_recorded_calls_equal_plain_calls():
    """Four recorded calls equal four plain calls bit for bit, with the
    learning rate changing every update; one recording."""
    rec, plain = _Small(), _Small()
    cap = _recorded()
    outs_r = [rec.step(cap, k) for k in range(4)]
    with graphs.disabled():
        outs_p = [plain.step(cap, k) for k in range(4)]
    _held(rec, plain, outs_r, outs_p)
    assert cap.captures == 1 and cap.last_entry.replays == 4
    assert rec.opt.opt.param_groups[0]["lr"] == pytest.approx(1e-2 / 4)


def test_first_call_steps_once():
    """The first call records and takes exactly one step: Adam's step
    count is 1, the generator advanced once, the outputs are the plain
    step's."""
    rec, plain = _Small(), _Small()
    cap = _recorded()
    out_r = rec.step(cap, 0)
    with graphs.disabled():
        out_p = plain.step(cap, 0)
    _held(rec, plain, [out_r], [out_p])
    steps = [s["step"] for s in rec.opt.opt.state.values()]
    assert all(float(s) == 1.0 for s in steps)
    assert rec.opt.count == 1 and cap.captures == 1


def test_python_counters_move_once_per_call():
    rec = _Small()
    cap = _recorded()
    for k in range(3):
        rec.step(cap, k)
        assert rec.opt.count == k + 1
        assert all(float(s["step"]) == k + 1 for s in rec.opt.opt.state.values())


def test_outside_writes_record_anew_and_own_writes_do_not():
    """The step's own writes (Adam, the running statistics) record nothing
    anew; an in-place copy into a parameter from outside and a swapped
    ``.data`` (``cast_floating``) do, and the next calls equal the plain
    calls after the same writes."""
    rec, plain = _Small(), _Small()
    cap = _recorded()
    outs_r = [rec.step(cap, k) for k in range(3)]
    assert cap.captures == 1

    def write(s):
        with torch.no_grad():
            s.net.conv.weight.copy_(s.net.conv.weight * 0.5)

    def swap(s):
        s.net.bn.running_var.data = s.net.bn.running_var.data.clone() + 1.0
    write(rec)
    outs_r.append(rec.step(cap, 3))
    assert cap.captures == 2
    swap(rec)
    outs_r.append(rec.step(cap, 4))
    outs_r.append(rec.step(cap, 5))
    assert cap.captures == 3
    with graphs.disabled():
        outs_p = [plain.step(cap, k) for k in range(3)]
        write(plain)
        outs_p.append(plain.step(cap, 3))
        swap(plain)
        outs_p += [plain.step(cap, 4), plain.step(cap, 5)]
    _held(rec, plain, outs_r, outs_p)


def test_draws_come_in_plain_order():
    """The dropout masks drawn inside from a donated generator and the noise
    drawn before each call follow the plain calls' sequence: the recorded
    run's generators end where the plain run's do, and a run with another
    dropout seed differs."""
    rec, plain, other = _Small(), _Small(), _Small()
    other.gen.manual_seed(9)
    cap = _recorded()
    outs_r = [rec.step(cap, k) for k in range(3)]
    outs_o = [other.step(cap, k) for k in range(3)]
    with graphs.disabled():
        outs_p = [plain.step(cap, k) for k in range(3)]
    _held(rec, plain, outs_r, outs_p)
    assert not torch.equal(outs_o[1]["loss"], outs_r[1]["loss"])


def test_captured_calls_inside_a_recording_are_traced_into_it():
    """A captured function called while another is warmed up, recorded or
    replayed runs its plain call (as a jitted function called inside a jit
    is inlined): it records nothing of its own."""
    inner = _Rerun(lambda x: x * 2)
    outer = _Rerun(lambda x: inner(x) + 1)
    x = torch.arange(3.0)
    for _ in range(3):
        assert torch.equal(outer(x), x * 2 + 1)
    assert outer.captures == 1 and inner.captures == 0
    inner(x)
    assert inner.captures == 1


def test_captured_functions_share_a_pool():
    """Captured functions given one Pool share its handle; the pool is in
    use while any of them holds a graph, and no longer once the identity
    argument of the last graph has died."""
    pool = graphs.Pool()
    step = _Rerun(lambda net, x: net(x), pool=pool)
    evaluate = _Rerun(lambda net, x: net(x) * 2, pool=pool)
    assert pool.users == [step, evaluate] and not pool.in_use()
    net = torch.nn.Linear(3, 2)
    x = torch.ones(4, 3)
    with torch.no_grad():
        evaluate(net, x)
        assert pool.in_use() and step.pool is evaluate.pool
        step(net, x)
    del net
    assert not pool.in_use()


def test_gradients_stay_in_their_first_buffers():
    """apply_grads copies each later step's gradients into the ``.grad``
    tensors of the first call (a recorded step writes them outside its
    pool), with the values of the gradients themselves."""
    net = _Net(0)
    state = ct.NetState(net, adam(net.parameters(), 1e-3, 0.5, 0.999))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 3, 8, 8), dtype=np.float32))
    loss = lambda: net.bn(net.conv(x), train=True).square().mean()
    ct.apply_grads(loss(), state)
    first = [p.grad for p in state.opt.params]
    value = loss()
    want = torch.autograd.grad(value, state.opt.params, retain_graph=True)
    ct.apply_grads(value, state)
    for p, f, w in zip(state.opt.params, first, want):
        assert p.grad is f and torch.equal(p.grad, w)


# ------------------------------------------------------------- the trainers

CH, CW = 64, 64
FH, FW = 128, 128


def _cond_batch(n=2, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda c: torch.from_numpy(rng.standard_normal((n, CH, CW, c),
                                                       dtype=np.float32))
    labels = torch.from_numpy(rng.integers(0, 13, (n, CH, CW)))
    parse = torch.nn.functional.one_hot(labels, 13).float()
    return {"cloth": {"paired": f(3)},
            "cloth_mask": {"paired": f(1).sigmoid()},
            "parse_agnostic": f(13), "densepose": f(3),
            "parse_onehot": labels.int(), "parse": parse,
            "pcm": parse[..., 3:4].clone(), "parse_cloth": f(3)}


def _gen_batch(n=2, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda c: torch.from_numpy(np.tanh(rng.standard_normal(
        (n, FH, FW, c), dtype=np.float32)))
    labels = torch.from_numpy(rng.integers(0, 13, (n, FH, FW)))
    return {"cloth": f(3), "cloth_mask": f(1) * 0.5 + 0.5,
            "parse_agnostic": f(13), "densepose": f(3), "agnostic": f(3),
            "image": f(3),
            "parse": torch.nn.functional.one_hot(labels, 13).float(),
            "parse_cloth": f(3)}


@pytest.fixture(scope="module")
def vgg():
    v = Vgg19Features(device="cpu")
    init_weights(v, torch.Generator().manual_seed(7))
    return v.requires_grad_(False)


def _gan_state(trainer, state):
    """Every tensor a step writes, the step count, the optimizers' counts."""
    nets = (state.g, state.d)
    return ct.net_tensors(*nets), (state.step, state.g.opt.count,
                                   state.d.opt.count)


def _metrics(ms):
    return [v for m in ms for _, v in sorted(m.items())]


def _cond_trainer():
    trainer = ct.ConditionTrainer(
        TOCGConfig(ngf=8), CondDiscriminatorConfig(input_nc=33, ndf=8,
                                                   ddropout=True,
                                                   spectral=True),
        ConditionTrainConfig(), device="cpu")
    return trainer, trainer.init(0)


def test_condition_trainer_step_recorded(monkeypatch, vgg):
    """Stage 1 (tocg ngf=8 at 64x64, the condition discriminator with
    --Ddropout and spectral norms): three recorded steps equal three plain
    steps (losses, parameters, Adam's state, BatchNorm statistics, u/v, the
    dropout generator, the counts), one recording; then visualize and
    eval_iou through their recorded calls equal their plain calls."""
    step = _stand_in(monkeypatch, ct, "_step")
    (t_r, s_r), (t_p, s_p) = _cond_trainer(), _cond_trainer()
    batches = [_cond_batch(seed=k) for k in range(3)]
    m_r = [t_r.train_step(s_r, b, vgg)[1] for b in batches]
    with graphs.disabled():
        m_p = [t_p.train_step(s_p, b, vgg)[1] for b in batches]
    _same(_metrics(m_r), _metrics(m_p), "metrics")
    (a, ca), (b, cb) = _gan_state(t_r, s_r), _gan_state(t_p, s_p)
    _same(a, b, "state")
    assert ca == cb == (3, 3, 3)
    assert torch.equal(t_r.dropout.get_state(), t_p.dropout.get_state())
    assert step.captures == 1 and step.last_entry.replays == 3

    vis = _stand_in(monkeypatch, ct, "_visualize_graph")
    iou = _stand_in(monkeypatch, ct, "_eval_iou_graph")
    got = [t_r.visualize(s_r, batches[0]), t_r.eval_iou(s_r, batches[1])]
    got2 = t_r.visualize(s_r, batches[2])
    with graphs.disabled():
        want = [t_p.visualize(s_p, batches[0]), t_p.eval_iou(s_p, batches[1])]
        want2 = t_p.visualize(s_p, batches[2])
    for k in want[0]:
        _same([got[0][k], got2[k]], [want[0][k], want2[k]], k)
    _same([got[1]], [want[1]], "iou")
    assert vis.captures == 1 and iou.captures == 1


def _gen_trainer():
    from hrviton_tpu_torch.models.condition import ConditionGenerator
    pcfg = PipelineConfig(fine_height=FH, fine_width=FW, cond_height=CH,
                          cond_width=CW)
    trainer = gt.GeneratorTrainer(
        SPADEGenConfig(ngf=8, fine_height=FH, fine_width=FW,
                       num_upsampling_layers="more"),
        SPADEDiscriminatorConfig(ndf=8), GeneratorTrainConfig(), pcfg,
        TOCGConfig(ngf=8), device="cpu")
    state = trainer.init(0)
    with torch.no_grad():
        for name, p in state.g.module.named_parameters():
            if name.endswith("noise_scale"):
                p.fill_(0.2)
    tocg = ConditionGenerator(TOCGConfig(ngf=8), device="cpu").eval()
    init_weights(tocg, torch.Generator().manual_seed(3))
    return trainer, state, tocg.requires_grad_(False)


def test_generator_trainer_step_recorded(monkeypatch, vgg):
    """Stage 2 (SPADE ngf=8 'more' at 128x128 with non-zero noise scales,
    the SPADE discriminator, the frozen tocg ngf=8 at 64x64, remat on): three
    recorded steps fed one noise generator, as the CLI feeds it, equal three
    plain steps (losses, parameters, Adam's state, u/v, the generator's
    state, the counts), one recording; then generate and generate_debug
    equal their plain calls."""
    step = _stand_in(monkeypatch, gt, "_step")
    (t_r, s_r, tocg_r), (t_p, s_p, tocg_p) = _gen_trainer(), _gen_trainer()
    batches = [_gen_batch(seed=k) for k in range(3)]
    noise_r = torch.Generator().manual_seed(1)
    noise_p = torch.Generator().manual_seed(1)
    m_r = [t_r.train_step(s_r, b, noise_r, noise_r,
                          {"vgg": vgg, "tocg": tocg_r})[1] for b in batches]
    with graphs.disabled():
        m_p = [t_p.train_step(s_p, b, noise_p, noise_p,
                              {"vgg": vgg, "tocg": tocg_p})[1] for b in batches]
    _same(_metrics(m_r), _metrics(m_p), "metrics")
    (a, ca), (b, cb) = _gan_state(t_r, s_r), _gan_state(t_p, s_p)
    _same(a, b, "state")
    assert ca == cb == (3, 3, 3)
    assert torch.equal(noise_r.get_state(), noise_p.get_state())
    assert step.captures == 1

    gen = _stand_in(monkeypatch, gt, "_generate_graph")
    dbg = _stand_in(monkeypatch, gt, "_generate_debug_graph")
    got = [t_r.generate(s_r, batches[0], noise_r, tocg_r),
           t_r.generate(s_r, batches[1], noise_r, tocg_r),
           *t_r.generate_debug(s_r, batches[2], noise_r, tocg_r)]
    with graphs.disabled():
        want = [t_p.generate(s_p, batches[0], noise_p, tocg_p),
                t_p.generate(s_p, batches[1], noise_p, tocg_p),
                *t_p.generate_debug(s_p, batches[2], noise_p, tocg_p)]
    _same(got, want, "generate")
    assert gen.captures == 1 and dbg.captures == 1


def test_cli_expand_and_lpips_resize_recorded(monkeypatch):
    """The CLIs' expand of a compact batch and lpips_resize equal their
    plain calls through the stand-in, a recording each."""
    from hrviton_tpu_torch.cli import common
    from hrviton_tpu_torch.cli import train_generator as t2
    from hrviton_tpu_torch.losses.lpips import make_lpips
    exp = _stand_in(monkeypatch, common, "expand")
    res = _stand_in(monkeypatch, t2, "_lpips_resize")
    rng = np.random.default_rng(4)
    u8 = lambda *s: rng.integers(0, 256, s).astype(np.uint8)
    raws = [{"cloth": {"paired": u8(2, 32, 24, 3)},
             "cloth_mask": {"paired": (u8(2, 32, 24, 1) > 127).astype(np.float32)},
             "parse_idx": rng.integers(0, 13, (2, 32, 24)).astype(np.uint8),
             "parse_agnostic_idx": rng.integers(0, 13, (2, 32, 24)).astype(np.uint8),
             "image": u8(2, 32, 24, 3), "densepose": u8(2, 32, 24, 3),
             "pose": u8(2, 32, 24, 3), "agnostic": u8(2, 32, 24, 3),
             "im_name": ["a", "b"], "c_name": ["c", "d"]} for _ in range(2)]
    got = [common.batch_to_device(r, "cpu", True) for r in raws]
    with graphs.disabled():
        want = [common.batch_to_device(r, "cpu", True) for r in raws]
    leaves = lambda ts: [v for t in ts for _, v in sorted(
        _flat(t), key=lambda kv: kv[0])]
    _same(leaves(got), leaves(want), "expand")
    assert exp.captures == 1
    lp = make_lpips(device="cpu")
    a, b = got[0]["image"], got[1]["image"]
    got_d = [t2.lpips_resize(lp, a, b), t2.lpips_resize(lp, b, a)]
    with graphs.disabled():
        want_d = [t2.lpips_resize(lp, a, b), t2.lpips_resize(lp, b, a)]
    _same(got_d, want_d, "lpips_resize")
    assert res.captures == 1


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _flat(v, f"{prefix}/{k}")]
    return [(prefix, tree)]


def test_lpips_head_step_recorded(monkeypatch):
    """LPIPSHeadTrainer (alex at 64x64, batch 4): three recorded steps equal
    three plain steps (losses, accuracies, the heads clamped, the rank net,
    Adam's state, the dropout generator), one recording, and the decayed
    learning rate is read by the next recorded step."""
    from hrviton_tpu_torch.losses import lpips_train as lt
    step = _stand_in(monkeypatch, lt, "_step")
    rec, plain = (lt.LPIPSHeadTrainer(net="alex", lr=1e-3, device="cpu")
                  for _ in range(2))
    rng = np.random.default_rng(11)
    batches = [(np.tanh(rng.standard_normal((4, 64, 64, 3))),
                np.tanh(rng.standard_normal((4, 64, 64, 3))),
                np.tanh(rng.standard_normal((4, 64, 64, 3))),
                rng.uniform(0, 1, 4)) for _ in range(3)]

    def run(t):
        out = [t.train_step(*batches[0]), t.train_step(*batches[1])]
        t.update_learning_rate(4)
        return out + [t.train_step(*batches[2])]
    got = run(rec)
    with graphs.disabled():
        want = run(plain)
    assert got == want
    tensors = lambda t: (graphs.module_tensors(t.model, t.rank)
                         + t.opt.state_tensors())
    _same(tensors(rec), tensors(plain), "state")
    assert torch.equal(rec.dropout.get_state(), plain.dropout.get_state())
    assert rec.opt.count == 3 and step.captures == 1
    assert all(float(h.weight.detach().min()) >= 0.0 for h in rec.heads)


def test_training_clis_ask_for_expandable_segments(monkeypatch):
    """cli/common.expandable_segments: the allocator setting on a CUDA
    device, nothing on the CPU or where PYTORCH_CUDA_ALLOC_CONF names it."""
    from hrviton_tpu_torch.cli import common
    calls = []
    monkeypatch.setattr(torch.cuda.memory, "_set_allocator_settings",
                        calls.append)
    monkeypatch.delenv("PYTORCH_CUDA_ALLOC_CONF", raising=False)
    common.expandable_segments("cpu")
    common.expandable_segments(torch.device("cuda", 0))
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:False")
    common.expandable_segments("cuda")
    assert calls == ["expandable_segments:True"]
