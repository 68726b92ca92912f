"""Stage-2 training through the CLI's ``build_training`` / ``train_step``
against the plain training reference (``benchmark/reference/hrviton_train.py``),
on the CPU in float32 at a small size (256x192, condition 64x64, SPADE ngf 8
'more', D ndf 16, the tocg and VGG19 at their widths), with the benchmark's
seeded random weights: the conditioning; then, stage by stage as the
benchmark's check holds a step (the reference fed the program's
conditioning, since a label that flips at a near-tie rewrites a whole
region of the generator's modulation; its G update from the program's
state before the step, its D update from the program's updated G), every
loss term, both gradients, the updated parameters, Adam moments and
spectral u/v, after one step and after two.
And ``benchmark/flops_train``'s forwards against the convolutions a
reference step runs."""

import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from benchmark import check_train, flops_train
from benchmark.drivers import train_closed_loop as drv
from benchmark.reference import hrviton as ref_infer
from benchmark.reference import hrviton_train as ref

ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 33 + 5
CPU = torch.device("cpu")
TRAFFIC = {"driver": "train_closed_loop", "batch": 2, "in_flight": 1,
           "pool": 2, "sample": 2, "profile_steps": 1}


def _config():
    cfg = json.loads((ROOT / "benchmark" / "configs" /
                      "hrviton-train-stage2-bf16.json").read_text())
    cfg["precision"] = "float32"
    cfg["pipeline"].update(fine_height=256, fine_width=192, cond_height=64,
                           cond_width=64)
    cfg["generator"].update(ngf=8, num_upsampling_layers="more")
    cfg["discriminator"]["ndf"] = 16
    return cfg


CONFIG = _config()
LOSSES = {"GAN": "loss/gen/GAN", "GAN_Feat": "loss/gen/GAN_Feat",
          "VGG": "loss/gen/VGG", "adv_fake": "loss/dis/adv_fake",
          "adv_real": "loss/dis/adv_real"}


@pytest.fixture(scope="module")
def steps():
    """(the program's two steps as the benchmark takes them; for each, the
    reference's G update from the program's state before it and D update
    from the program's updated G, both fed the program's conditioning; the
    frozen networks' weights)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    try:
        built = drv.build(CONFIG, TRAFFIC, 7, "cpu")
        _, weights, pool, order = drv.make_inputs(CONFIG, TRAFFIC, SEED, CPU)
        drv.load_weights(built, weights)
        loop = drv.Loop(built, pool, order, CPU)
        loop.sample = {0, 1}
        loop.step(0)
        loop.step(1)
        frozen = {m: weights[m] for m in ("tocg", "vgg")}
        want = []
        for t in loop.taken:
            gb, db = t["before"]["generator"], t["before"]["discriminator"]
            g = ref.g_step(frozen, gb["params"], check_train._opt(gb),
                           db["params"], t["raw"], t["fields_g"], CONFIG, CPU,
                           cond=check_train.conditioning_of(t["cond"], CONFIG))
            d = ref.d_step(frozen, t["after"]["generator"]["params"],
                           db["params"], check_train._opt(db), t["raw"],
                           t["fields_d"], CONFIG, CPU, cond=g.pop("cond"))
            want.append((g, d))
        return loop.taken, want, frozen
    finally:
        torch.set_num_threads(threads)


def _vec(d, keys):
    return torch.cat([d[k].reshape(-1).double() for k in keys])


def _rel(a, b):
    return float((a - b).norm() / b.norm())


NETS = ("generator", "discriminator")
LRS = {"generator": CONFIG["train"]["G_lr"], "discriminator": CONFIG["train"]["D_lr"]}


@pytest.mark.parametrize("step", [0, 1], ids=["step1", "step2"])
def test_conditioning(steps, step):
    """The program's warped cloth and labels against the reference's own
    conditioning of the batch: the cloth within rounding, the labels but
    for a few near-ties."""
    taken = steps[0][step]
    for s, part in enumerate(ref.samples(taken["raw"])):
        x, _, labels = ref.conditioning(ref.Precision(), steps[2]["tocg"], CONFIG,
                                        ref.expand(part, CPU))
        got = taken["cond"]["x"][s:s + 1].permute(0, 3, 1, 2)
        torch.testing.assert_close(got, x, rtol=0, atol=1e-4)
        flipped = (taken["cond"]["labels"][s:s + 1] != labels).float().mean()
        assert float(flipped) < 1e-3


@pytest.mark.parametrize("step", [0, 1], ids=["step1", "step2"])
def test_held_outputs(steps, step):
    """What the step's graph wrote and the trainer holds (``held``): G's
    output of the G update and D's logits of the D update, against the
    reference's from the same state, conditioning and noise."""
    got, want = steps[0][step], steps[1][step]
    fake = got["fake"].permute(0, 3, 1, 2)
    assert fake.shape == want[0]["fake"].shape
    assert float((fake - want[0]["fake"]).abs().max()) < 1e-4
    assert len(got["d_logits"]) == len(want[1]["logits"]) == 4
    for a, b in zip(got["d_logits"], want[1]["logits"]):
        a = a.permute(0, 3, 1, 2)
        assert a.shape == b.shape
        assert _rel(a.reshape(-1).double(), b.reshape(-1).double()) < 1e-4


@pytest.mark.parametrize("step", [0, 1], ids=["step1", "step2"])
def test_losses(steps, step):
    got, want = steps[0][step], steps[1][step]
    ref_losses = {**want[0]["losses"], **want[1]["losses"]}
    for r, p in LOSSES.items():
        assert got["losses"][p] == pytest.approx(ref_losses[r], rel=1e-4, abs=1e-6), r


@pytest.mark.parametrize("step", [0, 1], ids=["step1", "step2"])
@pytest.mark.parametrize("net", [0, 1], ids=NETS)
def test_gradients(steps, step, net):
    got = steps[0][step]["grads"][NETS[net]]
    want = steps[1][step][net]["grads"]
    keys = sorted(want)
    assert set(got) == set(want)
    a, b = _vec(got, keys), _vec(want, keys)
    # the head's instance norms over 4 x 3 pixels amplify float32 rounding
    # in G's backward (the taps' chunked sums against the library's)
    assert _rel(a, b) < (5e-3 if net == 0 else 2e-4)
    assert float(torch.dot(a, b) / (a.norm() * b.norm())) > 1 - 2e-5


@pytest.mark.parametrize("step", [0, 1], ids=["step1", "step2"])
@pytest.mark.parametrize("net", [0, 1], ids=NETS)
def test_updated_parameters_moments_and_uv(steps, step, net):
    """Adam(0, 0.9) with bias correction on the program's gradients gives
    the program's parameters and moments within float32 rounding; the
    reference's own update (on its own gradients) differs from the
    program's by at most twice Adam's largest step an element (lr, then
    lr * sqrt((1 - 0.9^t) / 0.1)): Adam(0, .) moves each element by about
    lr * sign(g), so where a gradient is near zero (a bias before an
    instance norm) or ill-conditioned, rounding moves its update by up to
    that much; the new u/v are the reference's power iteration."""
    name = NETS[net]
    before, after = steps[0][step]["before"][name], steps[0][step]["after"][name]
    grads = steps[0][step]["grads"][name]
    want = steps[1][step][net]
    keys = sorted(want["grads"])
    lr = LRS[name]
    assert after["count"] == want["opt"].count == step + 1
    params, opt = ref.adam(before["params"], grads, check_train._opt(before), lr,
                           0.0, 0.9)
    p0 = _vec(before["params"], keys)
    assert _rel(_vec(after["params"], keys) - p0, _vec(params, keys) - p0) < 1e-5
    assert _rel(_vec(after["exp_avg"], keys), _vec(opt.exp_avg, keys)) < 1e-6
    assert _rel(_vec(after["exp_avg_sq"], keys), _vec(opt.exp_avg_sq, keys)) < 1e-6
    gap = (_vec(after["params"], keys) - _vec(want["params"], keys)).abs()
    assert float(gap.max()) < 2.001 * lr * ((1 - 0.9 ** (step + 1)) / 0.1) ** 0.5
    names = ref.spectral_names(want["params"])
    assert names
    for s in names:
        for k in (f"{s}.u", f"{s}.v"):
            torch.testing.assert_close(after["params"][k], want["params"][k],
                                       rtol=1e-4, atol=1e-5)


def test_flops_count_the_reference_steps_convolutions(monkeypatch):
    """flops_train's forwards of one trained image equal the operations of
    every F.conv2d call of a reference step (from their shapes), over the
    batch; its backwards are the rule's multiples of them."""
    cfg = json.loads(json.dumps(CONFIG))
    cfg["pipeline"].update(fine_height=128, fine_width=128)
    cfg["generator"]["num_upsampling_layers"] = "most"
    _, weights, pool, order = drv.make_inputs(cfg, TRAFFIC, SEED + 1, CPU)
    n = TRAFFIC["batch"]
    zeros = lambda m: ref.Opt(*[{k: torch.zeros_like(v) for k, v in weights[m].items()
                                 if not k.endswith((".u", ".v"))}] * 2, 0)
    fields = [torch.randn(s) for s in
              ref_infer.noise_shapes(cfg["generator"], n, 128, 128)]
    counted = []
    conv2d = F.conv2d

    def counting(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
        y = conv2d(x, w, b, stride, padding, dilation, groups)
        counted.append(2 * y.numel() * w.shape[1] * w.shape[2] * w.shape[3])
        return y
    monkeypatch.setattr(F, "conv2d", counting)
    ref.train_step({m: weights[m] for m in ("tocg", "vgg")},
                   weights["generator"], zeros("generator"),
                   weights["discriminator"], zeros("discriminator"),
                   pool[order[0]], fields, fields, cfg, CPU)
    monkeypatch.setattr(F, "conv2d", conv2d)
    parts = flops_train.train_flops(cfg)
    assert sum(counted) == n * sum(parts["forward"].values())
    fwd, bwd = parts["forward"], parts["backward"]
    assert bwd["generator"] == fwd["generator"]           # 2 x one forward
    assert bwd["vgg"] * 2 == fwd["vgg"]                   # 1 x one forward
    assert bwd["discriminator"] * 4 == 5 * fwd["discriminator"]
    assert flops_train.train_flops_per_image(cfg) == sum(fwd.values()) + sum(bwd.values())
