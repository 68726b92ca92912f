"""The frozen reference against the port's ``tryon_step`` at a tiny size in
f32 on the CPU (the same weights and inputs), and the controls: the
reference in TF32 and in fp8 put in the program's place fail the limits of
the precision above them (held as a run holds the program: the float32
reference's generator fed the control's condition outputs)."""

import json

import pytest
import torch

from benchmark import check
from benchmark.drivers import tryon_closed_loop as driver
from benchmark.reference.hrviton import LUT_13_TO_7, labels_of
from benchmark.tests.tiny import BENCH, tiny_config

TRAFFIC = {"batch": 2, "pool": 2, "in_flight": 1, "sample": 2}


def _limits(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())["limits"]


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_config("float32")
    seeds, weights, pool, order = driver.make_inputs(cfg, TRAFFIC, 2 ** 31 + 5, "cpu")
    want = driver.reference_outputs(cfg, pool, order, [0, 1], weights,
                                    seeds["pipeline"] + 1, "cpu")
    return cfg, seeds, weights, pool, order, want


def _held(tiny, got, noise=1):
    cfg, seeds, weights, pool, order, _ = tiny
    want = driver.reference_outputs(cfg, pool, order, [0, 1], weights,
                                    seeds["pipeline"] + noise, "cpu",
                                    given=[(g[1], g[3]) for g in got])
    return check.numbers(got, want, cfg["label_margin"])


def test_reference_equals_tryon_step(tiny):
    from hrviton_tpu_torch.cli.test_generator import tryon_step
    cfg, seeds, weights, pool, order, want = tiny
    pipe = driver.build_pipeline(cfg, TRAFFIC, seeds["pipeline"], "cpu")
    driver.load_weights(pipe, weights)
    got = []
    for i in (0, 1):
        step = tryon_step(pipe, pool[order[i]], datasetting="unpaired",
                          compact=True, semantic_nc=13)
        got.append((step.output.float(), step.cond.warped_cloth,
                    step.cond.fake_parse_gauss, step.cond.parse_labels))
    nums = _held(tiny, got)
    assert nums["label_mismatch"] == 0.0
    assert max(nums["rgb_mae"], nums["warp_mae"], nums["seg_mae"]) < 1e-5, nums
    assert check.judge(nums, _limits("hrviton-1024-f32")), nums
    # the reference's own labels agree with the port's at this size
    assert all(torch.equal(g[3].long(), w.labels.long()) for g, w in zip(got, want))


@pytest.mark.parametrize("mode, config", [("tf32", "hrviton-1024-f32"),
                                          ("fp8", "hrviton-1024-bf16")])
def test_control_fails(tiny, mode, config):
    cfg, seeds, weights, pool, order, want = tiny
    got = driver.reference_outputs(cfg, pool, order, [0, 1], weights,
                                   seeds["pipeline"] + 1, "cpu", mode=mode)
    nums = _held(tiny, got)
    assert not check.judge(nums, _limits(config)), nums


def test_noise_matters(tiny):
    # the reference's generator with another noise seed is far from the
    # image the right noise gives
    nums = _held(tiny, tiny[5], noise=2)
    assert nums["rgb_mae"] > 100 * _limits("hrviton-1024-f32")["rgb_mae"]


def test_tf32_rounding():
    from benchmark.reference.hrviton import _round_mantissa
    x = torch.tensor([1.0 + 2 ** -12, 1.0 + 2 ** -11 + 2 ** -13, -3.0 - 2 ** -9,
                      -1.0 - 2 ** -11 - 2 ** -13])
    assert _round_mantissa(x, 10).tolist() == [1.0, 1.0 + 2 ** -10, -3.0 - 2 ** -9,
                                               -1.0 - 2 ** -10]


def test_labels_moved_with_their_logits_are_caught(tiny):
    # a fault that moves the label of a few pixels the reference decides,
    # its logits moved with it: the program's labels agree with its own
    # logits and the mean gaps stay far under the bf16 limits, but not
    # with the reference's labels
    cfg, seeds, weights, pool, order, want = tiny
    bf16 = json.loads((BENCH / "configs" / "hrviton-1024-bf16.json").read_text())
    w = want[0]
    sure = check.decided(w.gauss, bf16["label_margin"])
    assert sure.float().mean() > 0.5
    where = sure[0].nonzero()[:20]
    gauss = w.gauss.clone()
    lut = torch.tensor(LUT_13_TO_7)
    for y, x in where.tolist():
        px = gauss[0, y, x]
        best = int(px.argmax())
        other = int(px.masked_fill(lut == lut[best], -float("inf")).argmax())
        px[best], px[other] = px[other].clone(), px[best].clone()
    labels = labels_of(gauss)
    got = [(w.rgb, w.warped_cloth, gauss, labels)] + [tuple(x) for x in want[1:]]
    nums = check.numbers(got, want, bf16["label_margin"])
    assert nums["label_mismatch"] == 0 and nums["label_vs_ref"] == 20, nums
    others = {k: v for k, v in bf16["limits"].items() if k != "label_vs_ref"}
    assert all(nums[k] <= v for k, v in others.items()), nums
    assert not check.judge(nums, bf16["limits"])
