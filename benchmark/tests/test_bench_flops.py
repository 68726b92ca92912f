"""benchmark/flops.py against torch's own count of the reference's
convolutions, and the unit's bound against a hand count."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, inputs
from benchmark.reference import hrviton as ref
from benchmark.tests.tiny import tiny_config


def _counted_convs(cfg):
    seeds = inputs.sub_seeds(7)
    w = inputs.make_weights(ref.param_specs(cfg), cfg["init"], seeds["weights"],
                            "cpu", torch.float32)
    p = cfg["pipeline"]
    raw = inputs.make_pool(1, 1, p["fine_height"], p["fine_width"],
                           seeds["inputs"], "cpu")[0]
    with FlopCounterMode(display=False) as counter:
        ref.tryon(w, cfg, raw, 1, "cpu")
    return sum(n for op, n in counter.get_flop_counts()["Global"].items()
               if "convolution" in str(op))


def test_conv_flops_match_torch_count():
    cfg = tiny_config()
    assert flops.conv_flops_per_image(cfg) == _counted_convs(cfg)


def test_conv_flops_more_layers():
    cfg = tiny_config()
    cfg["generator"]["num_upsampling_layers"] = "more"
    cfg["pipeline"].update(fine_height=128, fine_width=128)
    assert flops.conv_flops_per_image(cfg) == _counted_convs(cfg)


def test_hand_count():
    # one 3x3 unit: 2 * px * (2 * 9 * 128 * c + 9 * c * cout)
    assert flops.unit_flops(1, 2, 3, 4, 5, 3) == 2 * 6 * (2 * 9 * 128 * 4 + 9 * 4 * 5)
    # bytes: x 4 ch, actv 128, out 5 (+5 residual) in bf16, f32 noise, weights
    assert flops.unit_bytes(1, 2, 3, 4, 5, 3, residual=True) == \
        6 * (4 + 128 + 10) * 2 + 6 * 4 + (2 * 9 * 128 * 4 + 9 * 4 * 5) * 2
    # the blur: two passes of 15 taps on 13 channels
    assert flops.blur_flops(13, 4, 4) == 2 * 2 * 13 * 15 * 16
    # a 1x1 conv 16 -> 8 at 2x2 and a 3x3 conv 8 -> 8 at 2x2
    assert flops._conv(8, 16, 1, 2, 2) == 2 * 8 * 16 * 4
    assert flops._conv(8, 8, 3, 2, 2) == 2 * 8 * 8 * 9 * 4


def test_published_size():
    # the published configuration: about 1.73 TFLOP an image (generator
    # 1.636, tocg 0.092), the six units' bound at batch 4 4.53 ms, batch 1
    # 1.13 ms (PERF.md's kernel table, row 1)
    import json
    from benchmark.tests.tiny import BENCH
    cfg = json.loads((BENCH / "configs" / "hrviton-1024-bf16.json").read_text())
    assert round(flops.conv_flops_per_image(cfg) / 1e12, 2) == 1.73
    units = flops.unit_shapes(cfg)
    assert len(units) == 6

    def bound(b):
        return 1e3 * sum(flops.bound_s(
            flops.unit_flops(b, u.h, u.w, u.c, u.cout, u.ks),
            flops.unit_bytes(b, u.h, u.w, u.c, u.cout, u.ks, residual=u.residual),
            "bfloat16") for u in units)
    assert round(bound(4), 2) == 4.53 and round(bound(1), 2) == 1.13
