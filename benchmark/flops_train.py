"""Operations of one trained image of the stage-2 training step, counted from
the layer shapes of the plain reference (``reference/hrviton_train.py``),
2 a multiply-add, convolutions only (the power iterations, the norms, the
losses and Adam are left out).

Each forward the step's mathematics needs is counted once: the
conditioning (the tocg at the condition size and the blur's two passes),
the generator twice (the G update's output and the regeneration), VGG19 on
the fake and on the real image, the discriminator on the fake and the real
image in each of the two updates. Each backward counts twice its forward
where weight and input gradients are taken (the generator; the
discriminator in the D update) and once where only input gradients are
(VGG19; the discriminator on the fake in the G update). No recomputation
(the blocks' remat, VGG's and D's checkpoints) is counted.
"""

from __future__ import annotations

from typing import Dict

from benchmark.flops import (_conv, blur_flops, generator_conv_flops,
                             tocg_conv_flops)

__all__ = ["vgg_conv_flops", "discriminator_conv_flops", "train_flops",
           "train_flops_per_image"]

_VGG = ((64, 2), (128, 2), (256, 4), (512, 4), (512, 1))


def vgg_conv_flops(h: int, w: int) -> int:
    """VGG19 through conv5_1 on one h x w image (2x2 floor pools)."""
    total, cin = 0, 3
    for s, (cout, n) in enumerate(_VGG):
        hs, ws = h >> s, w >> s
        for _ in range(n):
            total += _conv(cout, cin, 3, hs, ws)
            cin = cout
    return total


def discriminator_conv_flops(cfg, h: int, w: int) -> int:
    """The multiscale discriminator on one h x w image: per scale 4x4
    convs with padding 2 (stride 2, then stride 1 for the logits), the
    next scale a 3x3/2 average pool with padding 1."""
    out4 = lambda n, s: (n + 4 - 4) // s + 1
    total = 0
    for _ in range(cfg["num_D"]):
        ch, cw, cin, nf = h, w, cfg["input_nc"], cfg["ndf"]
        for n in range(cfg["n_layers_D"]):
            ch, cw = out4(ch, 2), out4(cw, 2)
            total += _conv(nf, cin, 4, ch, cw)
            cin, nf = nf, min(nf * 2, 512)
        total += _conv(1, cin, 4, out4(ch, 1), out4(cw, 1))
        h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    return total


def train_flops(config) -> Dict[str, Dict[str, int]]:
    """{"forward": {part: operations}, "backward": {part: operations}} of
    one trained image (module docstring)."""
    p = config["pipeline"]
    h, w = p["fine_height"], p["fine_width"]
    g = generator_conv_flops(config["generator"], h, w)
    v = vgg_conv_flops(h, w)
    d = discriminator_conv_flops(config["discriminator"], h, w)
    cond = (tocg_conv_flops(config["tocg"], p["cond_height"], p["cond_width"])
            + blur_flops(config["tocg"]["output_nc"], h, w))
    return {"forward": {"condition": cond, "generator": 2 * g, "vgg": 2 * v,
                        "discriminator": 4 * d},
            "backward": {"generator": 2 * g, "vgg": v,
                         "discriminator": d + 2 * 2 * d}}


def train_flops_per_image(config) -> int:
    parts = train_flops(config)
    return sum(parts["forward"].values()) + sum(parts["backward"].values())
