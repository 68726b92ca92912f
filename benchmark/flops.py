"""Operations and bytes counted from shapes, and the card's peaks.

``conv_flops_per_image``: the operations (2 a multiply-add) of every
convolution one try-on of one image runs, from the configuration's layer
shapes as the reference (``reference/hrviton.py``) lays them out: the
condition generator at the condition size, the SPADE generator at the fine
size, and the Gaussian blur's two depthwise passes. Elementwise work, the
warps and the resizes are not counted.

``unit_shapes``, ``unit_flops``, ``unit_bytes``: the fused SPADE unit
({SPADE norm -> activation -> conv}, its gamma|beta 3x3 products over 128
hidden channels and the conv it feeds) at the blocks the program fuses
(up_3 and up_4 of 'most' at 1024x768: fine height >= 256), counted from the
function's shapes; bytes read once and written once (x, the hidden
activation, the f32 noise, a residual, the output and the weights). The
least time of a piece of work is the larger of its operations over the peak
rate and its bytes over the peak bandwidth (``bound_s``).

``PEAKS``: one NVIDIA H100 SXM (NVIDIA's data sheet, dense): 989 TFLOP/s in
bf16, 67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of HBM.
"""

from __future__ import annotations

from typing import List, NamedTuple

__all__ = ["PEAKS", "conv_flops_per_image", "tocg_conv_flops",
           "generator_conv_flops", "blur_flops", "unit_shapes", "unit_flops",
           "unit_bytes", "bound_s", "Unit"]

PEAKS = {"bfloat16": 989e12, "float32": 67e12, "bytes_per_s": 3.35e12}
_NHIDDEN = 128


def _conv(cout, cin, k, h, w) -> int:
    """A k x k conv producing (cout, h, w) from cin channels."""
    return 2 * cout * cin * k * k * h * w


def tocg_conv_flops(cfg, h: int, w: int) -> int:
    """The condition generator at h x w (its input size), one image."""
    ngf, in1, in2 = cfg["ngf"], cfg["input1_nc"], cfg["input2_nc"]
    enc = [ngf, ngf * 2, ngf * 4, ngf * 4, ngf * 4]
    seg = [ngf * 4, ngf * 4, ngf * 2, ngf, ngf]

    def res(cin, cout, scale, oh, ow):
        # oh, ow: the block's output size
        first = _conv(cout, cin, 3 if scale == "down" else 1, oh, ow)
        return first + 2 * _conv(cout, cout, 3, oh, ow)

    total = 0
    for cin0 in (in1, in2):
        for i, d in enumerate(enc):
            total += res(cin0 if i == 0 else enc[i - 1], d, "down",
                         h >> (i + 1), w >> (i + 1))
    lh, lw = h >> 5, w >> 5
    total += _conv(2, ngf * 8, 3, lh, lw)                      # flow_conv_0
    total += res(ngf * 4, ngf * 8, "same", lh, lw)             # conv
    total += res(ngf * 8, seg[0], "up", lh * 2, lw * 2)        # SegDecoder_0
    for i in range(1, 5):
        j = 4 - i
        fh, fw = h >> (5 - i), w >> (5 - i)                    # level i's size
        total += 2 * _conv(ngf * 4, enc[j], 1, fh, fw)         # conv1_j, conv2_j
        total += _conv(ngf * 4, seg[i - 1], 3, fh, fw)         # bottleneck
        total += _conv(2, ngf * 8, 3, fh, fw)                  # flow_conv_i
        total += res(seg[i - 1] + enc[j] + ngf * 4, seg[i], "up", fh * 2, fw * 2)
    total += res(seg[4] + in2 + in1, cfg["output_nc"], "same", h, w)
    return total


def _gen_blocks(cfg):
    nf = cfg["ngf"]
    blocks = [("head_0", nf * 16, nf * 16), ("G_middle_0", nf * 16 + 16, nf * 16),
              ("G_middle_1", nf * 16 + 16, nf * 16), ("up_0", nf * 16 + 16, nf * 8),
              ("up_1", nf * 8 + 16, nf * 4), ("up_2", nf * 4 + 16, nf * 2),
              ("up_3", nf * 2 + 16, nf)]
    if cfg["num_upsampling_layers"] == "most":
        blocks.append(("up_4", nf + 16, nf // 2))
    return blocks


def _levels(cfg, h, w):
    f = 2 ** (len(_gen_blocks(cfg)) - 1)
    return h // f, w // f


def generator_conv_flops(cfg, h: int, w: int) -> int:
    """The SPADE generator at h x w, one image."""
    sh, sw = _levels(cfg, h, w)
    sem, nin = cfg["gen_semantic_nc"], cfg["input_nc"]

    def norm(nc, bh, bw):
        return _conv(_NHIDDEN, sem, 3, bh, bw) + 2 * _conv(nc, _NHIDDEN, 3, bh, bw)

    total = 0
    for i, (_, cin, cout) in enumerate(_gen_blocks(cfg)):
        bh, bw = sh << i, sw << i
        total += _conv(cfg["ngf"] * 16 if i == 0 else 16, nin, 3, bh, bw)
        middle = min(cin, cout)
        if cin != cout:
            total += norm(cin, bh, bw) + _conv(cout, cin, 1, bh, bw)
        total += norm(cin, bh, bw) + _conv(middle, cin, 3, bh, bw)
        total += norm(middle, bh, bw) + _conv(cout, middle, 3, bh, bw)
    total += _conv(3, _gen_blocks(cfg)[-1][2], 3, h, w)        # conv_img
    return total


def blur_flops(channels: int, h: int, w: int, ksize: int = 15) -> int:
    """The separable Gaussian blur: two depthwise passes of ``ksize`` taps."""
    return 2 * 2 * channels * ksize * h * w


def conv_flops_per_image(config) -> int:
    p = config["pipeline"]
    return (tocg_conv_flops(config["tocg"], p["cond_height"], p["cond_width"])
            + generator_conv_flops(config["generator"], p["fine_height"],
                                   p["fine_width"])
            + blur_flops(config["tocg"]["output_nc"], p["fine_height"],
                         p["fine_width"]))


class Unit(NamedTuple):
    name: str
    h: int
    w: int
    c: int          # x's channels
    cout: int
    ks: int         # the consumer conv's kernel size
    pre_act: object
    residual: bool


def unit_shapes(config) -> List[Unit]:
    """The fused units of one forward: each {norm, conv} pair of the blocks
    at fine height >= 256 (norm_s -> conv_s, norm_0 -> conv_0, norm_1 ->
    conv_1 with the shortcut as residual)."""
    g, p = config["generator"], config["pipeline"]
    sh, sw = _levels(g, p["fine_height"], p["fine_width"])
    units = []
    for i, (name, cin, cout) in enumerate(_gen_blocks(g)):
        bh, bw = sh << i, sw << i
        if bh < 256 or bw % 128:
            continue
        middle = min(cin, cout)
        if cin != cout:
            units.append(Unit(f"{name}.s", bh, bw, cin, cout, 1, None, False))
        units.append(Unit(f"{name}.0", bh, bw, cin, middle, 3, "leaky0.2", False))
        units.append(Unit(f"{name}.1", bh, bw, middle, cout, 3, "leaky0.2", True))
    return units


def unit_flops(b, h, w, c, cout, ks, nh=_NHIDDEN) -> int:
    """gamma and beta 3x3 convs over nh channels plus the consumer conv."""
    return 2 * b * h * w * (2 * 9 * nh * c + ks * ks * c * cout)


def unit_bytes(b, h, w, c, cout, ks, nh=_NHIDDEN, elem=2, residual=False) -> int:
    """x, actv, noise (f32), residual read once, out written once, weights
    read once."""
    px = b * h * w
    act = px * (c + nh + cout * (2 if residual else 1)) * elem + px * 4
    weights = (2 * 9 * nh * c + ks * ks * c * cout) * elem
    return act + weights


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    return max(flops / PEAKS[dtype], nbytes / PEAKS["bytes_per_s"])
