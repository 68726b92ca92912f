"""Plain PyTorch reference of HR-VITON's unpaired try-on (Lee et al., ECCV
2022, arXiv:2206.14180; the released ``test_generator.py``), written for the
benchmark from the published architecture. It imports nothing of the program
under test and takes nothing it made: the weights and the compact batches
are the benchmark's, and everything else (the batch's expansion, the
condition stage, the SPADE noise) is worked out here again.

Layout: NCHW float32. Weights are a flat dict of tensors keyed by the names
``param_specs`` lists (one name space with the program's modules, so the
benchmark hands both the same values). Every model convolution goes through
``Precision.conv``: ``"f32"`` is float32 with TF32 off (the reference),
``"tf32"`` and ``"fp8"`` are the lower precisions the controls compute in
(TF32 on the card, TF32 rounding of both operands on the CPU; fp8 e4m3
rounding of both operands with one scale a tensor). The Gaussian blur is
float32 in every mode, as the program keeps it.

The pieces, in the order of a request:

- ``expand``: the compact uint8 batch to the model inputs
  (u8 * (2/255) - 1; the 13-way one-hot of the agnostic parse; the 0/1 mask);
- ``condition``: resizes to the condition size, the condition generator
  (appearance flows and segmentation), the cloth-mask composition, the
  bilinear lift to full size, the 15x15 Gaussian blur (sigma 3), argmax and
  the 13 -> 7 regrouping (``labels_of``), the full-size flow warp of cloth
  and mask;
- ``generator``: the SPADE (ALIAS) generator with its per-norm noise;
- ``noise_fields``: the noise as the program draws it from its seed.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["Precision", "param_specs", "tocg_specs", "generator_specs",
           "expand", "condition", "generator", "noise_shapes",
           "noise_fields", "tryon", "labels_of", "Outputs", "LUT_13_TO_7",
           "NHIDDEN"]

NHIDDEN = 128            # SPADE's hidden width (network_generator.py:85)
# 13 training labels -> 7 SPADE groups (test_generator.py:188-196):
# background; paste {2, 4, 7, 8, 9, 10, 11}; upper 3; hair 1; left arm 5;
# right arm 6; noise 12
LUT_13_TO_7 = (0, 3, 1, 2, 1, 4, 5, 1, 1, 1, 1, 1, 6)
_FP8_MAX = 448.0         # largest finite float8_e4m3fn


class Spec(NamedTuple):
    name: str
    shape: tuple
    kind: str            # how the benchmark draws it (benchmark/inputs.py)


# -- parameter names and shapes ------------------------------------------------

def _conv(out, name, cout, cin, k, bias, kind):
    out.append(Spec(f"{name}.weight", (cout, cin, k, k), kind))
    if bias:
        out.append(Spec(f"{name}.bias", (cout,), "bias"))


def _bn(out, name, c):
    for p, kind in (("weight", "bn_weight"), ("bias", "bn_bias"),
                    ("running_mean", "bn_mean"), ("running_var", "bn_var")):
        out.append(Spec(f"{name}.{p}", (c,), kind))


def _resblock(out, name, cin, cout, scale):
    """ResBlock with BatchNorm (networks.py:171-198): the convs that a norm
    follows carry no bias."""
    if scale == "down":
        _conv(out, f"{name}.scale_conv", cout, cin, 3, False, "tocg_conv")
    else:
        _conv(out, f"{name}.scale_conv", cout, cin, 1, True, "tocg_conv")
    _conv(out, f"{name}.conv1", cout, cout, 3, False, "tocg_conv")
    _conv(out, f"{name}.conv2", cout, cout, 3, False, "tocg_conv")
    _bn(out, f"{name}.norm1", cout)
    _bn(out, f"{name}.norm2", cout)


def _tocg_widths(ngf):
    return [ngf, ngf * 2, ngf * 4, ngf * 4, ngf * 4], \
        [ngf * 4, ngf * 4, ngf * 2, ngf, ngf]


def tocg_specs(cfg) -> List[Spec]:
    """The condition generator's tensors (networks.py:13-159), T1 warp
    features, ReLU output layer, BatchNorm."""
    ngf, in1, in2, nout = (cfg["ngf"], cfg["input1_nc"], cfg["input2_nc"],
                           cfg["output_nc"])
    if (cfg["warp_feature"], cfg["out_layer"], cfg["norm"]) != ("T1", "relu", "batch"):
        raise ValueError("the reference holds warp_feature T1, out_layer relu, "
                         "norm batch")
    enc, seg = _tocg_widths(ngf)
    out: List[Spec] = []
    for name, cin in (("ClothEncoder", in1), ("PoseEncoder", in2)):
        for i, d in enumerate(enc):
            _resblock(out, f"{name}_{i}", cin if i == 0 else enc[i - 1], d, "down")
    _conv(out, "flow_conv_0", 2, ngf * 8, 3, True, "tocg_flow")
    _resblock(out, "conv", ngf * 4, ngf * 8, "same")
    _resblock(out, "SegDecoder_0", ngf * 8, seg[0], "up")
    for i in range(1, 5):
        j = 4 - i
        _conv(out, f"conv1_{j}", ngf * 4, enc[j], 1, True, "tocg_conv")
        _conv(out, f"conv2_{j}", ngf * 4, enc[j], 1, True, "tocg_conv")
        _conv(out, f"bottleneck_{i - 1}", ngf * 4, seg[i - 1], 3, True, "tocg_conv")
        _conv(out, f"flow_conv_{i}", 2, ngf * 8, 3, True, "tocg_flow")
        _resblock(out, f"SegDecoder_{i}", seg[i - 1] + enc[j] + ngf * 4, seg[i], "up")
    _resblock(out, "out_layer", seg[4] + in2 + in1, nout, "same")
    return out


def _gen_blocks(cfg):
    nf = cfg["ngf"]
    blocks = [("head_0", nf * 16, nf * 16), ("G_middle_0", nf * 16 + 16, nf * 16),
              ("G_middle_1", nf * 16 + 16, nf * 16), ("up_0", nf * 16 + 16, nf * 8),
              ("up_1", nf * 8 + 16, nf * 4), ("up_2", nf * 4 + 16, nf * 2),
              ("up_3", nf * 2 + 16, nf)]
    if cfg["num_upsampling_layers"] == "most":
        blocks.append(("up_4", nf + 16, nf // 2))
    elif cfg["num_upsampling_layers"] != "more":
        raise ValueError(cfg["num_upsampling_layers"])
    return blocks


def _spade_norm(out, name, nc, label_nc):
    out.append(Spec(f"{name}.noise_scale", (nc,), "noise_scale"))
    _conv(out, f"{name}.conv_shared", NHIDDEN, label_nc, 3, True, "gen_shared")
    _conv(out, f"{name}.conv_gamma", nc, NHIDDEN, 3, True, "gen_modulation")
    _conv(out, f"{name}.conv_beta", nc, NHIDDEN, 3, True, "gen_modulation")


def _spectral(out, name, cout, cin, k, bias):
    _conv(out, name, cout, cin, k, bias, "gen_spectral")
    out.append(Spec(f"{name}.u", (cout,), "sn_u"))
    out.append(Spec(f"{name}.v", (cin * k * k,), "sn_v"))


def generator_specs(cfg) -> List[Spec]:
    """The SPADE generator's tensors (network_generator.py:125-245),
    'spectralaliasinstance' norms."""
    if cfg["norm_G"] != "spectralaliasinstance":
        raise ValueError("the reference holds norm_G spectralaliasinstance")
    nf, sem, nin = cfg["ngf"], cfg["gen_semantic_nc"], cfg["input_nc"]
    out: List[Spec] = []
    for i in range(8):
        _conv(out, f"conv_{i}", nf * 16 if i == 0 else 16, nin, 3, True,
              "gen_feature")
    for name, cin, cout in _gen_blocks(cfg):
        middle = min(cin, cout)
        if cin != cout:
            _spade_norm(out, f"{name}.norm_s", cin, sem)
            _spectral(out, f"{name}.conv_s", cout, cin, 1, False)
        _spade_norm(out, f"{name}.norm_0", cin, sem)
        _spectral(out, f"{name}.conv_0", middle, cin, 3, True)
        _spade_norm(out, f"{name}.norm_1", middle, sem)
        _spectral(out, f"{name}.conv_1", cout, middle, 3, True)
    _conv(out, "conv_img", 3, _gen_blocks(cfg)[-1][2], 3, True, "gen_img")
    return out


def param_specs(config) -> Dict[str, List[Spec]]:
    return {"tocg": tocg_specs(config["tocg"]),
            "generator": generator_specs(config["generator"])}


# -- precision -------------------------------------------------------------------

def _round_mantissa(t: torch.Tensor, bits: int) -> torch.Tensor:
    """float32 rounded to ``bits`` explicit mantissa bits (to nearest)."""
    i = t.contiguous().view(torch.int32)
    drop = 23 - bits
    i = (i + (1 << (drop - 1))) & ~((1 << drop) - 1)
    return i.view(torch.float32)


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp_min(1e-30) / _FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Precision:
    """How the model convolutions compute: ``"f32"`` (TF32 off), ``"tf32"``,
    ``"fp8"`` (module docstring)."""

    MODES = ("f32", "tf32", "fp8")

    def __init__(self, mode: str = "f32"):
        if mode not in self.MODES:
            raise ValueError(f"precision {mode!r}: one of {self.MODES}")
        self.mode = mode

    def conv(self, x, w, b=None, stride=1, padding=0):
        if self.mode == "fp8":
            x, w = _fp8(x), _fp8(w)
        elif self.mode == "tf32" and x.device.type == "cpu":
            x, w = _round_mantissa(x, 10), _round_mantissa(w, 10)
        with _tf32(self.mode == "tf32" and x.device.type == "cuda"):
            return F.conv2d(x, w, b, stride, padding)


@contextlib.contextmanager
def _tf32(on: bool):
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = on
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


# -- small ops --------------------------------------------------------------------

def _resize(x, size, mode):
    """F.interpolate with the reference's settings: bilinear without
    align_corners, nearest with its floor rule."""
    if tuple(size) == tuple(x.shape[2:]):
        return x
    if mode == "nearest":
        return F.interpolate(x, size=tuple(size), mode="nearest")
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)


def _grid(n, h, w, device):
    """Identity sampling grid (N, H, W, 2), endpoints inclusive."""
    gy, gx = torch.meshgrid(torch.linspace(-1.0, 1.0, h, device=device),
                            torch.linspace(-1.0, 1.0, w, device=device),
                            indexing="ij")
    return torch.stack([gx, gy], dim=-1)[None].expand(n, h, w, 2)


def _warp(x, flow, norm_w, norm_h):
    """Border-padded bilinear warp of NCHW x by an NCHW pixel flow
    normalized by (norm_w, norm_h) on the inclusive identity grid."""
    n, _, h, w = flow.shape
    grid = _grid(n, h, w, x.device) + torch.stack(
        [flow[:, 0] / norm_w, flow[:, 1] / norm_h], dim=-1)
    return F.grid_sample(x, grid, mode="bilinear", padding_mode="border",
                         align_corners=False)


def _blur(x, ksize=15, sigma=3.0):
    """Separable Gaussian blur per channel (torchgeometry's): zero padding,
    normalized exp(-d^2 / 2 sigma^2), float32 with TF32 off."""
    d = torch.arange(ksize, dtype=torch.float64) - ksize // 2
    g = torch.exp(-d ** 2 / (2 * sigma ** 2))
    g = (g / g.sum()).to(torch.float32).to(x.device)
    c = x.shape[1]
    with _tf32(False):
        x = F.conv2d(x, g.view(1, 1, ksize, 1).expand(c, 1, ksize, 1),
                     padding=(ksize // 2, 0), groups=c)
        return F.conv2d(x, g.view(1, 1, 1, ksize).expand(c, 1, 1, ksize),
                        padding=(0, ksize // 2), groups=c)


def _onehot(labels, n):
    """(N, H, W) int labels -> (N, n, H, W) float one-hot."""
    return F.one_hot(labels.long(), n).permute(0, 3, 1, 2).float()


# -- the condition generator --------------------------------------------------------

def _batchnorm(p, name, x, eps=1e-5):
    v = lambda s: p[f"{name}.{s}"].float().view(1, -1, 1, 1)
    return (x - v("running_mean")) / torch.sqrt(v("running_var") + eps) * \
        v("weight") + v("bias")


def _w(p, name):
    return p[f"{name}.weight"].float(), (p[f"{name}.bias"].float()
                                         if f"{name}.bias" in p else None)


def _res(pc, p, name, x, scale):
    if scale == "up":
        x = _resize(x, (x.shape[2] * 2, x.shape[3] * 2), "bilinear")
    w, b = _w(p, f"{name}.scale_conv")
    r = pc.conv(x, w, b, 2, 1) if scale == "down" else pc.conv(x, w, b)
    y = F.relu(_batchnorm(p, f"{name}.norm1",
                          pc.conv(r, _w(p, f"{name}.conv1")[0], None, 1, 1)))
    y = _batchnorm(p, f"{name}.norm2",
                   pc.conv(y, _w(p, f"{name}.conv2")[0], None, 1, 1))
    return F.relu(r + y)


def _level_norm(h, w):
    return (w / 2 - 1.0) / 2.0, (h / 2 - 1.0) / 2.0


def tocg(pc: Precision, p, cfg, input1, input2):
    """(flows, seg, warped cloth, warped mask) at the condition size, NCHW;
    flows[i] in pixels of its level (networks.py:100-159)."""
    conv = lambda name, x, pad=0: pc.conv(x, *_w(p, name), 1, pad)
    e1, e2 = [], []
    h1, h2 = input1, input2
    for i in range(5):
        h1 = _res(pc, p, f"ClothEncoder_{i}", h1, "down")
        h2 = _res(pc, p, f"PoseEncoder_{i}", h2, "down")
        e1.append(h1)
        e2.append(h2)
    flows = []
    for i in range(5):
        feat1, feat2 = e1[4 - i], e2[4 - i]
        ih, iw = feat1.shape[2:]
        if i == 0:
            t1, t2 = feat1, feat2
            flow = conv("flow_conv_0", torch.cat([t1, t2], 1), 1)
            x = _res(pc, p, "SegDecoder_0", _res(pc, p, "conv", t2, "same"), "up")
        else:
            up2 = lambda t: _resize(t, (t.shape[2] * 2, t.shape[3] * 2), cfg["upsample"])
            t1 = up2(t1) + conv(f"conv1_{4 - i}", feat1)
            t2 = up2(t2) + conv(f"conv2_{4 - i}", feat2)
            flow_up = _resize(flow, (ih, iw), cfg["upsample"])
            warped_t1 = _warp(t1, flow_up, *_level_norm(ih, iw))
            bott = F.relu(conv(f"bottleneck_{i - 1}", x, 1))
            flow = flow_up + conv(f"flow_conv_{i}",
                                  torch.cat([warped_t1, bott], 1), 1)
            x = _res(pc, p, f"SegDecoder_{i}",
                     torch.cat([x, feat2, warped_t1], 1), "up")
        flows.append(flow)
    ih, iw = input1.shape[2:]
    flow_full = _resize(flows[-1], (ih, iw), cfg["upsample"])
    warped1 = _warp(input1, flow_full, *_level_norm(ih, iw))
    seg = _res(pc, p, "out_layer", torch.cat([x, input2, warped1], 1), "same")
    return flows, seg, warped1[:, :-1], warped1[:, -1:]


# -- the SPADE generator ----------------------------------------------------------

def _spade(pc, p, name, x, seg, noise):
    xn = x + noise * p[f"{name}.noise_scale"].float().view(1, -1, 1, 1)
    mean = xn.mean(dim=(2, 3), keepdim=True)
    var = (xn - mean).square().mean(dim=(2, 3), keepdim=True)
    normalized = (xn - mean) / torch.sqrt(var + 1e-5)
    actv = F.relu(pc.conv(seg, *_w(p, f"{name}.conv_shared"), 1, 1))
    gamma = pc.conv(actv, *_w(p, f"{name}.conv_gamma"), 1, 1)
    beta = pc.conv(actv, *_w(p, f"{name}.conv_beta"), 1, 1)
    return normalized * (1 + gamma) + beta


def _sn_weight(p, name):
    """W / sigma, sigma = u . (W v) from the stored u and v."""
    w = p[f"{name}.weight"].float()
    with _tf32(False):
        sigma = torch.dot(p[f"{name}.u"].float(),
                          w.reshape(w.shape[0], -1) @ p[f"{name}.v"].float())
    return w / sigma


def _spade_block(pc, p, name, x, seg, noise, learned):
    leaky = lambda t: F.leaky_relu(t, 0.2)
    if learned:
        xs = pc.conv(_spade(pc, p, f"{name}.norm_s", x, seg, next(noise)),
                     _sn_weight(p, f"{name}.conv_s"))
    else:
        xs = x
    b0 = p[f"{name}.conv_0.bias"].float()
    b1 = p[f"{name}.conv_1.bias"].float()
    dx = pc.conv(leaky(_spade(pc, p, f"{name}.norm_0", x, seg, next(noise))),
                 _sn_weight(p, f"{name}.conv_0"), b0, 1, 1)
    dx = pc.conv(leaky(_spade(pc, p, f"{name}.norm_1", dx, seg, next(noise))),
                 _sn_weight(p, f"{name}.conv_1"), b1, 1, 1)
    return xs + dx


def _latent(cfg, h, w):
    f = 2 ** (7 if cfg["num_upsampling_layers"] == "most" else 6)
    return h // f, w // f


def noise_shapes(cfg, n, h, w):
    """The (N, H, W, 1) noise fields of one forward, in the program's order:
    block by block at its scale, norm_s (a learned shortcut), norm_0, norm_1."""
    sh, sw = _latent(cfg, h, w)
    shapes = []
    for i, (_, cin, cout) in enumerate(_gen_blocks(cfg)):
        shape = (n, sh * 2 ** i, sw * 2 ** i, 1)
        shapes += [shape] * (3 if cin != cout else 2)
    return shapes


def noise_fields(cfg, n, h, w, noise_seed: int, device) -> List[torch.Tensor]:
    """The noise a batch of ``n`` gets: standard normals drawn in order from
    a generator on ``device`` seeded with ``noise_seed`` (the try-on
    pipeline's rule: one draw a batch size, reused)."""
    g = torch.Generator(device=device).manual_seed(noise_seed)
    return [torch.randn(s, generator=g, device=device, dtype=torch.float32)
            for s in noise_shapes(cfg, n, h, w)]


def generator(pc: Precision, p, cfg, x, labels, noise):
    """x (N, 9, H, W); labels (N, H, W) in [0, 7); noise: NHWC fields in
    ``noise_shapes`` order. Returns rgb (N, 3, H, W) in [-1, 1]."""
    sh, sw = _latent(cfg, x.shape[2], x.shape[3])
    fields = iter(t.permute(0, 3, 1, 2) for t in noise)
    blocks = _gen_blocks(cfg)
    h = None
    for i, (name, cin, cout) in enumerate(blocks):
        size = (sh * 2 ** i, sw * 2 ** i)
        feature = pc.conv(_resize(x, size, "nearest"), *_w(p, f"conv_{i}"), 1, 1)
        lab = _resize(labels[:, None].float(), size, "nearest")[:, 0]
        seg = _onehot(lab, cfg["gen_semantic_nc"])
        h = feature if h is None else torch.cat(
            [_resize(h, size, "nearest"), feature], 1)
        h = _spade_block(pc, p, name, h, seg, fields, cin != cout)
    return torch.tanh(pc.conv(F.leaky_relu(h, 0.2), *_w(p, "conv_img"), 1, 1))


# -- the request ---------------------------------------------------------------------

def expand(raw, device, datasetting="unpaired") -> Dict[str, torch.Tensor]:
    """The compact batch's model inputs, NCHW float32 on ``device``."""
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(device)
    img = lambda a: (t(a).float() * np.float32(2.0 / 255.0) - 1.0).permute(0, 3, 1, 2)
    return {"cloth": img(raw["cloth"][datasetting]),
            "cloth_mask": t(raw["cloth_mask"][datasetting]).float().permute(0, 3, 1, 2),
            "parse_agnostic": _onehot(t(raw["parse_agnostic_idx"]), 13),
            "densepose": img(raw["densepose"]),
            "agnostic": img(raw["agnostic"])}


class Outputs(NamedTuple):
    rgb: torch.Tensor            # (N, H, W, 3)
    warped_cloth: torch.Tensor   # (N, H, W, 3)
    gauss: torch.Tensor          # (N, H, W, 13) blurred segmentation logits
    labels: torch.Tensor         # (N, H, W) SPADE groups


def condition(pc: Precision, p, config, batch):
    """The condition stage at the fine size: (warped cloth NCHW, blurred
    13-way segmentation logits NCHW, the 7-way labels (N, H, W))."""
    pcfg = config["pipeline"]
    ch, cw = pcfg["cond_height"], pcfg["cond_width"]
    fh, fw = pcfg["fine_height"], pcfg["fine_width"]
    cloth = batch["cloth"]
    cm = (batch["cloth_mask"] > 0.5).float()
    input1 = torch.cat([_resize(cloth, (ch, cw), "bilinear"),
                        _resize(cm, (ch, cw), "nearest")], 1)
    input2 = torch.cat([_resize(batch["parse_agnostic"], (ch, cw), "nearest"),
                        _resize(batch["densepose"], (ch, cw), "bilinear")], 1)
    flows, seg, _, warped_cm = tocg(pc, p, config["tocg"], input1, input2)
    if pcfg["clothmask_composition"] != "warp_grad" or pcfg["occlusion"]:
        raise ValueError("the reference holds warp_grad composition, no occlusion")
    seg = torch.cat([seg[:, :3], seg[:, 3:4] * warped_cm, seg[:, 4:]], 1)
    gauss = _blur(_resize(seg, (fh, fw), "bilinear"))
    labels = labels_of(gauss, dim=1)
    flow = _resize(flows[-1], (fh, fw), "bilinear")
    # the full-size warp keeps the condition grid's constants (96, 128)
    warped = _warp(torch.cat([cloth, cm], 1), flow, (96 - 1.0) / 2.0,
                   (128 - 1.0) / 2.0)
    return warped[:, :3], gauss, labels


def labels_of(gauss, dim=-1):
    """argmax of the blurred logits (the first of equal ones), regrouped
    13 -> 7."""
    lut = torch.tensor(LUT_13_TO_7, device=gauss.device)
    return lut[gauss.float().argmax(dim=dim)]


def tryon(weights, config, raw, noise_seed: int, device, mode: str = "f32",
          given=None) -> Outputs:
    """The unpaired try-on of one compact batch with ``weights``
    ({"tocg": {...}, "generator": {...}}), one image at a time (the noise
    drawn for the whole batch, as the program draws it). ``given``:
    (warped cloth (N, H, W, 3), labels (N, H, W)) of another run, which the
    generator is fed in place of this run's own condition outputs (which
    are still returned)."""
    pc = Precision(mode)
    pcfg = config["pipeline"]
    n = raw["image"].shape[0]
    nchw = lambda t: t.permute(0, 3, 1, 2)
    with torch.no_grad():
        fields = noise_fields(config["generator"], n, pcfg["fine_height"],
                              pcfg["fine_width"], noise_seed, device)
        outs = []
        for lo in range(n):
            sl = slice(lo, lo + 1)
            part = {k: ({kk: vv[sl] for kk, vv in v.items()}
                        if isinstance(v, dict) else v[sl]) for k, v in raw.items()}
            batch = expand(part, device)
            warped, gauss, labels = condition(pc, weights["tocg"], config, batch)
            if given is None:
                g_warped, g_labels = warped, labels
            else:
                g_warped = nchw(given[0][sl]).to(device, torch.float32)
                g_labels = given[1][sl].to(device)
            x = torch.cat([batch["agnostic"], batch["densepose"], g_warped], 1)
            rgb = generator(pc, weights["generator"], config["generator"], x,
                            g_labels, [f[sl] for f in fields])
            nhwc = lambda t: t.permute(0, 2, 3, 1).cpu()
            outs.append((nhwc(rgb), nhwc(warped), nhwc(gauss), labels.cpu()))
            del batch, warped, gauss, labels, x, rgb, g_warped, g_labels
    return Outputs(*(torch.cat(parts) for parts in zip(*outs)))
