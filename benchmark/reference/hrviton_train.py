"""Plain PyTorch reference of HR-VITON's stage-2 training step (Lee et al.,
ECCV 2022, arXiv:2206.14180; the released ``train_generator.py``), written
for the benchmark from the published description. It imports nothing of the
program under test; the try-on reference (``reference/hrviton.py``) gives
the conditioning and the SPADE norm.

One step, on a batch and the state before it:

- the conditioning, with no gradient: the batch expanded (the paired cloth),
  the condition generator, the lift to full size, the blur, argmax and the
  13 -> 7 regrouping (``hrviton.condition``);
- the G update: the SPADE generator's forward with one power iteration in
  every spectral conv (v <- l2(W^T u), u <- l2(W v), sigma = u . W v, in
  float32, the gradient flowing through u and v), the multiscale
  discriminator on (parse, fake) and (parse, real) from its stored u/v,
  the losses hinge + 10 x feature matching + 10 x VGG19 (relu1_1 to
  relu5_1, weights 1/32, 1/16, 1/8, 1/4, 1), the gradient with respect to
  G's parameters, Adam(0, 0.9) at 1e-4 (eps 1e-8 outside the root, bias
  corrected), G's new u/v;
- the D update: the updated G's output again, with no gradient, from its
  new u/v and the second noise fields; the discriminator with one power
  iteration on (parse, fake) and (parse, real); the hinge losses, the
  gradient with respect to D's parameters, Adam(0, 0.9) at 4e-4, D's new
  u/v.

Layout: NCHW float32; every model convolution goes through ``Precision``:
``"f32"`` is float32 with TF32 off, ``"tf32"`` and ``"fp8"`` (the
controls) round both operands of each convolution (TF32's 10 mantissa bits;
fp8 e4m3 with one scale a tensor, ``hrviton.py``'s rules) and, in the
backward, the gradient entering it and the gradients it gives, so that the
backward computes one precision down too (TF32 by rounding on the card as
well: cuDNN's TF32 switch would leave the backward in float32). The power
iterations and the losses are float32 in every mode. Parameters are flat dicts keyed as the program's modules name them
(``param_specs``); an Adam state is ``Opt`` (moments keyed the same, the
count of updates taken).

Departures from the released script, each the program's too:

- the conditioning is the try-on reference's (frozen tocg in eval mode,
  warp_grad composition, no occlusion), fed the paired cloth; the released
  command's ``--occlusion`` is not held (the configuration runs without it,
  its ``assumed``);
- the two discriminator calls of the released script are one call on the
  batch of fake and real: its instance norms are per sample, so each image
  gets the same maps; in the D update the power iteration runs once for
  both;
- the learning rates follow the linear decay's multiplier of the update's
  count (1 before ``keep_step``);
- the batch runs one sample at a time (``hrviton.py``'s rule, so that a
  full-size step fits beside the program's leftovers): every loss is a mean
  over equal-size samples, and the gradients are the samples' gradients of
  their losses over the batch size, summed, which is the batch's gradient
  exactly.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import hrviton as ref
from benchmark.reference.hrviton import Spec, _conv, _tf32

__all__ = ["Precision", "param_specs", "discriminator_specs", "vgg_specs", "Opt",
           "expand", "conditioning", "generator", "discriminator", "vgg19",
           "g_step", "d_step", "train_step", "adam", "lr_multiplier",
           "spectral_names", "samples", "VGG_WEIGHTS"]

VGG_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)
_VGG_STAGES = ((64, 2), (128, 2), (256, 4), (512, 4), (512, 1))
_SN_EPS = 1e-12          # the spectral norm's eps in l2
_IN_EPS = 1e-5           # the instance norms'


# -- parameter names and shapes ------------------------------------------------

def discriminator_specs(cfg) -> List[Spec]:
    """The SPADE multiscale discriminator (network_generator.py:250-316):
    per scale a leaky 4x4/2 conv, ``n_layers_D - 1`` spectral bias-free
    4x4/2 convs each with an affine-free instance norm and a leaky ReLU,
    and a 4x4/1 conv to one channel; padding 2 throughout."""
    if cfg["norm_D"] != "spectralinstance":
        raise ValueError("the reference holds norm_D spectralinstance")
    out: List[Spec] = []
    for i in range(cfg["num_D"]):
        name = f"discriminator_{i}"
        nf = cfg["ndf"]
        _conv(out, f"{name}.layer0_conv", nf, cfg["input_nc"], 4, True, "dis_conv")
        for n in range(1, cfg["n_layers_D"]):
            nf_prev, nf = nf, min(nf * 2, 512)
            _conv(out, f"{name}.layer{n}_conv", nf, nf_prev, 4, False,
                  "dis_spectral")
            out.append(Spec(f"{name}.layer{n}_conv.u", (nf,), "sn_u"))
            out.append(Spec(f"{name}.layer{n}_conv.v", (nf_prev * 16,), "sn_v"))
        _conv(out, f"{name}.layer{cfg['n_layers_D']}_conv", 1, nf, 4, True,
              "dis_conv")
    return out


def vgg_specs() -> List[Spec]:
    """VGG19's convs through conv5_1 (networks.py:201-231)."""
    out: List[Spec] = []
    cin = 3
    for s, (cout, n) in enumerate(_VGG_STAGES, start=1):
        for j in range(1, n + 1):
            _conv(out, f"conv{s}_{j}", cout, cin, 3, True, "vgg_conv")
            cin = cout
    return out


def param_specs(config) -> Dict[str, List[Spec]]:
    return {"tocg": ref.tocg_specs(config["tocg"]),
            "generator": ref.generator_specs(config["generator"]),
            "discriminator": discriminator_specs(config["discriminator"]),
            "vgg": vgg_specs()}


def spectral_names(params: Dict[str, torch.Tensor]) -> List[str]:
    """The spectral convs of a network's parameter dict (those with a u)."""
    return [k[:-len(".u")] for k in params if k.endswith(".u")]


# -- precision -------------------------------------------------------------------

def _round(t, mode: str):
    if mode == "fp8":
        return ref._fp8(t.float())
    if mode == "tf32":
        return ref._round_mantissa(t.float(), 10)
    return t


class _Rounded(torch.autograd.Function):
    """t rounded in ``mode``; its gradient rounded the same way."""

    @staticmethod
    def forward(ctx, t, mode):
        ctx.mode = mode
        return _round(t, mode)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.mode), None


class _GradRounded(torch.autograd.Function):
    """t as it is; the gradient entering it rounded in ``mode``."""

    @staticmethod
    def forward(ctx, t, mode):
        ctx.mode = mode
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.mode), None


class Precision(ref.Precision):
    """How the model convolutions compute, forward and backward (module
    docstring)."""

    def conv(self, x, w, b=None, stride=1, padding=0):
        if self.mode != "f32":
            x, w = _Rounded.apply(x, self.mode), _Rounded.apply(w, self.mode)
        with _tf32(False):
            y = F.conv2d(x, w, b, stride, padding)
        return y if self.mode == "f32" else _GradRounded.apply(y, self.mode)


# -- pieces ----------------------------------------------------------------------

def _l2(t):
    return t / (torch.linalg.vector_norm(t) + _SN_EPS)


def _spectral(p, name, update: bool):
    """(W / sigma, new u, new v): one power iteration from the stored u with
    ``update`` (the gradient through u and v), else sigma from the stored
    u/v (new u, v None)."""
    w = p[f"{name}.weight"].float()
    wm = w.reshape(w.shape[0], -1)
    with _tf32(False):
        if update:
            v = _l2(p[f"{name}.u"].float() @ wm)
            u = _l2(wm @ v)
        else:
            u, v = p[f"{name}.u"].float(), p[f"{name}.v"].float()
        sigma = torch.dot(u, wm @ v)
    new = (u.detach(), v.detach()) if update else (None, None)
    return w / sigma, *new


def _instance_norm(x):
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
    return (x - mean) / torch.sqrt(var + _IN_EPS)


def expand(raw, device) -> Dict[str, torch.Tensor]:
    """A compact training batch's model inputs, NCHW float32: the paired
    cloth, its mask, the agnostic parse's one-hot, densepose, the agnostic
    image and the person image."""
    out = ref.expand(raw, device, datasetting="paired")
    t = torch.as_tensor(raw["image"]).to(device)
    out["image"] = (t.float() * np.float32(2.0 / 255.0) - 1.0).permute(0, 3, 1, 2)
    return out


def conditioning(pc: Precision, tocg_p, config, batch):
    """(the generator's input (N, 9, H, W), the one-hot parse (N, 7, H, W),
    the labels (N, H, W)), with no gradient."""
    with torch.no_grad():
        warped, _, labels = ref.condition(pc, tocg_p, config, batch)
        x = torch.cat([batch["agnostic"], batch["densepose"], warped], 1)
        return x, ref._onehot(labels, config["generator"]["gen_semantic_nc"]), labels


def generator(pc: Precision, p, cfg, x, labels, noise, update: bool):
    """The SPADE generator (``hrviton.generator``) with its spectral convs
    from ``_spectral``: (rgb (N, 3, H, W), {conv: (new u, new v)})."""
    sh, sw = ref._latent(cfg, x.shape[2], x.shape[3])
    fields = iter(t.permute(0, 3, 1, 2) for t in noise)
    leaky = lambda t: F.leaky_relu(t, 0.2)
    new = {}

    def sn(name):
        w, u, v = _spectral(p, name, update)
        new[name] = (u, v)
        return w
    h = None
    for i, (name, cin, cout) in enumerate(ref._gen_blocks(cfg)):
        size = (sh * 2 ** i, sw * 2 ** i)
        feature = pc.conv(ref._resize(x, size, "nearest"), *ref._w(p, f"conv_{i}"),
                          1, 1)
        lab = ref._resize(labels[:, None].float(), size, "nearest")[:, 0]
        seg = ref._onehot(lab, cfg["gen_semantic_nc"])
        h = feature if h is None else torch.cat(
            [ref._resize(h, size, "nearest"), feature], 1)
        if cin != cout:
            xs = pc.conv(ref._spade(pc, p, f"{name}.norm_s", h, seg, next(fields)),
                         sn(f"{name}.conv_s"))
        else:
            xs = h
        dx = pc.conv(leaky(ref._spade(pc, p, f"{name}.norm_0", h, seg, next(fields))),
                     sn(f"{name}.conv_0"), p[f"{name}.conv_0.bias"].float(), 1, 1)
        dx = pc.conv(leaky(ref._spade(pc, p, f"{name}.norm_1", dx, seg, next(fields))),
                     sn(f"{name}.conv_1"), p[f"{name}.conv_1.bias"].float(), 1, 1)
        h = xs + dx
    rgb = torch.tanh(pc.conv(leaky(h), *ref._w(p, "conv_img"), 1, 1))
    return rgb, new


def discriminator(pc: Precision, p, cfg, x, update: bool):
    """The multiscale discriminator on x (N, 10, H, W): (per scale the list
    of its maps, the logits last; {conv: (new u, new v)})."""
    new = {}
    result, h = [], x
    n_layers = cfg["n_layers_D"]
    for i in range(cfg["num_D"]):
        name = f"discriminator_{i}"
        y = F.leaky_relu(pc.conv(h, *ref._w(p, f"{name}.layer0_conv"), 2, 2), 0.2)
        maps = [y]
        for n in range(1, n_layers):
            w, u, v = _spectral(p, f"{name}.layer{n}_conv", update)
            new[f"{name}.layer{n}_conv"] = (u, v)
            y = F.leaky_relu(_instance_norm(pc.conv(y, w, None, 2, 2)), 0.2)
            maps.append(y)
        maps.append(pc.conv(y, *ref._w(p, f"{name}.layer{n_layers}_conv"), 1, 2))
        result.append(maps)
        if i != cfg["num_D"] - 1:
            h = F.avg_pool2d(h, 3, 2, 1, count_include_pad=False)
    return result, new


def vgg19(pc: Precision, p, x) -> List[torch.Tensor]:
    """VGG19's relu1_1 ... relu5_1 of x in [-1, 1] (no renormalisation, as
    the released loss feeds it); 2x2 max pools between the stages."""
    taps, h = [], x
    for s, (_, n) in enumerate(_VGG_STAGES, start=1):
        if s > 1:
            h = F.max_pool2d(h, 2, 2)
        for j in range(1, n + 1):
            h = F.relu(pc.conv(h, *ref._w(p, f"conv{s}_{j}"), 1, 1))
            if j == 1:
                taps.append(h)
    return taps


def _mean_over_scales(maps, fn):
    return sum(fn(scale[-1]) for scale in maps) / len(maps)


class Opt(NamedTuple):
    """A network's Adam state: the moments keyed as its parameters, and the
    number of updates taken."""
    exp_avg: Dict[str, torch.Tensor]
    exp_avg_sq: Dict[str, torch.Tensor]
    count: int


def lr_multiplier(train, count: int) -> float:
    """The linear decay's multiplier of update ``count`` (counted from 0),
    stepped once per 1000 updates (train_generator.py:154-159)."""
    s = (count // 1000) * 1000
    return 1.0 - max((s - train["keep_step"]) / float(train["decay_step"] + 1), 0.0)


def adam(params, grads, opt: Opt, lr: float, b1: float, b2: float,
         eps: float = 1e-8):
    """One Adam update of the parameters named in ``grads``: (new
    parameters, new ``Opt``); every other entry of ``params`` (u, v) is
    passed through."""
    t = opt.count + 1
    out, m_out, v_out = dict(params), {}, {}
    for k, g in grads.items():
        g = g.float()
        m = b1 * opt.exp_avg[k].float() + (1.0 - b1) * g
        v = b2 * opt.exp_avg_sq[k].float() + (1.0 - b2) * g * g
        m_hat = m / (1.0 - b1 ** t)
        v_hat = v / (1.0 - b2 ** t)
        out[k] = params[k].float() - lr * m_hat / (torch.sqrt(v_hat) + eps)
        m_out[k], v_out[k] = m, v
    return out, Opt(m_out, v_out, t)


def samples(raw):
    """The compact batch one sample at a time."""
    for s in range(raw["image"].shape[0]):
        yield {k: ({kk: vv[s:s + 1] for kk, vv in v.items()}
                   if isinstance(v, dict) else v[s:s + 1]) for k, v in raw.items()}


def _trainable(params):
    return {k: v.detach().float().clone().requires_grad_(True)
            for k, v in params.items() if not k.endswith((".u", ".v"))}


def _buffers(params):
    return {k: v.detach().float() for k, v in params.items()
            if k.endswith((".u", ".v"))}


def _with_new_uv(params, new):
    out = {k: v.detach() for k, v in params.items()}
    for name, (u, v) in new.items():
        if u is not None:
            out[f"{name}.u"], out[f"{name}.v"] = u, v
    return out


def g_step(frozen, g_params, g_opt: Opt, d_params, raw, fields, config,
           device, mode: str = "f32", cond=None) -> Dict:
    """The G update (module docstring) from ``g_params`` (with u/v), its
    Adam state and the discriminator ``d_params``; ``raw`` the compact
    batch, ``fields`` the G forward's noise (NHWC, ``hrviton.noise_shapes``
    order); ``cond``: each sample's conditioning (``conditioning``'s
    triple), else computed here. Returns {"losses": {"GAN", "GAN_Feat",
    "VGG", "GAN_scale"} (GAN_scale: the fake logits' mean magnitude),
    "grads", "params" (the updated parameters with the new u/v), "opt",
    "cond" (each sample's conditioning, for ``d_step``), "fake" (G's output,
    (N, 3, H, W))}."""
    pc = Precision(mode)
    tr, gcfg, dcfg = config["train"], config["generator"], config["discriminator"]
    n = raw["image"].shape[0]
    leaves = _trainable(g_params)
    p = {**leaves, **_buffers(g_params)}
    dp = {k: v.detach().float() for k, v in d_params.items()}
    vp = {k: v.detach().float() for k, v in frozen["vgg"].items()}
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    sums = dict.fromkeys(("GAN", "GAN_Feat", "VGG", "GAN_scale"), 0.0)
    new, given, cond, fakes = {}, cond, [], []
    for s, part in enumerate(samples(raw)):
        batch = expand(part, device)
        x, parse7, labels = (conditioning(pc, frozen["tocg"], config, batch)
                             if given is None else given[s])
        cond.append((x, parse7, labels))
        fake, new = generator(pc, p, gcfg, x, labels,
                              [f[s:s + 1].to(device) for f in fields], True)
        fakes.append(fake.detach())
        pred_fake, _ = discriminator(pc, dp, dcfg, torch.cat([parse7, fake], 1),
                                     False)
        with torch.no_grad():
            pred_real, _ = discriminator(pc, dp, dcfg,
                                         torch.cat([parse7, batch["image"]], 1),
                                         False)
            real_taps = vgg19(pc, vp, batch["image"])
        gan = _mean_over_scales(pred_fake, lambda t: -t.mean())
        feat = 0.0
        for i in range(dcfg["num_D"]):
            for j in range(len(pred_fake[i]) - 1):
                feat = feat + (pred_fake[i][j] - pred_real[i][j]).abs().mean() \
                    * tr["lambda_feat"] / dcfg["num_D"]
        vgg = sum(w * (a - b).abs().mean() for w, a, b in
                  zip(VGG_WEIGHTS, vgg19(pc, vp, fake), real_taps)) * tr["lambda_vgg"]
        for k, g in zip(leaves, torch.autograd.grad(
                (gan + feat + vgg) / n, list(leaves.values()), allow_unused=True)):
            if g is not None:       # 'more' reads no conv_7
                grads[k] += g
        for k, v in (("GAN", gan), ("GAN_Feat", feat), ("VGG", vgg),
                     ("GAN_scale", _mean_over_scales(
                         pred_fake, lambda t: t.abs().mean()))):
            sums[k] += float(v.detach()) / n
        del batch, x, parse7, labels, fake, pred_fake, pred_real, real_taps
    lr = tr["G_lr"] * lr_multiplier(tr, g_opt.count)
    params, opt = adam(_with_new_uv(g_params, new), grads, g_opt, lr,
                       tr["beta1"], tr["beta2"])
    return {"losses": sums, "grads": grads, "params": params, "opt": opt,
            "cond": cond, "fake": torch.cat(fakes)}


def d_step(frozen, g_params, d_params, d_opt: Opt, raw, fields, config,
           device, mode: str = "f32", cond=None) -> Dict:
    """The D update (module docstring) from the updated generator
    ``g_params`` (its new u/v), ``d_params`` (with u/v) and its Adam state;
    ``fields`` the regeneration's noise; ``cond``: each sample's
    conditioning (``g_step``'s), else computed here. Returns {"losses":
    {"adv_fake", "adv_real"}, "grads", "params", "opt", "logits" (D's
    logits, a scale each, the fakes' (N, 1, h, w) then the reals')}."""
    pc = Precision(mode)
    tr, gcfg, dcfg = config["train"], config["generator"], config["discriminator"]
    n = raw["image"].shape[0]
    gp = {k: v.detach().float() for k, v in g_params.items()}
    leaves = _trainable(d_params)
    p = {**leaves, **_buffers(d_params)}
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    sums = {"adv_fake": 0.0, "adv_real": 0.0}
    new, logits = {}, []
    for s, part in enumerate(samples(raw)):
        batch = expand(part, device)
        x, parse7, labels = (conditioning(pc, frozen["tocg"], config, batch)
                             if cond is None else cond[s])
        with torch.no_grad():
            fake, _ = generator(pc, gp, gcfg, x, labels,
                                [f[s:s + 1].to(device) for f in fields], False)
        pred, new = discriminator(pc, p, dcfg, torch.cat(
            [torch.cat([parse7, fake], 1), torch.cat([parse7, batch["image"]], 1)]),
            True)
        l_fake = _mean_over_scales(
            pred, lambda t: -torch.clamp(-t[:1] - 1.0, max=0.0).mean())
        l_real = _mean_over_scales(
            pred, lambda t: -torch.clamp(t[1:] - 1.0, max=0.0).mean())
        for k, g in zip(leaves, torch.autograd.grad((l_fake + l_real) / n,
                                                    list(leaves.values()))):
            grads[k] += g
        logits.append([scale[-1].detach() for scale in pred])
        sums["adv_fake"] += float(l_fake.detach()) / n
        sums["adv_real"] += float(l_real.detach()) / n
        del batch, x, parse7, labels, fake, pred
    lr = tr["D_lr"] * lr_multiplier(tr, d_opt.count)
    params, opt = adam(_with_new_uv(d_params, new), grads, d_opt, lr,
                       tr["beta1"], tr["beta2"])
    by_scale = list(zip(*logits))
    return {"losses": sums, "grads": grads, "params": params, "opt": opt,
            "logits": ([torch.cat([t[:1] for t in s]) for s in by_scale]
                       + [torch.cat([t[1:] for t in s]) for s in by_scale])}


def train_step(frozen, g_params, g_opt: Opt, d_params, d_opt: Opt, raw,
               fields_g, fields_d, config, device, mode: str = "f32",
               cond=None):
    """The whole step: ``g_step``, then ``d_step`` on its updated G (both
    fed ``cond`` where it is given). Returns (the G update's result, the D
    update's)."""
    g = g_step(frozen, g_params, g_opt, d_params, raw, fields_g, config,
               device, mode, cond=cond)
    d = d_step(frozen, g["params"], d_params, d_opt, raw, fields_d, config,
               device, mode, cond=g.pop("cond"))
    return g, d
