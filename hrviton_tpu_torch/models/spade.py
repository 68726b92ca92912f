"""SPADE (ALIAS) image generator: stage 2 of HR-VITON.

Counterpart of ``hrviton_tpu/models/spade.py`` (reference
network_generator.py:75-245). Submodule names follow the JAX parameter
tree. Per-norm noise is injected in eval as well; it comes from a noise
source (see ``noise_source``) drawn in the JAX package's order: block by
block, and within a block norm_s, norm_0, norm_1.

Dispatch inside a block follows the JAX package. With ``fused_block``, at
eligible scales (``ops/spade_block.fused_spade_conv_eligible``: the up_3 and
up_4 blocks on a CUDA device, in bf16) each {SPADENorm -> act -> conv} pair
runs as one fused CUDA unit. Otherwise a block in the space-to-depth domain
(``s2d_tail``) runs the ``ops/s2d.py`` formulation; a norm that
``fast_spade`` admits (``ops/spade_fused.fused_spade_eligible``) runs the
fused modulation kernel; and everything else runs the plain modules, whose
3x3 convs go to the ``ops/conv3x3.py`` kernels where ``fast_conv`` or the
small-channel switch admits them. ``SPADEGenerator.forward`` enters
``fast_conv``, ``fast_spade`` and ``merge_gamma_beta`` from its config for the
length of the call and restores them after, so a knob of one generator never
reaches another model.

The SPADE norm kinds are the JAX package's three: 'aliasinstance',
'aliasbatch' (BatchNorm without affine: the batch's statistics under
``forward(..., train=True)``, staged) and 'aliasmask' (``MaskNorm`` on a
misalign mask, ``SPADEResBlock(use_mask_norm=True)``). Only
'aliasinstance' without a misalign mask reaches the fused kernels and the
s2d domain, as in the JAX package.

Training, as the JAX generator trains: ``forward(..., update_sn=True)``
runs one power iteration in every spectral conv (staged, see
``nn/layers.commit_state``); every parameter is read through
``core/precision.policy`` where it is used (the bf16 policy). With
``SPADEGenConfig.remat`` and gradients wanted, each block runs under
``torch.utils.checkpoint`` and is recomputed in backward. The recompute is
pure: the block's noise fields are drawn before it (in the same order) and
handed in, the staged spectral state is read from unchanged buffers, and
the config's knobs are entered again around it.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Sequence, Union

import torch
import torch.nn as nn
import torch.utils.checkpoint

from hrviton_tpu_torch.config import SPADEGenConfig
from hrviton_tpu_torch.core import graphs
from hrviton_tpu_torch.core.mesh import draw_rows
from hrviton_tpu_torch.core.precision import policy
from hrviton_tpu_torch.device import resolve_device
from hrviton_tpu_torch.nn.layers import (BatchNorm2d, Conv2d, InstanceNorm2d,
                                         SpectralNorm2d, conv_forward,
                                         instance_norm)
from hrviton_tpu_torch.ops.conv3x3 import fast_conv
from hrviton_tpu_torch.ops.parse import onehot
from hrviton_tpu_torch.ops.resize import interpolate_nchw
from hrviton_tpu_torch.ops.s2d import (concat_s2d, from_s2d, instance_norm_s2d,
                                       to_s2d, upsample2x_s2d)
from hrviton_tpu_torch.ops.spade_block import (fused_spade_conv_eligible,
                                               spade_conv_unit)
from hrviton_tpu_torch.ops.spade_fused import (fast_spade,
                                               fused_spade_eligible,
                                               fused_spade_modulate)

__all__ = ["MaskNorm", "SPADENorm", "SPADEResBlock", "SPADEGenerator",
           "noise_source", "enable_merge_gamma_beta", "merge_gamma_beta"]

_NHIDDEN = 128
_CL = torch.channels_last

# Merged gamma+beta modulation conv: one 3x3 conv with the two kernels
# concatenated on the output axis, split after. Exactly equivalent (each
# output channel sees the same taps) and the same parameters either way. Off
# by default (SPADEGenConfig.merge_gamma_beta, or this switch).
_MERGE_GB = False


def enable_merge_gamma_beta(on: bool = True) -> None:
    global _MERGE_GB
    _MERGE_GB = bool(on)


@contextlib.contextmanager
def merge_gamma_beta(on: bool = True):
    global _MERGE_GB
    prev = _MERGE_GB
    _MERGE_GB = bool(on)
    try:
        yield
    finally:
        _MERGE_GB = prev


graphs.register_state(lambda: _MERGE_GB)   # a dispatch switch: in every graph's key
NoiseArg = Union[torch.Generator, Callable, Sequence[torch.Tensor]]


def noise_source(noise: NoiseArg, device) -> Callable:
    """A callable ``draw(shape) -> float32 tensor`` for (B, H, W, 1) fields.

    ``noise`` is a ``torch.Generator`` (standard normals drawn on
    ``device``; inside ``core/mesh.sharded`` at the global batch's shape,
    the rank's rows kept), a callable taking the shape, or a sequence of
    tensors consumed in order (e.g. another implementation's draws)."""
    if isinstance(noise, torch.Generator):
        return lambda shape: draw_rows(
            lambda s: torch.randn(s, generator=noise, device=device,
                                  dtype=torch.float32), shape)
    if callable(noise):
        return noise
    it = iter(noise)

    def draw(shape):
        t = torch.as_tensor(next(it), dtype=torch.float32, device=device)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"noise of shape {tuple(t.shape)}, expected {shape}")
        return t
    return draw


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1).contiguous()


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def _nhwc_view(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


class MaskNorm(nn.Module):
    """MaskNorm (reference network_generator.py:52-72): the foreground and
    background regions of ``mask`` instance-normalized apart, each filled
    with its own mean outside it and rescaled by sqrt(num / (h * w)) (an
    empty region counts 1 pixel); the mask takes no gradient. x: (B, C, H,
    W); mask: (B, 1, H, W) in [0, 1]."""

    def forward(self, x, mask):
        mask = mask.detach()

        def region(r, m):
            h, w = r.shape[2], r.shape[3]
            num = m.sum(dim=(2, 3), keepdim=True)
            num = torch.where(num == 0, torch.ones_like(num), num)
            mu = r.sum(dim=(2, 3), keepdim=True) / num
            normalized = instance_norm(r + (1.0 - m) * mu)
            return normalized * torch.sqrt(num / (h * w))

        return region(x * mask, mask) + region(x * (1.0 - mask), 1.0 - mask)


_NORM_KINDS = ("aliasinstance", "aliasbatch", "aliasmask")


class SPADENorm(nn.Module):
    """SPADENorm 'alias*' (reference network_generator.py:75-122): the
    parameter-free norm ``param_free_norm`` of the kind, InstanceNorm,
    BatchNorm without affine (the batch's statistics with ``train``, the
    running ones without) or MaskNorm on the misalign mask. Only the
    instance kind reaches the fused modulation kernel and the s2d domain,
    as in the JAX package."""

    _jax_names = {"noise_scale": "noise_scale"}

    def __init__(self, norm_nc: int, label_nc: int,
                 norm_type: str = "aliasinstance", device="cuda",
                 dtype=torch.float32):
        super().__init__()
        if norm_type not in _NORM_KINDS:
            raise ValueError(f"SPADENorm {norm_type!r}: not one of {_NORM_KINDS}")
        dev = resolve_device(device)
        self.kind = norm_type[len("alias"):]
        kw = dict(init="xavier", device=dev, dtype=dtype)
        self.noise_scale = nn.Parameter(torch.zeros(norm_nc, device=dev,
                                                    dtype=dtype))
        if self.kind == "instance":
            self.param_free_norm = InstanceNorm2d()
        elif self.kind == "batch":
            self.param_free_norm = BatchNorm2d(norm_nc, affine=False,
                                               device=dev, dtype=dtype)
        else:
            self.param_free_norm = MaskNorm()
        self.conv_shared = Conv2d(label_nc, _NHIDDEN, 3, padding=1, **kw)
        self.conv_gamma = Conv2d(_NHIDDEN, norm_nc, 3, padding=1, **kw)
        self.conv_beta = Conv2d(_NHIDDEN, norm_nc, 3, padding=1, **kw)

    def forward(self, x, seg, draw, s2d: bool = False, misalign_mask=None,
                train: bool = False):
        """``misalign_mask``: (B, 1, H, W) at x's size (the mask kind);
        ``train``: the batch kind's batch statistics (staged)."""
        b, c, h, w = x.shape
        if s2d and self.kind != "instance":
            raise ValueError("the s2d domain runs the instance norm only")
        if s2d:
            # x and seg are space-to-depth tensors (ops/s2d.py): the same
            # math and parameters. The noise field is drawn at the plain
            # full-res shape, so its values match the plain path's.
            nc = c // 4
            noise2 = to_s2d(draw((b, 2 * h, 2 * w, 1)))
            noise = noise2.repeat_interleave(nc, dim=-1) * \
                policy(self.noise_scale).repeat(4)
            xn = x + _nchw(noise).to(x.dtype)
            normalized = _nchw(instance_norm_s2d(_nhwc_view(xn), nc))
            actv = self.conv_shared(seg, s2d=True)
            gamma = self.conv_gamma(actv, pre_act="relu", s2d=True)
            beta = self.conv_beta(actv, pre_act="relu", s2d=True)
            return normalized * (1.0 + gamma) + beta

        noise = draw((b, h, w, 1))
        if self.kind == "instance" and fused_spade_eligible(
                (b, h, w, c), _NHIDDEN, x.dtype, x.device):
            # the fused modulation kernel (ops/spade_fused.py): same math
            # and parameters; conv_shared's output stays pre-relu
            actv = self.conv_shared(seg)
            return _nchw(fused_spade_modulate(
                _nhwc(x), noise, policy(self.noise_scale), _nhwc(actv),
                policy(self.conv_gamma.weight), policy(self.conv_gamma.bias),
                policy(self.conv_beta.weight), policy(self.conv_beta.bias)))

        xn = x + (_nchw(noise) * policy(self.noise_scale).view(1, -1, 1, 1)
                  ).to(x.dtype)
        if self.kind == "instance":
            normalized = self.param_free_norm(xn)
        elif self.kind == "batch":
            normalized = self.param_free_norm(xn, train=train)
        else:
            normalized = self.param_free_norm(xn, misalign_mask)
        actv = self.conv_shared(seg)
        if _MERGE_GB:
            gb = conv_forward(
                actv,
                policy(torch.cat([self.conv_gamma.weight,
                                  self.conv_beta.weight])).to(x.dtype),
                policy(torch.cat([self.conv_gamma.bias, self.conv_beta.bias])),
                1, 1, pre_act="relu")
            gamma, beta = gb[:, :c], gb[:, c:]
        else:
            gamma = self.conv_gamma(actv, pre_act="relu")
            beta = self.conv_beta(actv, pre_act="relu")
        return normalized * (1.0 + gamma) + beta


def _conv_weight(conv, dtype, update_sn: bool = False):
    if isinstance(conv, SpectralNorm2d):
        return conv.normalized_weight(dtype, update_sn)
    return policy(conv.weight).to(dtype)


def _apply_conv(conv, h, pre_act=None, s2d=False, update_sn=False):
    if isinstance(conv, SpectralNorm2d):
        return conv(h, pre_act=pre_act, s2d=s2d, update=update_sn)
    return conv(h, pre_act=pre_act, s2d=s2d)


class SPADEResBlock(nn.Module):
    """SPADEResBlock (reference network_generator.py:125-173)."""

    def __init__(self, input_nc: int, output_nc: int,
                 norm_g: str = "spectralaliasinstance", gen_semantic_nc: int = 7,
                 fused: bool = False, use_mask_norm: bool = False,
                 device="cuda", dtype=torch.float32):
        """``use_mask_norm``: every norm is 'aliasmask' and its seg has one
        channel more (label_nc + 1), as in the JAX block."""
        super().__init__()
        self.learned_shortcut = input_nc != output_nc
        self.fused = fused
        middle_nc = min(input_nc, output_nc)
        spectral = norm_g.startswith("spectral")
        subnorm = norm_g[len("spectral"):] if spectral else norm_g
        label_nc = gen_semantic_nc
        if use_mask_norm:
            subnorm, label_nc = "aliasmask", label_nc + 1
        self.subnorm = subnorm
        conv = SpectralNorm2d if spectral else Conv2d
        kw = dict(device=device, dtype=dtype)

        def norm(nc):
            return SPADENorm(nc, label_nc, subnorm, **kw)

        if self.learned_shortcut:
            self.norm_s = norm(input_nc)
            self.conv_s = conv(input_nc, output_nc, 1, bias=False,
                               init="xavier", **kw)
        self.norm_0 = norm(input_nc)
        self.conv_0 = conv(input_nc, middle_nc, 3, padding=1, init="xavier",
                           **kw)
        self.norm_1 = norm(middle_nc)
        self.conv_1 = conv(middle_nc, output_nc, 3, padding=1, init="xavier",
                           **kw)

    def noise_shapes(self, x_shape, s2d: bool = False):
        """The (B, H, W, 1) noise fields one call on x of ``x_shape`` (NCHW)
        draws, in order: norm_s (with a learned shortcut), norm_0, norm_1;
        at the plain full-res shape in the s2d domain."""
        b, _, h, w = x_shape
        shape = (b, 2 * h, 2 * w, 1) if s2d else (b, h, w, 1)
        return [shape] * (3 if self.learned_shortcut else 2)

    def _unit(self, norm, conv, xin, seg, draw, pre_act, residual=None,
              update_sn=False):
        """One fused {SPADENorm, conv} pair (ops/spade_block.py)."""
        b, _, h, w = xin.shape
        dt = xin.dtype
        noise = draw((b, h, w, 1))
        actv = norm.conv_shared(seg)                       # pre-relu
        bc = None if conv.bias is None else policy(conv.bias)
        out = spade_conv_unit(
            pre_act, _nhwc(xin), noise, policy(norm.noise_scale), _nhwc(actv),
            policy(norm.conv_gamma.weight).to(dt), policy(norm.conv_gamma.bias),
            policy(norm.conv_beta.weight).to(dt), policy(norm.conv_beta.bias),
            _conv_weight(conv, dt, update_sn), bc,
            None if residual is None else _nhwc(residual))
        return _nchw(out)

    def forward(self, x, seg, draw, s2d: bool = False,
                update_sn: bool = False, misalign_mask=None,
                train: bool = False):
        """x: (B, C, H, W); seg: (B, label_nc, h, w) float; draw: noise
        source. With ``s2d`` both arrive as space-to-depth tensors on one
        grid (the caller resizes seg). ``update_sn``: one power iteration in
        each spectral conv (staged). ``misalign_mask``: (B, 1, h, w), resized
        (nearest) to x's size, for the mask norms; ``train``: the batch
        norms' training mode."""
        if s2d:
            if misalign_mask is not None:
                raise ValueError("the s2d domain takes no misalign mask")
        else:
            seg = interpolate_nchw(seg, size=x.shape[2:], mode="nearest")
            if misalign_mask is not None:
                misalign_mask = interpolate_nchw(misalign_mask,
                                                 size=x.shape[2:],
                                                 mode="nearest")
        if self.fused and not s2d and self.subnorm == "aliasinstance" and \
                misalign_mask is None and fused_spade_conv_eligible(
                x.shape[2], x.shape[3], _NHIDDEN, x.dtype, x.device):
            u = update_sn
            xs = (self._unit(self.norm_s, self.conv_s, x, seg, draw, None,
                             update_sn=u)
                  if self.learned_shortcut else x)
            dx = self._unit(self.norm_0, self.conv_0, x, seg, draw, "leaky0.2",
                            update_sn=u)
            return self._unit(self.norm_1, self.conv_1, dx, seg, draw,
                              "leaky0.2", residual=xs, update_sn=u)
        def norm(mod, h):
            return mod(h, seg, draw, s2d, misalign_mask, train)

        if self.learned_shortcut:
            xs = _apply_conv(self.conv_s, norm(self.norm_s, x), s2d=s2d,
                             update_sn=update_sn)
        else:
            xs = x
        dx = _apply_conv(self.conv_0, norm(self.norm_0, x), "leaky0.2", s2d,
                         update_sn)
        dx = _apply_conv(self.conv_1, norm(self.norm_1, dx), "leaky0.2", s2d,
                         update_sn)
        return xs + dx


class SPADEGenerator(nn.Module):
    def __init__(self, cfg: SPADEGenConfig = SPADEGenConfig(), device="cuda",
                 dtype=torch.float32):
        super().__init__()
        self._update_sn = self._train = False
        if cfg.num_upsampling_layers not in ("more", "most"):
            raise ValueError(
                "num_upsampling_layers must be 'more' or 'most' ('normal' is "
                "unreachable in the reference)")
        dev = resolve_device(device)
        self.cfg = cfg
        nf = cfg.ngf
        kw = dict(device=dev, dtype=dtype)
        for i in range(8):
            self.add_module(f"conv_{i}", Conv2d(
                cfg.input_nc, nf * 16 if i == 0 else 16, 3, padding=1,
                init="xavier", **kw))
        chans = [("head_0", nf * 16, nf * 16),
                 ("G_middle_0", nf * 16 + 16, nf * 16),
                 ("G_middle_1", nf * 16 + 16, nf * 16),
                 ("up_0", nf * 16 + 16, nf * 8),
                 ("up_1", nf * 8 + 16, nf * 4),
                 ("up_2", nf * 4 + 16, nf * 2),
                 ("up_3", nf * 2 + 16, nf)]
        if cfg.num_upsampling_layers == "most":
            chans.append(("up_4", nf + 16, nf // 2))
        self.block_names = [name for name, _, _ in chans]
        for name, cin, cout in chans:
            self.add_module(name, SPADEResBlock(
                cin, cout, norm_g=cfg.norm_g,
                gen_semantic_nc=cfg.gen_semantic_nc, fused=cfg.fused_block,
                **kw))
        self.conv_img = Conv2d(chans[-1][2], 3, 3, padding=1, init="xavier",
                               **kw)

    def noise_shapes(self, batch: int):
        """The (B, H, W, 1) noise fields one forward of ``batch`` images
        draws, in its order: block by block at the block's scale (the s2d
        domain draws at the plain shape too), each norm_s (with a learned
        shortcut), norm_0, norm_1."""
        sh, sw = self.cfg.latent_hw
        shapes = []
        for i, name in enumerate(self.block_names):
            block = getattr(self, name)
            shapes += block.noise_shapes((batch, 0, sh * 2 ** i, sw * 2 ** i))
        return shapes

    def set_fused(self, on: bool) -> None:
        """Route eligible blocks through the fused unit (on) or not."""
        for name in self.block_names:
            getattr(self, name).fused = bool(on)

    @contextlib.contextmanager
    def _knobs(self):
        """The config's dispatch knobs for the length of a call (and of a
        block's recompute), restored after it (the ops-level switches stay
        available to experiments)."""
        with contextlib.ExitStack() as stack:
            if self.cfg.fast_conv:
                stack.enter_context(fast_conv(True))
            if self.cfg.fast_spade:
                stack.enter_context(fast_spade(True))
            if self.cfg.merge_gamma_beta:
                stack.enter_context(merge_gamma_beta(True))
            yield

    def forward(self, x, seg, noise: NoiseArg, train: bool = False,
                update_sn: bool = False):
        """x: (N, H, W, input_nc) NHWC; seg: (N, H, W, 7) float one-hot or
        (N, H, W) int labels in [0, 7); noise: see ``noise_source``;
        ``train``: the 'aliasbatch' norms normalize with the batch's
        statistics and stage the running ones (the JAX ``train``; the other
        kinds ignore it); ``update_sn``: one power iteration in every
        spectral conv, staged (the JAX ``update_sn``). Returns (N, H, W, 3)
        in [-1, 1]."""
        self._update_sn, self._train = update_sn, train
        try:
            with self._knobs():
                return self._forward(x, seg, noise)
        finally:
            self._update_sn = self._train = False

    def _block(self, block, h, seg, draw, update_sn, s2d=False):
        """One SPADEResBlock; under ``remat`` with gradients wanted, a
        checkpointed call whose recompute is pure (module docstring)."""
        train = self._train
        if not (self.cfg.remat and torch.is_grad_enabled()):
            return block(h, seg, draw, s2d=s2d, update_sn=update_sn,
                         train=train)
        noises = [draw(shape) for shape in block.noise_shapes(h.shape, s2d)]

        def run(h_, seg_, *fields):
            with self._knobs():
                return block(h_, seg_, noise_source(fields, h_.device),
                             s2d=s2d, update_sn=update_sn, train=train)
        return torch.utils.checkpoint.checkpoint(
            run, h, seg, *noises, use_reentrant=False,
            preserve_rng_state=False)

    def _forward(self, x, seg, noise: NoiseArg):
        cfg = self.cfg
        update_sn = self._update_sn
        nf = cfg.ngf
        draw = noise_source(noise, x.device)
        sh, sw = cfg.latent_hw
        xc = _nchw(x)
        labels = seg if seg.dim() == 3 else None

        def seg_at(th, tw):
            """seg at (th, tw), NCHW one-hot."""
            if labels is None:
                return interpolate_nchw(_nchw(seg), size=(th, tw),
                                        mode="nearest")
            lh, lw = labels.shape[1], labels.shape[2]
            if lh % th or lw % tw:
                lab = interpolate_nchw(labels[:, None].float(), size=(th, tw),
                                       mode="nearest")[:, 0].long()
            else:
                lab = labels[:, ::lh // th, ::lw // tw]
            return _nchw(onehot(lab, cfg.gen_semantic_nc, dtype=x.dtype))

        # s2d tail (ops/s2d.py): the two full-res blocks and conv_img of
        # 'most' run in the space-to-depth domain; same parameters
        use_s2d = cfg.s2d_tail and cfg.num_upsampling_layers == "most"
        n_plain = 6 if use_s2d else len(self.block_names)

        # one feature map per block ('more' never reads conv_7's scale)
        features = []
        for i in range(n_plain):
            sample = interpolate_nchw(xc, size=(sh * 2 ** i, sw * 2 ** i),
                                      mode="nearest")
            features.append(getattr(self, f"conv_{i}")(
                sample.contiguous(memory_format=_CL)))

        def up(t):
            return interpolate_nchw(t, scale_factor=2, mode="nearest")

        h = self._block(self.head_0, features[0],
                        seg_at(*features[0].shape[2:]), draw, update_sn)
        for i, name in enumerate(self.block_names[1:n_plain], start=1):
            h = up(h)
            h = torch.cat([h, features[i]], dim=1).contiguous(memory_format=_CL)
            h = self._block(getattr(self, name), h,
                            seg_at(*features[i].shape[2:]), draw, update_sn)

        if use_s2d:
            # the nearest downscales of the input pyramid are stride-2 slices,
            # the nearest x2 upsample is a channel tile (upsample2x_s2d), and
            # the seg pyramid maps the same way
            fh, fw = x.shape[1], x.shape[2]
            feat6 = self.conv_6(_nchw(to_s2d(x[:, ::2, ::2, :])), s2d=True)
            feat7 = self.conv_7(_nchw(to_s2d(x)), s2d=True)
            seg6 = _nchw(to_s2d(_nhwc_view(seg_at(fh // 2, fw // 2))))
            seg7 = _nchw(to_s2d(_nhwc_view(seg_at(fh, fw))))
            h = upsample2x_s2d(_nhwc_view(h))                 # up to 512x384
            h = concat_s2d([h, _nhwc_view(feat6)], [nf * 2, 16])
            h = self._block(self.up_3, _nchw(h), seg6, draw, update_sn, True)
            h = upsample2x_s2d(from_s2d(_nhwc_view(h), nf))   # up to 1024x768
            h = concat_s2d([h, _nhwc_view(feat7)], [nf, 16])
            h = self._block(self.up_4, _nchw(h), seg7, draw, update_sn, True)
            h = self.conv_img(h, pre_act="leaky0.2", s2d=True)
            return torch.tanh(from_s2d(_nhwc_view(h), 3))

        h = self.conv_img(h, pre_act="leaky0.2")
        return torch.tanh(h).permute(0, 2, 3, 1)
