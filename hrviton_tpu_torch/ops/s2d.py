"""Space-to-depth (block=2) domain for full-res conv stacks.

PyTorch counterpart of ``hrviton_tpu/ops/s2d.py``: (N, H, W, C) <->
(N, H/2, W/2, 4C) with phase-major channels [p(0,0)*C, p(0,1)*C, p(1,0)*C,
p(1,1)*C], and the generator's ops re-expressed exactly in that domain:

  * ``conv3x3_s2d``: a 3x3 stride-1 pad-1 conv; each of the 4 output phases
    is one 2x2-window conv over the 4C input phases with per-phase padding;
  * ``conv1x1_s2d``: a per-phase channel product;
  * ``instance_norm_s2d``: stats over (space, phase) per original channel;
  * ``upsample2x_s2d``: nearest x2 upsample becomes a channel tile,
    s2d(up(x)) = [x, x, x, x];
  * ``concat_s2d``: channel concat that interleaves per phase.

Plain tensor functions on NHWC tensors with OIHW weights; the JAX package
has no kernel here and neither has the port. ``SPADEGenConfig.s2d_tail`` runs
the generator's two full-res blocks and ``conv_img`` through them.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from hrviton_tpu_torch.core import precision

__all__ = ["to_s2d", "from_s2d", "conv3x3_s2d", "conv1x1_s2d",
           "instance_norm_s2d", "upsample2x_s2d", "concat_s2d"]


def to_s2d(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/2, W/2, 4C), phase-major channel layout."""
    n, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"to_s2d needs even H and W, got {h}x{w}")
    y = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, h // 2, w // 2, 4 * c)


def from_s2d(y: torch.Tensor, c: int) -> torch.Tensor:
    """Inverse of :func:`to_s2d`; ``c`` is the original channel count."""
    n, hh, ww, c4 = y.shape
    if c4 != 4 * c:
        raise ValueError(f"from_s2d: {c4} channels are not 4 * {c}")
    x = y.reshape(n, hh, ww, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, 2 * hh, 2 * ww, c)


def upsample2x_s2d(x: torch.Tensor) -> torch.Tensor:
    """s2d of nearest-x2 upsample: every phase equals the source pixel."""
    return torch.cat([x, x, x, x], dim=-1)


def concat_s2d(parts, channels) -> torch.Tensor:
    """Channel-concat in the s2d domain: the s2d form of the full-res concat
    interleaves the parts per phase. ``channels`` lists each part's original
    (plain) channel count."""
    n, hh, ww = parts[0].shape[:3]
    split = [p.reshape(n, hh, ww, 4, c) for p, c in zip(parts, channels)]
    return torch.cat(split, dim=-1).reshape(n, hh, ww, 4 * sum(channels))


@functools.lru_cache(maxsize=None)
def _phase_maps():
    """(a, b) -> list of (U, V, py, px, ky, kx) tap placements."""
    out = {}
    for a in (0, 1):
        for b in (0, 1):
            taps = []
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    u = (a + dy) // 2 + (1 - a)   # window row in [0, 2)
                    v = (b + dx) // 2 + (1 - b)
                    py, px = (a + dy) % 2, (b + dx) % 2
                    taps.append((u, v, py, px, dy + 1, dx + 1))
            out[(a, b)] = taps
    return out


def _phase_kernel(k: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """The (Cout, 4*Cin, 2, 2) kernel of output phase (a, b) from the
    (Cout, Cin, 3, 3) kernel."""
    cout, cin = k.shape[0], k.shape[1]
    kk = k.new_zeros(cout, 4, cin, 2, 2)
    for (u, v, py, px, ky, kx) in _phase_maps()[(a, b)]:
        kk[:, py * 2 + px, :, u, v] = k[:, :, ky, kx]
    return kk.reshape(cout, 4 * cin, 2, 2)


def conv3x3_s2d(x2: torch.Tensor, k, b=None, dtype=None) -> torch.Tensor:
    """Exact 3x3 stride-1 pad-1 conv, computed in the s2d domain.

    x2: (N, H', W', 4*Cin) phase-major; k: (Cout, Cin, 3, 3); b: optional
    (Cout,) bias, added after the output-dtype round; dtype: compute/output
    dtype (x2's by default). Returns (N, H', W', 4*Cout) phase-major.
    """
    dtype = dtype or x2.dtype
    k = k.to(dtype)
    xc = x2.to(dtype).permute(0, 3, 1, 2)
    outs = []
    for a in (0, 1):
        for bb in (0, 1):
            with precision.exact(dtype):
                y = F.conv2d(F.pad(xc, (1 - bb, bb, 1 - a, a)),
                             _phase_kernel(k, a, bb))
            if b is not None:
                y = y + b.to(dtype).view(1, -1, 1, 1)
            outs.append(y)
    return torch.cat(outs, dim=1).permute(0, 2, 3, 1)


def conv1x1_s2d(x2: torch.Tensor, k, b=None, dtype=None) -> torch.Tensor:
    """1x1 conv in the s2d domain: one per-phase product. k: (Cout, Cin, 1,
    1) or (Cout, Cin)."""
    dtype = dtype or x2.dtype
    k = k.reshape(k.shape[0], k.shape[1]).to(dtype)
    n, hh, ww, _ = x2.shape
    cout, cin = k.shape
    with precision.exact(dtype):
        y = torch.matmul(x2.to(dtype).reshape(n, hh, ww, 4, cin), k.t())
    if b is not None:
        y = y + b.to(dtype)
    return y.reshape(n, hh, ww, 4 * cout)


def instance_norm_s2d(x2: torch.Tensor, c: int, eps: float = 1e-5) -> torch.Tensor:
    """Instance norm whose stats match the full-res formulation exactly:
    per original channel, reduced over space and the 4 phases."""
    n, hh, ww, c4 = x2.shape
    if c4 != 4 * c:
        raise ValueError(f"instance_norm_s2d: {c4} channels are not 4 * {c}")
    xf = x2.float().reshape(n, hh, ww, 4, c)
    mu = xf.mean(dim=(1, 2, 3), keepdim=True)
    var = (xf - mu).square().mean(dim=(1, 2, 3), keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return out.reshape(n, hh, ww, c4).to(x2.dtype)
