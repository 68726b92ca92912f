"""What the benchmark hands to the program and to the reference alike, made
from ``--seed``: the weights and the pool of compact batches.

Both are made on the run's device by a ``torch.Generator`` there, in a few
large draws. The weights come in the dtype they are served in, and their
scales follow the configuration's ``init`` (so that activations stay finite
and every part of the model matters: the SPADE noise, the modulation, the
flows). The compact batches follow ``VitonHDDataset(compact=True)``'s layout,
stacked: uint8 images, 0/1 masks and 13-group label maps, spatially smooth
(blobs, not per-pixel noise), held on the host as numpy arrays, as a loader
yields them.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["sub_seeds", "make_weights", "make_pool", "DTYPES"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def sub_seeds(seed: int) -> Dict[str, int]:
    """Independent seeds of the run's parts, from any whole number."""
    state = np.random.SeedSequence(abs(int(seed))).generate_state(4, np.uint64)
    names = ("weights", "inputs", "pipeline", "sample")
    # the pipeline's seed keeps 62 bits: the program adds 1 for its noise
    return {n: int(s) % (1 << 62) for n, s in zip(names, state)}


def _std(spec, init) -> float:
    """The normal's scale for a tensor of kind ``spec.kind``."""
    kind, shape = spec.kind, spec.shape
    if len(shape) == 4:
        fan_in = shape[1] * shape[2] * shape[3]
        return init[kind] / fan_in ** 0.5
    return init[kind]


def make_weights(specs: Dict[str, list], init, seed: int, device,
                 dtype) -> Dict[str, Dict[str, torch.Tensor]]:
    """{model: {name: tensor}} in ``dtype`` on ``device``. Conv weights are
    N(0, (init[kind])^2 / fan_in); biases and the SPADE noise scales
    N(0, init[kind]^2); BatchNorm weights 1 + N(0, s^2), biases and running
    means N(0, s^2), running variances exp(N(0, s^2)) with s = init['bn'];
    spectral u and v three power iterations from a random u on the weight
    as served."""
    flat_n = sum(int(np.prod(s.shape)) for m in specs.values() for s in m)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(flat_n, generator=gen, device=device, dtype=torch.float32)
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    off = 0
    for model, model_specs in specs.items():
        tensors = out[model] = {}
        for spec in model_specs:
            n = int(np.prod(spec.shape))
            z = flat[off:off + n].view(spec.shape)
            off += n
            if spec.kind == "sn_v":
                continue                     # derived with u, below
            if spec.kind == "bn_weight":
                t = 1.0 + init["bn"] * z
            elif spec.kind in ("bn_bias", "bn_mean"):
                t = init["bn"] * z
            elif spec.kind == "bn_var":
                t = torch.exp(init["bn"] * z)
            elif spec.kind == "sn_u":
                t = z
            else:
                t = _std(spec, init) * z
            tensors[spec.name] = t.to(dtype)
        for spec in model_specs:
            if spec.kind == "sn_u":
                base = spec.name[:-len(".u")]
                w = tensors[f"{base}.weight"].float()
                w = w.reshape(w.shape[0], -1)
                u = tensors[spec.name].float()
                u = u / u.norm()
                for _ in range(3):
                    v = w.t() @ u
                    v = v / v.norm()
                    u = w @ v
                    u = u / u.norm()
                tensors[spec.name] = u.to(dtype)
                tensors[f"{base}.v"] = v.to(dtype)
    del flat
    return out


def _smooth(gen, n, c, h, w, cell, device):
    """(n, c, h, w) float in [0, 1]: uniform noise on a grid of ``cell``
    pixels, bilinearly lifted to full size."""
    low = torch.rand((n, c, max(1, h // cell), max(1, w // cell)),
                     generator=gen, device=device)
    return F.interpolate(low, size=(h, w), mode="bilinear", align_corners=False)


def make_pool(batches: int, batch: int, h: int, w: int, seed: int,
              device) -> List[dict]:
    """``batches`` compact batches of ``batch`` images at h x w: the keys of
    ``VitonHDDataset(compact=True)``'s test samples (name lists left out),
    stacked, as numpy uint8."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n = batches * batch

    def image():            # smooth colour fields, cells of 16 pixels
        u8 = (_smooth(gen, n, 3, h, w, 16, device) * 255).round().to(torch.uint8)
        return u8.permute(0, 2, 3, 1).cpu().numpy()

    def labels():           # 13-group blobs of about 64 pixels
        return _smooth(gen, n, 13, h, w, 64, device).argmax(1).to(
            torch.uint8).cpu().numpy()

    def mask():             # one smooth 0/1 region
        return (_smooth(gen, n, 1, h, w, 64, device) > 0.5).to(
            torch.uint8).permute(0, 2, 3, 1).cpu().numpy()

    arrays = {"cloth": {"paired": image(), "unpaired": image()},
              "cloth_mask": {"paired": mask(), "unpaired": mask()},
              "parse_idx": labels(), "parse_agnostic_idx": labels(),
              "densepose": image(), "pose": image(), "image": image(),
              "agnostic": image()}

    def take(v, sl):
        if isinstance(v, dict):
            return {k: take(x, sl) for k, x in v.items()}
        return np.ascontiguousarray(v[sl])
    return [take(arrays, slice(i * batch, (i + 1) * batch))
            for i in range(batches)]
