"""Carry the JAX package's variables into the port's modules.

``load_jax_variables(module, variables)`` takes a Flax variable tree as
nested dicts of numpy arrays (collections ``params``, ``batch_stats`` and
``aux``) and copies each leaf into the port module at the same path:

  * ``params``: conv kernels HWIO -> OIHW, dense kernels (in, out) ->
    (out, in), biases, BatchNorm scale/bias, SPADENorm ``noise_scale``;
  * ``batch_stats``: BatchNorm running ``mean``/``var``;
  * ``aux``: the spectral-norm ``u``/``v`` vectors.

The JAX ``Conv2d`` wraps its kernel in an inner module named ``conv``; the
port's ``Conv2d`` holds it directly, so that level is skipped. The trees of
every model the port has load this way: the tocg, the SPADE generator, both
discriminators, the four backbones, LPIPS and InceptionV3.

``export_jax_variables(module)`` is the inverse: the module's state as the
JAX variable tree (float32 numpy arrays, the ``conv`` level put back), what
the JAX training loops save with ``train/checkpoint.py:save_pytree`` and its
inference CLIs read.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch
import torch.nn as nn

from hrviton_tpu_torch.nn.layers import Conv2d

__all__ = ["load_jax_variables", "export_jax_variables"]

# the collection of each JAX leaf name
_COLLECTION = {"mean": "batch_stats", "var": "batch_stats", "u": "aux",
               "v": "aux"}


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _resolve(module: nn.Module, path) -> nn.Module:
    m = module
    for name in path:
        child = getattr(m, name, None)
        if isinstance(child, nn.Module):
            m = child
        elif isinstance(m, Conv2d) and name == "conv":
            continue
        else:
            raise KeyError(f"no port module for {'/'.join(path)} "
                           f"(stopped at {name!r} in {type(m).__name__})")
    return m


@torch.no_grad()
def load_jax_variables(module: nn.Module, variables: Mapping,
                       strict: bool = True) -> List[str]:
    """Copy ``variables`` into ``module``; returns the filled state names.
    With ``strict``, every parameter and buffer of ``module`` must be filled."""
    owner: Dict[int, str] = {id(m): n for n, m in module.named_modules()}
    filled = []
    for coll, tree in variables.items():
        for path, arr in _flatten(tree):
            target = _resolve(module, path[:-1])
            names = getattr(type(target), "_jax_names", {})
            if path[-1] not in names:
                raise KeyError(f"{coll}/{'/'.join(path)}: "
                               f"{type(target).__name__} has no such leaf")
            attr = names[path[-1]]
            dst = getattr(target, attr)
            src = torch.from_numpy(np.array(arr, dtype=np.float32))
            if src.dim() == 4:                       # HWIO -> OIHW
                src = src.permute(3, 2, 0, 1)
            elif src.dim() == 2:                     # dense (in, out) -> (out, in)
                src = src.t()
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{coll}/{'/'.join(path)}: shape "
                                 f"{tuple(src.shape)} vs port {tuple(dst.shape)}")
            dst.copy_(src)
            prefix = owner[id(target)]
            filled.append(f"{prefix}.{attr}" if prefix else attr)
    if strict:
        want = {n for n, _ in module.named_parameters()}
        want |= {n for n, _ in module.named_buffers()}
        missing = sorted(want - set(filled))
        if missing:
            raise KeyError(f"{len(missing)} port tensors not filled: {missing[:8]}")
    return filled


def export_jax_variables(module: nn.Module) -> Dict:
    """``module``'s parameters and buffers as the JAX package's variable
    tree: {'params': ..., 'batch_stats': ..., 'aux': ...} (the collections
    the module has), conv kernels OIHW -> HWIO, dense (out, in) -> (in,
    out), every leaf a float32 numpy array."""
    tree: Dict = {}
    for name, m in module.named_modules():
        names = getattr(type(m), "_jax_names", None)
        if not names:
            continue
        path = tuple(name.split(".")) if name else ()
        if isinstance(m, Conv2d):
            path = path + ("conv",)
        for leaf, attr in names.items():
            t = getattr(m, attr, None)
            if t is None:
                continue
            arr = t.detach().float().cpu().clone()   # no alias of the module
            if arr.dim() == 4:                       # OIHW -> HWIO
                arr = arr.permute(2, 3, 1, 0)
            elif arr.dim() == 2:                     # (out, in) -> (in, out)
                arr = arr.t()
            node = tree.setdefault(_COLLECTION.get(leaf, "params"), {})
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = np.ascontiguousarray(arr.numpy())
    return tree
