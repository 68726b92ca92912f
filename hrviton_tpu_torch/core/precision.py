"""Precision policy: bf16 or f32 weights, and f32 free of TF32.

Counterpart of ``hrviton_tpu/core/precision.py``. ``cast_floating`` casts a
module's floating parameters and buffers (BatchNorm running statistics, the
spectral ``u``/``v``, SPADE ``noise_scale``) in place and leaves integer
buffers alone, as the JAX function does for the leaves of a pytree.
Normalization layers compute their statistics in f32 whatever the weights'
dtype (``nn/layers.py``).

``no_tf32`` runs a block with TF32 off for cuDNN's convolutions and for
matmuls, and restores the caller's settings after it: torch leaves cuDNN's
TF32 on by default, which would run an f32 forward's library convs at TF32
precision. It sets torch's ``allow_tf32`` flags, the same API as the blur's
``torch.backends.cudnn.flags`` (``ops/blur.py``), so one process never mixes
them with the ``fp32_precision`` API. ``exact(dtype)`` is the guard every
library conv and matmul of the port's f32 math is issued under
(``nn/layers.py:conv_forward``, the spectral norm's sigma, the kernels'
plain versions in ``ops/``, the evaluation models' own products): TF32 off
for float32, nothing changed for any other dtype. So an f32 forward is f32
in every product whatever its entry point, and a bf16 one leaves the flags
alone.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn

__all__ = ["cast_floating", "bf16_params", "f32_params", "no_tf32", "exact"]


def cast_floating(module: nn.Module, dtype) -> nn.Module:
    """Cast ``module``'s floating parameters and buffers to ``dtype`` in
    place (integer buffers stay); returns ``module``."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            if t.is_floating_point():
                t.data = t.data.to(dtype)
    return module


def bf16_params(module: nn.Module) -> nn.Module:
    return cast_floating(module, torch.bfloat16)


def f32_params(module: nn.Module) -> nn.Module:
    return cast_floating(module, torch.float32)


@contextlib.contextmanager
def no_tf32():
    """TF32 off for cuDNN convs and matmuls inside the block."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def exact(dtype):
    """``no_tf32()`` for float32 math, a context that changes nothing for
    any other dtype."""
    return no_tf32() if dtype == torch.float32 else contextlib.nullcontext()
