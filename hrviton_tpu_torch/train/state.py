"""Train-state containers of the two GAN stages (``hrviton_tpu/train/state.py``):
a network's module (parameters and buffers: BatchNorm statistics, spectral
u/v) with its optimizer, and the pair with the step count."""

from __future__ import annotations

from dataclasses import dataclass

import torch.nn as nn

from hrviton_tpu_torch.train.optim import Adam

__all__ = ["NetState", "GANState"]


@dataclass(eq=False)
class NetState:
    """One network: its module and its optimizer. Compared and hashed by
    identity, as a recorded step's argument (``core/graphs.py``)."""
    module: nn.Module
    opt: Adam

    def variables(self):
        """The JAX variable tree of the module (``convert.export_jax_variables``):
        what the JAX trainers save as ``state.g.variables()``."""
        from hrviton_tpu_torch.convert import export_jax_variables
        return export_jax_variables(self.module)


@dataclass
class GANState:
    step: int
    g: NetState
    d: NetState
