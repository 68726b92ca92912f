"""The two networks of the try-on path."""

from hrviton_tpu_torch.models.condition import ConditionGenerator, ResBlock
from hrviton_tpu_torch.models.spade import (SPADEGenerator, SPADENorm,
                                            SPADEResBlock)

__all__ = ["ConditionGenerator", "ResBlock", "SPADEGenerator", "SPADENorm",
           "SPADEResBlock"]
