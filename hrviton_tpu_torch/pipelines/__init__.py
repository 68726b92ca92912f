"""End-to-end pipelines."""

from hrviton_tpu_torch.pipelines.tryon import (ConditionOutputs, TryOnPipeline,
                                               compose_clothmask,
                                               condition_forward,
                                               remove_overlap, tryon_forward)

__all__ = ["ConditionOutputs", "TryOnPipeline", "compose_clothmask",
           "condition_forward", "remove_overlap", "tryon_forward"]
