"""hrviton_tpu_torch: the PyTorch / CUDA (NVIDIA H100) port of hrviton_tpu.

The JAX package ``hrviton_tpu`` is the reference; this package imports
nothing of it. Public functions take and return NHWC tensors; modules run on
channels_last NCHW tensors inside. Entry points run on the CUDA device unless
the caller passes ``device="cpu"``.
"""

from hrviton_tpu_torch.config import PipelineConfig, SPADEGenConfig, TOCGConfig
from hrviton_tpu_torch.convert import load_jax_variables
from hrviton_tpu_torch.pipelines.tryon import TryOnPipeline

__all__ = ["PipelineConfig", "SPADEGenConfig", "TOCGConfig",
           "load_jax_variables", "TryOnPipeline"]
