"""Kernel experiments of the port: the formulations of the 3x3 convolution
and the band-copy probe that the JAX repository keeps under ``tools/``, as
hand-written Hopper kernels with their plain versions, each with a ``main``
that mirrors its JAX script (``python -m hrviton_tpu_torch.tools.<name>``)."""
