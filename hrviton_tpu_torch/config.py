"""Typed configuration of the try-on path.

The port's own copy of ``hrviton_tpu/config.py``'s ``TOCGConfig``,
``SPADEGenConfig`` and ``PipelineConfig`` (same fields and defaults, less the
training-only ``remat``), so the port imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class TOCGConfig:
    """Try-on condition generator (reference networks.py:13-159)."""
    input1_nc: int = 4            # cloth RGB + cloth mask
    input2_nc: int = 16           # 13-ch parse-agnostic + 3-ch densepose
    output_nc: int = 13           # segmentation classes
    ngf: int = 96                 # call-site value (train_condition.py:481)
    warp_feature: str = "T1"      # 'T1' | 'encoder'
    out_layer: str = "relu"       # 'relu' | 'conv'
    norm: str = "batch"           # encoder/decoder norm layer
    upsample: str = "bilinear"    # pyramid upsample mode


@dataclass(frozen=True)
class SPADEGenConfig:
    """SPADE image generator (reference network_generator.py:176-245)."""
    input_nc: int = 9             # agnostic(3) + densepose(3) + warped cloth(3)
    ngf: int = 64
    gen_semantic_nc: int = 7
    num_upsampling_layers: str = "most"   # 'more' | 'most' ('normal' is
                                          # unreachable in the reference)
    norm_g: str = "spectralaliasinstance"
    fine_height: int = 1024
    fine_width: int = 768
    s2d_tail: bool = False        # run up_3, up_4 and conv_img of 'most' in the
                                  # space-to-depth domain (ops/s2d.py: plain
                                  # tensor code, no kernel)
    fused_block: bool = True      # fused {norm -> act -> conv} CUDA unit at
                                  # eligible scales (ops/spade_block.py)
    fast_conv: bool = False       # eligible 3x3 convs (Cin % 128 == 0, h >= 128)
                                  # go to the wide conv kernel
                                  # (ops/conv3x3.py:conv3x3_wide)
    fast_spade: bool = False      # eligible norms (h >= 256) go to the fused
                                  # modulation kernel (ops/spade_fused.py)
    merge_gamma_beta: bool = False  # conv_gamma and conv_beta of a plain norm
                                    # run as one 3x3 conv of twice the width
                                    # (through the same dispatch as any conv)

    @property
    def num_up_layers(self) -> int:
        return {"normal": 5, "more": 6, "most": 7}[self.num_upsampling_layers]

    @property
    def latent_hw(self) -> Tuple[int, int]:
        f = 2 ** self.num_up_layers
        return self.fine_height // f, self.fine_width // f


@dataclass(frozen=True)
class PipelineConfig:
    """End-to-end try-on pipeline (reference test_generator.py path)."""
    fine_height: int = 1024
    fine_width: int = 768
    cond_height: int = 256
    cond_width: int = 192
    semantic_nc: int = 13
    clothmask_composition: str = "warp_grad"  # 'no_composition'|'detach'|'warp_grad'
    occlusion: bool = False
    upsample: str = "bilinear"
    # The 256x192 flow is upsampled with the condition-stage grid's
    # normalization constants (96, 128) (test_generator.py:208).
    flow_norm_w: float = (96 - 1.0) / 2.0
    flow_norm_h: float = (128 - 1.0) / 2.0
