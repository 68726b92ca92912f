"""Typed configuration of the try-on path.

The port's own copy of ``hrviton_tpu/config.py``'s ``TOCGConfig``,
``SPADEGenConfig``, ``CondDiscriminatorConfig``, ``PipelineConfig`` and
``DataConfig``, ``SPADEDiscriminatorConfig``, ``ConditionTrainConfig`` and
``GeneratorTrainConfig`` (same fields and defaults), so the port imports
nothing of the JAX package.
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
    remat: bool = True            # recompute each SPADE block in backward
                                  # (torch.utils.checkpoint) instead of
                                  # keeping its activations; no effect on a
                                  # forward without gradients
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
class CondDiscriminatorConfig:
    """pix2pixHD-style multiscale PatchGAN for the condition stage
    (reference networks.py:302-408, define_D at :445)."""
    input_nc: int = 33            # input1(4) + input2(16) + segmap(13)
    ndf: int = 64
    n_layers: int = 3
    num_d: int = 2
    norm: str = "instance"
    use_sigmoid: bool = False
    get_interm_feat: bool = False
    ddownx2: bool = False
    ddropout: bool = False
    spectral: bool = False


@dataclass(frozen=True)
class SPADEDiscriminatorConfig:
    """SPADE-style multiscale discriminator (reference
    network_generator.py:250-316)."""
    gen_semantic_nc: int = 7
    ndf: int = 64
    n_layers_d: int = 3
    num_d: int = 2
    norm_d: str = "spectralinstance"
    no_gan_feat_loss: bool = False

    @property
    def input_nc(self) -> int:
        return self.gen_semantic_nc + 3


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


@dataclass(frozen=True)
class ConditionTrainConfig:
    """Stage-1 loop hyperparameters (reference train_condition.py)."""
    batch_size: int = 8
    keep_step: int = 300000
    g_lr: float = 2e-4
    d_lr: float = 2e-4
    beta1: float = 0.5
    beta2: float = 0.999
    ce_lambda: float = 10.0
    gan_lambda: float = 1.0
    tv_lambda: float = 2.0
    l1_lambda: float = 10.0
    no_gan_loss: bool = False
    g_d_separate: bool = False
    lasttvonly: bool = False
    interflowloss: bool = False
    edgeawaretv: str = "no_edge"  # 'no_edge' | 'last_only' | 'weighted'
    add_lasttv: bool = False
    occlusion: bool = False
    clothmask_composition: str = "warp_grad"
    val_count: int = 1000
    display_count: int = 100
    save_count: int = 10000
    tensorboard_count: int = 100
    load_step: int = 0
    bf16: bool = False            # bf16 compute, f32 parameters and Adam state


@dataclass(frozen=True)
class GeneratorTrainConfig:
    """Stage-2 loop hyperparameters (reference train_generator.py)."""
    batch_size: int = 4
    keep_step: int = 100000
    decay_step: int = 100000
    g_lr: float = 1e-4
    d_lr: float = 4e-4            # TTUR (train_generator.py:73-74)
    beta1: float = 0.0
    beta2: float = 0.9
    lambda_feat: float = 10.0
    lambda_vgg: float = 10.0
    no_gan_feat_loss: bool = False
    no_vgg_loss: bool = False
    gt_mode: bool = False         # --GT: condition on the ground-truth parse
    occlusion: bool = False
    clothmask_composition: str = "warp_grad"
    lpips_count: int = 1000
    display_count: int = 100
    save_count: int = 10000
    tensorboard_count: int = 100
    load_step: int = 0
    bf16: bool = False            # bf16 compute, f32 parameters and Adam state
    taps_wgrad: bool = True       # 3x3 conv weight gradients as nine tap
                                  # products over row chunks (ops/conv3x3.py)
    d_remat: bool = True          # recompute the discriminator's forward in
                                  # backward
    split_d_batch: bool = False   # the discriminator judges fake and real in
                                  # two calls instead of one concatenated
                                  # batch (the same result for its per-sample
                                  # instance norms)


@dataclass(frozen=True)
class DataConfig:
    """VITON-HD dataset layout (reference cp_dataset.py contract)."""
    dataroot: str = "./data/zalando-hd-resize"
    datamode: str = "train"
    data_list: str = "train_pairs.txt"
    fine_height: int = 256
    fine_width: int = 192
    semantic_nc: int = 13
    shuffle: bool = True
    workers: int = 4
