"""Device selection: every entry point runs on the card unless the caller
asks for the CPU, and never falls back to the CPU by itself."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "hrviton_tpu_torch: CUDA device requested but torch.cuda is not "
            "available; pass device='cpu' to run on the CPU")
    return dev
