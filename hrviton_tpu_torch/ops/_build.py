"""Build and load the package's hand-written CUDA kernels.

Each source under ``hrviton_tpu_torch/csrc/`` has a plain C interface. It is
compiled by ``nvcc`` for sm_90a into a shared library under ``build/`` at the
repository root, at first use, linked to the shared CUDA runtime (the one
torch has loaded, found by its soname), and loaded with ctypes. The
library's name carries a hash of the source, of the headers it may include
(every ``*.cuh`` beside it) and of the compiler flags, so an edited kernel
is rebuilt and an unchanged one is not. Nothing but the CUDA toolkit is needed.

``build_all`` compiles several sources at once, one ``nvcc`` process each.
The one rule by which every model-path wrapper and its gate choose between
the kernel and the plain version lives here (``runs_kernel``: bfloat16 on
the card runs the kernel, everything else the plain version), with the
argument checks that every kernel wrapper makes before it hands raw
pointers to a kernel, and ``ref_grads``, the backward that every wrapper's
``torch.autograd.Function`` shares: autograd of its plain version on the
saved inputs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Sequence

import torch

from hrviton_tpu_torch.utils import profiling

__all__ = ["SOURCES", "build", "build_all", "load", "ACT_CODES",
           "runs_kernel", "wrapper_runs_kernel", "check_tensor", "pad_to",
           "ref_grads"]

# csrc/<name>.cu
SOURCES = ("spade_block", "spade_fused", "conv3x3", "copy_probe", "conv_tma",
           "spade_knock", "wgrad3x3")

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
# -cudart shared: the libraries use the process's one CUDA runtime (torch's,
# already loaded), not a static copy each
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-cudart", "shared"]
ACT_CODES = {None: 0, "relu": 1, "leaky0.2": 2}   # pre_act as the kernels take it

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       f"the kernels under {_CSRC}")


def _library_path(name: str) -> Path:
    h = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    return _BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build_all(names: Sequence[str] = SOURCES,
              verbose: bool = False) -> Dict[str, Path]:
    """Compile the named sources in parallel (each once per hash) and return
    their library paths. With ``verbose`` everything is compiled anew and the
    compiler's resource report (-Xptxas -v) is printed. Raises if any fails."""
    libs = {name: _library_path(name) for name in names}
    todo = [n for n in names if verbose or not libs[n].exists()]
    if not todo:
        return libs
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = libs[name].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu: nvcc failed ({proc.returncode}):\n{err}")
            continue
        if verbose:
            print(err.strip())
        os.replace(tmp, libs[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def build(name: str, verbose: bool = False) -> Path:
    """Compile one source (once per hash) and return the library path."""
    return build_all([name], verbose)[name]


def load(name: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if need be;
    ``declare(lib)`` sets argtypes and restype once. A first load is the
    span ``ops.load[<name>]``, with the build inside it."""
    with _LOCK:
        if name not in _LIBS:
            with profiling.span("ops.load", name):
                lib = ctypes.CDLL(str(build(name)))
                declare(lib)
            _LIBS[name] = lib
        return _LIBS[name]


def runs_kernel(dtype, device) -> bool:
    """Whether a model-path op of ``dtype`` on ``device`` runs its
    hand-written kernel: bfloat16 on a CUDA device, as the JAX gates take
    bf16 only. Everything else runs the plain version (an f32 one on the
    card with TF32 off). The wrappers and the gates ask this alone."""
    return torch.device(device).type == "cuda" and dtype == torch.bfloat16


def wrapper_runs_kernel(name: str, x: torch.Tensor) -> bool:
    """``runs_kernel`` for the input ``x`` of the wrapper ``name``, which
    first refuses what neither route takes: a device other than the CPU or
    a CUDA device (ValueError), and on the card a dtype other than float32
    or bfloat16 (TypeError)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.device.type == "cuda" and x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes float32/bfloat16 on the card, got {x.dtype}")
    return runs_kernel(x.dtype, x.device)


def pad_to(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def check_tensor(name, t, shape, dtype, device) -> None:
    """Raise unless ``t`` is what a kernel may read through a raw pointer:
    on ``device``, of ``shape`` and ``dtype``, contiguous, 16-byte aligned."""
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (NHWC)")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def ref_grads(need: Sequence[bool], g: torch.Tensor, inputs: Sequence,
              fn: Callable):
    """Gradients of ``fn(*inputs)`` against the output gradient ``g`` for
    the inputs whose ``need`` is true (None for the others and for None
    inputs), by autograd of ``fn`` on detached copies: the backward of a
    kernel whose plain version is ``fn``."""
    leaves = [None if t is None else t.detach().requires_grad_(bool(n))
              for t, n in zip(inputs, need)]
    with torch.enable_grad():
        y = fn(*leaves)
        wrt = [t for t, n in zip(leaves, need) if t is not None and n]
        got = iter(torch.autograd.grad(y, wrt, g) if wrt else ())
    return [next(got) if t is not None and n else None
            for t, n in zip(leaves, need)]
