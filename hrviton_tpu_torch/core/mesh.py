"""Data-parallel layout and the cross-rank reductions of training.

Counterpart of ``hrviton_tpu/core/mesh.py``. The JAX package runs one
program over a device mesh: under ``jit`` with the batch sharded over the
'data' axis, every cross-batch reduction (BatchNorm moments, loss means,
gradient sums) is a collective, and the sharded step is the single-device
step on the global batch. Here each process drives one device (one rank of
a ``torch.distributed`` group) and holds its own rows of the global batch,
so each of those reductions is made explicit:

  * gradients: ``average_grads`` all-reduces a network's gradients, one
    flattened bucket a network, between ``torch.autograd.grad`` and the
    optimizer step (``train/condition_trainer.apply_grads``), so Adam steps
    identically on every rank;
  * BatchNorm statistics: inside ``sharded(mesh)`` a training-mode
    ``nn/layers.BatchNorm2d`` takes the global mean and the global mean of
    squared deviations through ``torch.distributed.nn.functional.all_reduce``
    (gradients flow through it) and counts ``n`` globally;
  * random draws: inside ``sharded(mesh)``, ``draw_rows`` draws at the
    global batch's shape from the shared seeded generator and keeps the
    rank's rows (the SPADE noise, the discriminator's dropout masks, the
    LPIPS heads' dropout), so a run on N ranks equals the run on one;
  * metrics: ``mean_metrics`` averages a dict of 0-d tensors across ranks.

``DistributedDataParallel`` is not used: the trainers take gradients with
``torch.autograd.grad`` (DDP's reducer fires only on ``.backward()``) and
recompute blocks under ``torch.utils.checkpoint``; nor is
``torch.nn.SyncBatchNorm``, which lacks the port's staged running statistics
(``nn/layers.commit_state``), its bf16 policy and ``affine=False``.

Every rank feeds an equal share of the global batch (``local_batch_size``;
``data/loader.Loader`` slices a rank's rows), so a mean of the ranks' means
is the global mean.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Iterable, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["DATA_AXIS", "Mesh", "init_distributed", "shutdown_distributed",
           "make_mesh", "local_batch_size", "shard_batch", "shard_eval_batch",
           "sharded", "active_mesh", "draw_rows", "average_grads",
           "mean_metrics", "all_mean", "broadcast_module"]

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data-parallel layout: ``world_size`` ranks on the 'data' axis,
    this process's ``rank`` and ``device``, and the process ``group`` (None
    for one process without a group)."""
    world_size: int
    rank: int
    device: torch.device
    group: Optional[object] = None

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.world_size}

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def rows(self, n_local: int) -> slice:
        """This rank's rows of a global batch of ``n_local * world_size``."""
        return slice(self.rank * n_local, (self.rank + 1) * n_local)


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device="cuda") -> Optional[torch.device]:
    """Join the process group at ``tcp://{coordinator}`` as rank
    ``process_id`` of ``num_processes``: NCCL for a CUDA device, gloo for
    the CPU. Each process drives one device, ``cuda:{process_id % device
    count}`` (made current), or the CPU. Returns that device; does nothing
    and returns None when ``coordinator`` is empty."""
    if not coordinator:
        return None
    if num_processes is None or process_id is None:
        raise ValueError("--coordinator needs --num_processes and "
                         "--process_id (one process a device)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process_id {process_id} outside "
                         f"[0, {num_processes})")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: CUDA device requested but "
                               "torch.cuda is not available")
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id)
    return dev


def shutdown_distributed() -> None:
    """Destroy the process group ``init_distributed`` joined (nothing
    without one), so that a process can run a CLI again."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(device="cuda", model_axis: int = 1) -> Mesh:
    """The data-parallel layout over the joined group (one rank, no group,
    without one). Only ``model_axis=1`` exists: the reference trains data
    parallel only, and no caller asks for a model axis."""
    if model_axis != 1:
        raise NotImplementedError("a model axis other than 1 is not ported")
    if dist.is_available() and dist.is_initialized():
        return Mesh(dist.get_world_size(), dist.get_rank(),
                    torch.device(device), dist.group.WORLD)
    return Mesh(1, 0, torch.device(device))


def _world(mesh: Optional[Mesh]) -> int:
    if mesh is not None:
        return mesh.world_size
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def local_batch_size(global_batch: int, mesh: Optional[Mesh] = None) -> int:
    """The rows each process feeds (the global batch on one process)."""
    n = _world(mesh)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} processes")
    return global_batch // n


def _to_device(tree, device):
    if isinstance(tree, Mapping):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree)).to(device)
    return tree


def _leading(tree) -> int:
    if isinstance(tree, Mapping):
        for v in tree.values():
            n = _leading(v)
            if n >= 0:
                return n
        return -1
    return tree.shape[0] if hasattr(tree, "shape") else -1


def shard_batch(mesh: Mesh, tree):
    """A rank's rows of the global batch (numpy or tensors, nested dicts)
    onto its device: the loader has already taken the rank's rows."""
    return _to_device(tree, mesh.device)


def shard_eval_batch(mesh: Mesh, tree):
    """``shard_batch`` for an eval batch (the LPIPS, validation and
    visualisation batches) whose size the flags choose. ``tree`` holds this
    rank's rows; the global batch is that times the number of processes,
    and it is the global batch that must divide the data axis. Otherwise
    one process runs the batch whole, and several raise."""
    bs = max(_leading(tree), 0)
    n_data = mesh.shape[DATA_AXIS]
    if (bs * mesh.world_size) % max(n_data, 1) == 0:
        return shard_batch(mesh, tree)
    if mesh.world_size > 1:
        raise ValueError(
            f"global eval batch {bs * mesh.world_size} not divisible by the "
            f"data axis {n_data}; pick an eval batch (--lpips_batch / "
            f"--num_test_visualize / the validation batch) that is a "
            f"multiple of {n_data}")
    return shard_batch(mesh, tree)


# ------------------------------------------------ the reductions of a step

_ACTIVE: Optional[Mesh] = None


def _reduces(mesh: Optional[Mesh]) -> bool:
    """Whether ``mesh`` reduces across ranks: it has a group (one rank
    in a group too, whose reductions are exact copies) or several ranks."""
    return mesh is not None and (mesh.group is not None or mesh.world_size > 1)


@contextlib.contextmanager
def sharded(mesh: Optional[Mesh]):
    """Inside the block the layers and draws reduce over ``mesh`` (one
    process without a group, or None, changes nothing)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = mesh if _reduces(mesh) else None
    try:
        yield
    finally:
        _ACTIVE = prev


def active_mesh() -> Optional[Mesh]:
    """The mesh of the enclosing ``sharded`` block that reduces, else
    None."""
    return _ACTIVE


def draw_rows(draw: Callable[[Sequence[int]], torch.Tensor],
              shape: Sequence[int]) -> torch.Tensor:
    """``draw(shape)``; inside ``sharded`` the draw is made at the global
    batch's shape (``shape[0]`` times the ranks) and the rank's rows are
    kept, so every rank's generator advances as one process's would."""
    mesh = _ACTIVE
    if mesh is None:
        return draw(tuple(shape))
    full = draw((shape[0] * mesh.world_size, *shape[1:]))
    return full[mesh.rows(shape[0])]


def average_grads(grads: Iterable[Optional[torch.Tensor]],
                  mesh: Optional[Mesh] = None) -> None:
    """Average ``grads`` (a network's gradients) across the ranks in place,
    as one flattened bucket (per dtype and device)."""
    mesh = mesh if mesh is not None else _ACTIVE
    if not _reduces(mesh):
        return
    buckets: Dict = {}
    for g in grads:
        if g is not None:
            buckets.setdefault((g.dtype, g.device), []).append(g)
    for gs in buckets.values():
        flat = torch.cat([g.reshape(-1) for g in gs])
        dist.all_reduce(flat, group=mesh.group)
        flat /= mesh.world_size
        for g, part in zip(gs, flat.split([g.numel() for g in gs])):
            g.copy_(part.view_as(g))


def mean_metrics(metrics: Dict[str, torch.Tensor],
                 mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """A dict of 0-d tensors averaged across the ranks (one all-reduce)."""
    mesh = mesh if mesh is not None else _ACTIVE
    if not _reduces(mesh) or not metrics:
        return metrics
    keys = list(metrics)
    flat = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(flat, group=mesh.group)
    flat /= mesh.world_size
    return {k: flat[i] for i, k in enumerate(keys)}


def all_mean(value: float, mesh: Optional[Mesh]) -> float:
    """A host number averaged across the ranks."""
    if not _reduces(mesh):
        return float(value)
    t = torch.tensor([float(value)], dtype=torch.float64, device=mesh.device)
    dist.all_reduce(t, group=mesh.group)
    return float(t.item()) / mesh.world_size


@torch.no_grad()
def broadcast_module(module: torch.nn.Module, mesh: Optional[Mesh]) -> None:
    """Rank 0's parameters and buffers copied to every rank."""
    if not _reduces(mesh):
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0, group=mesh.group)
