"""Data and expert parallelism over ``torch.distributed`` (the port's
counterpart of ``mrn_tpu/parallel/mesh.py``).

JAX installs a device mesh and lets XLA partition one program over it.
Here every rank runs the whole program on its own rows, and the collectives
that the partitioned program holds are explicit:

- ``shard_batch``: this rank's rows of the global host batch (every rank
  draws the same global stream from the same seed);
- ``data_mean``: a mean over the ``data`` axis that autograd differentiates
  (an all-reduce forward, an all-reduce of the gradient backward): the
  train-mode BatchNorm moments of the global batch;
- ``data_total``: a sum over ``data`` without gradient (Attn's token count);
- ``all_reduce_grads``: one flat bucket of the step's gradients (and its
  scalar metrics) averaged over the world, so the optimizer sees the global
  batch's gradient, as JAX's ``tx.update`` does under its mesh;
- ``shard_experts`` / ``gather_experts``: MRN's contiguous block of experts
  on this rank, and their outputs gathered over ``expert``;
- ``replicate``: rank 0's tensors, broadcast;
- ``gather_for_host``: eval outputs gathered over ``data``.

The mesh is ``data x expert`` over the ranks: rank ``r`` has data index
``r // E`` and expert index ``r % E``, as JAX's ``reshape(data, expert)``
lays out its devices.  The ranks that share an expert index form a ``data``
group (the same experts, different rows); those that share a data index an
``expert`` group (the same rows, different experts).  This is the layout of
``init_device_mesh(..., mesh_dim_names=("data", "expert"))``; the groups are
made with ``new_group`` directly.

With a process group a mesh is installed even over one rank, so a 1-rank
world runs every collective; without one every function is the identity, as
in JAX.  A mean is ``ReduceOp.AVG`` under NCCL and a sum divided by the
group's size under gloo, which has no AVG; over one rank both leave the
values bitwise as they were.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

__all__ = ["Mesh", "all_reduce_grads", "barrier", "clear", "data_mean", "data_size",
           "data_total", "gather_experts", "gather_for_host", "get_mesh", "is_main",
           "replicate", "set_data_parallel", "set_expert_parallel", "shard_batch",
           "shard_experts"]


@dataclass(frozen=True)
class Mesh:
    data: int
    expert: int
    rank: int
    data_group: object     # the ranks holding this rank's experts
    expert_group: object   # the ranks holding this rank's rows (None without an expert axis)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "expert": self.expert} if self.expert > 1 \
            else {"data": self.data}

    @property
    def data_index(self) -> int:
        return self.rank // self.expert

    @property
    def expert_index(self) -> int:
        return self.rank % self.expert


_MESH: Optional[Mesh] = None


def _group(ranks: List[int]):
    """The process group of ``ranks`` (every rank must make every group, in
    the same order); the world's own group when it is the whole world."""
    return dist.group.WORLD if len(ranks) == dist.get_world_size() else dist.new_group(ranks)


def set_data_parallel(num_devices: Optional[int] = None) -> Optional[Mesh]:
    """Installs a 1-D ``data`` mesh over the world (``num_devices``, default
    the world size, must equal it).  Without a process group it installs
    nothing, and asking for more than one shard raises."""
    return set_expert_parallel(1, num_devices)


def set_expert_parallel(expert: int, data: Optional[int] = None) -> Optional[Mesh]:
    """Installs a ``data x expert`` mesh over the world (``data`` defaults to
    the world size over ``expert``; the product must equal the world size).
    ``expert=1`` is the 1-D data mesh."""
    global _MESH
    expert = max(1, int(expert or 1))
    if not (dist.is_available() and dist.is_initialized()):
        if expert > 1 or (data or 1) > 1:
            raise RuntimeError(
                f"a {data or 'N'} x {expert} (data x expert) mesh needs a process group: "
                "launch with torchrun --nproc_per_node N -m mrn_tpu_torch.train_cli ...")
        _MESH = None
        return None
    world = dist.get_world_size()
    if data is None:
        if world % expert:
            raise ValueError(f"the world's {world} ranks do not split into {expert} experts")
        data = world // expert
    if data * expert != world:
        raise ValueError(f"a {data} x {expert} (data x expert) mesh needs {data * expert} "
                         f"ranks; the world has {world}")
    data_groups = [_group([d * expert + e for d in range(data)]) for e in range(expert)]
    expert_groups = [_group([d * expert + e for e in range(expert)]) for d in range(data)] \
        if expert > 1 else None
    rank = dist.get_rank()
    _MESH = Mesh(data, expert, rank, data_groups[rank % expert],
                 expert_groups[rank // expert] if expert_groups else None)
    return _MESH


def clear() -> None:
    """Uninstalls the mesh (the process group stays)."""
    global _MESH
    _MESH = None


def get_mesh() -> Optional[Mesh]:
    return _MESH


def data_size() -> int:
    """The number of data shards (1 without a mesh)."""
    return 1 if _MESH is None else _MESH.data


def is_main() -> bool:
    """Whether this process writes the run's files: rank 0, or a process
    without a group."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def barrier() -> None:
    """Waits for every rank (nothing without a group)."""
    if dist.is_available() and dist.is_initialized():
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def _mean_(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` replaced by its mean over ``group``."""
    if dist.get_backend(group) == "nccl":
        dist.all_reduce(t, dist.ReduceOp.AVG, group=group)
    else:
        dist.all_reduce(t, group=group)
        t.div_(dist.get_world_size(group))
    return t


def shard_batch(x):
    """This rank's rows of a batch-leading array, tensor or list (the ``d``-th
    of ``D`` equal blocks).  Identity without a mesh; a batch that does not
    divide by the data size raises."""
    if _MESH is None:
        return x
    n, d = len(x), _MESH.data
    if n % d:
        raise ValueError(f"a batch of {n} rows does not split over {d} data shards")
    k = n // d
    return x[_MESH.data_index * k:(_MESH.data_index + 1) * k]


def shard_experts(n_experts: int) -> range:
    """The contiguous block of expert indices this rank holds: all of them
    without an expert axis, or when ``n_experts`` does not divide by it
    (JAX then replicates the stack)."""
    if _MESH is None or _MESH.expert == 1 or n_experts % _MESH.expert:
        return range(n_experts)
    k = n_experts // _MESH.expert
    return range(_MESH.expert_index * k, (_MESH.expert_index + 1) * k)


def gather_experts(x: torch.Tensor) -> torch.Tensor:
    """Expert-leading outputs of this rank's block, gathered over the
    ``expert`` group in expert order (no gradient)."""
    if _MESH is None or _MESH.expert == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(_MESH.expert)]
    dist.all_gather(parts, x.contiguous(), group=_MESH.expert_group)
    return torch.cat(parts)


class _DataMean(torch.autograd.Function):
    """The mean over the data group; its gradient is the mean of the
    incoming gradients (each rank back-propagates its own share of the
    loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _mean_(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return _mean_(grad.contiguous().clone(), ctx.group), None


def data_mean(x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over the data group, differentiably (identity without a
    mesh)."""
    if _MESH is None:
        return x
    return _DataMean.apply(x, _MESH.data_group)


def data_total(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data group, without gradient (identity without a
    mesh)."""
    if _MESH is None:
        return x
    t = x.detach().clone()
    dist.all_reduce(t, group=_MESH.data_group)
    return t


def all_reduce_grads(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor's mean over the world, through one flat float32 bucket
    (one collective a step), returned in the tensor's own dtype and memory
    layout (a norm over another layout sums in another order).  The gradient
    of every rank's share of the loss averages to the global batch's; a term
    every rank computes alike (EWC's penalty) stays counted once.  Identity
    without a mesh."""
    if _MESH is None:
        return list(tensors)
    flat = _mean_(torch.cat([t.detach().reshape(-1).float() for t in tensors]), None)
    out, i = [], 0
    for t in tensors:
        out.append(torch.empty_like(t).copy_(flat[i:i + t.numel()].view(t.shape)))
        i += t.numel()
    return out


def replicate(tensors):
    """Broadcasts rank 0's values into ``tensors`` (an iterable of tensors, or
    a module: its parameters and buffers) in place, one collective per
    dtype; returns its argument.  Identity without a mesh."""
    if _MESH is None:
        return tensors
    items: Iterable[torch.Tensor] = (list(tensors.parameters()) + list(tensors.buffers())
                                     if isinstance(tensors, nn.Module) else list(tensors))
    buckets: Dict[tuple, List[torch.Tensor]] = {}
    for t in items:
        wire = torch.uint8 if t.dtype == torch.bool else t.dtype
        buckets.setdefault((wire, t.device), []).append(t)
    with torch.no_grad():
        for (wire, _), ts in buckets.items():
            flat = torch.cat([t.detach().reshape(-1).to(wire) for t in ts])
            dist.broadcast(flat, src=0)
            i = 0
            for t in ts:
                t.copy_(flat[i:i + t.numel()].view(t.shape))
                i += t.numel()
    return tensors


def gather_for_host(tree: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Eval outputs of this rank's rows made the global batch's: a
    batch-leading tensor is all-gathered over the data group in row order,
    a 0-d one (a sum over the rows) summed.  Identity without a mesh."""
    if _MESH is None:
        return dict(tree)
    out = {}
    for key, t in tree.items():
        if t.ndim == 0:
            out[key] = t.clone()
            dist.all_reduce(out[key], group=_MESH.data_group)
        else:
            parts = [torch.empty_like(t) for _ in range(_MESH.data)]
            dist.all_gather(parts, t.contiguous(), group=_MESH.data_group)
            out[key] = torch.cat(parts)
    return out
