"""Process-group start-up (the port's counterpart of
``mrn_tpu/parallel/multihost.py``, which wraps ``jax.distributed.initialize``).

One process per card, launched by ``torchrun``, which sets ``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` for each:

    torchrun --nproc_per_node 4 -m mrn_tpu_torch.train_cli --config C \\
        [--data_parallel 4 | --expert_parallel 2] [--multihost]

``initialize()`` joins that world with ``torch.distributed.init_process_group``
and sets the rank's device.  In PyTorch one host and many hosts take the
same call: ``torchrun --nnodes N --node_rank R --master_addr HOST0`` on each
host gives every process the same environment form, so there is no separate
multi-host path.  Every process then draws the same global batch from the
same seed and keeps its own rows (``mesh.shard_batch``), as JAX's processes
do.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist

__all__ = ["TORCHRUN_ENV", "initialize", "is_initialized", "launched_by_torchrun"]

TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def launched_by_torchrun() -> bool:
    """Whether this process carries torchrun's rendezvous environment."""
    return all(k in os.environ for k in TORCHRUN_ENV)


def initialize(device: Optional[Union[str, torch.device]] = None,
               backend: Optional[str] = None) -> Tuple[int, int]:
    """Joins torchrun's world; returns ``(rank, world_size)``, as JAX's
    returns ``(process_index, process_count)``.

    The rank's device is ``cuda:LOCAL_RANK`` unless ``device`` names one,
    which every rank then takes (two gloo ranks can share ``cuda:0``;
    NCCL refuses two ranks on one card).  The backend is NCCL on a CUDA
    device and gloo on the CPU unless ``backend`` says otherwise.  Raises
    outside torchrun's environment and without the card it asks for."""
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"a process group needs torchrun's environment ({', '.join(missing)} unset): "
            "launch with torchrun --nproc_per_node N -m mrn_tpu_torch.train_cli ...")
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    device = torch.device("cuda", local_rank) if device is None else torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is unavailable")
        if device.index is None:
            device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    return dist.get_rank(), dist.get_world_size()


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()
