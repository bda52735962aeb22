"""The training step (mirrors ``mrn_tpu/train/steps.py``): forward, loss,
backward, optional gradient transform, clip + the optimizer's update.

JAX's step is a pure function of a ``TrainState``; here the state holds the
master parameters, which the optimizer updates in place, and BatchNorm
moves its running statistics in place during the train-mode forward (the
JAX step returns them as ``new_batch_stats``).

Under a mesh (``parallel.mesh``) each rank's loss is its share of the
global batch's: the mean of the ranks' losses is the global loss.  The
gradients and the step's scalar metrics are averaged over the world in one
bucket (``mesh.all_reduce_grads``) before ``grad_transform``, the clip and
the update, as JAX's ``tx.update`` sees the global gradient; the reported
``loss`` is the global one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from mrn_tpu_torch.ops.ctc import ctc_loss
from mrn_tpu_torch.ops.losses import cross_entropy_ignore
from mrn_tpu_torch.parallel import mesh

__all__ = ["TrainState", "make_train_step", "recognition_loss"]


@dataclass
class TrainState:
    params: Dict[str, torch.Tensor]   # trainable master parameters by name
    opt: object   # a train.optim optimizer (Adam, SGD or Adadelta)
    step: int = 0


def recognition_loss(preds: torch.Tensor, batch, pad_id: Optional[int] = None
                     ) -> torch.Tensor:
    """CTC on the full-T predictions, or, given the Attn converter's
    ``pad_id``, the cross entropy over the targets after [SOS]
    (``label[:, 1:]``) that are not [PAD]; ``batch`` carries ``label``
    [B, N] and ``length`` [B].  Under a data mesh the Attn sum is divided
    by this rank's share of the global batch's token count (a mean of
    per-rank token means is not the global loss); CTC's per-sample mean
    needs nothing, the shards being equal."""
    if pad_id is not None:
        target = batch["label"][:, 1:]
        count = None
        if mesh.get_mesh() is not None:
            total = mesh.data_total((target != pad_id).sum().float())
            count = total.clamp(min=1.0) / mesh.data_size()
        return cross_entropy_ignore(preds, target, pad_id, count=count)
    return ctc_loss(preds, batch["label"], batch["length"])


def make_train_step(loss_fn: Callable,
                    grad_transform: Optional[Callable] = None) -> Callable:
    """``loss_fn(params, batch) -> (loss, metrics)``.  Returns
    ``step(state, batch) -> metrics`` (``loss``, ``grad_norm`` and ``lr``
    added, all left on the device).  A parameter the loss does not reach
    (DER's ``aux_fc``) gets a zero gradient, as under ``jax.grad``."""

    def step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        names = list(state.params)
        loss, metrics = loss_fn(state.params, batch)
        grads = torch.autograd.grad(loss, [state.params[n] for n in names],
                                    allow_unused=True, materialize_grads=True)
        loss = loss.detach()
        if mesh.get_mesh() is not None:   # the global gradient, loss and metrics
            keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
            reduced = mesh.all_reduce_grads([*grads, loss, *(metrics[k] for k in keys)])
            grads, loss = reduced[:len(names)], reduced[len(names)]
            metrics = dict(metrics, **dict(zip(keys, reduced[len(names) + 1:])))
        if grad_transform is not None:
            grads = grad_transform(dict(zip(names, grads)))
            grads = [grads[n] for n in names]
        info = state.opt.step(grads)
        state.step += 1
        return dict(metrics, loss=loss, **info)

    return step
