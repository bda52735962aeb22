"""The training step (mirrors ``mrn_tpu/train/steps.py``): forward, loss,
backward, optional gradient transform, clip + the optimizer's update.

JAX's step is a pure function of a ``TrainState``; here the state holds the
master parameters, which the optimizer updates in place, and BatchNorm
moves its running statistics in place during the train-mode forward (the
JAX step returns them as ``new_batch_stats``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from mrn_tpu_torch.ops.ctc import ctc_loss

__all__ = ["TrainState", "make_train_step", "recognition_loss"]


@dataclass
class TrainState:
    params: Dict[str, torch.Tensor]   # trainable master parameters by name
    opt: object   # a train.optim optimizer (Adam, SGD or Adadelta)
    step: int = 0


def recognition_loss(preds: torch.Tensor, batch) -> torch.Tensor:
    """CTC on the full-T predictions (the port trains CTC heads only);
    ``batch`` carries ``label`` [B, N] and ``length`` [B]."""
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
        if grad_transform is not None:
            grads = grad_transform(dict(zip(names, grads)))
            grads = [grads[n] for n in names]
        info = state.opt.step(grads)
        state.step += 1
        return dict(metrics, loss=loss.detach(), **info)

    return step
