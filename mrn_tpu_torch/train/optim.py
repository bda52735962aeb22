"""Optimizer of the reference training envelope (mirrors
``mrn_tpu/train/optim.py``): global-norm gradient clipping at ``grad_clip``
then Adam, with the learning rate from a schedule of the update count.

The arithmetic is optax's, not ``torch.optim``'s:

- clipping scales by ``max_norm / ||g||`` only when ``||g|| >= max_norm``
  (``clip_grad_norm_`` adds 1e-6 to the norm and always scales);
- Adam is ``scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-8, bias corrections
  in float32) then ``-lr(count)``, where ``count`` is 0 on the first update.

Frozen parameters are simply not handed to the optimizer: they get no
update, as the JAX package's zero-update mask gives them none, and their
(zero) gradients stay out of the global norm there too.  The update is in
place on the master parameters.

``adam_state_to_optax`` / ``adam_state_from_optax`` map the state (update
count, ``mu``, ``nu``) to and from the state dict of the JAX package's
optimizer, ``chain(masked(set_to_zero), chain(clip_by_global_norm,
adam))``: ``{"0": {"inner_state": {}}, "1": {"0": {}, "1": {"0": {"count",
"mu", "nu"}, "1": {"count"}}}}``, ``mu`` and ``nu`` flax-layout trees of
the trained parameters (a full-state snapshot leaves the frozen experts'
moments out).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Sequence

import numpy as np
import torch

from mrn_tpu_torch.bridge import flax_tree, recognizer_state
from mrn_tpu_torch.ops.schedules import multistep_schedule, onecycle_schedule

__all__ = ["Adam", "adam_state_from_optax", "adam_state_to_optax", "build_optimizer",
           "build_schedule"]


def build_schedule(opt, scale: float = 1.0, the: int = 1) -> Callable[[int], float]:
    """'super' -> OneCycle over ``num_iter * the`` updates (MRN's router
    phase uses ``the=2``); otherwise milestone decay."""
    if "super" in str(opt.schedule):
        return onecycle_schedule(opt.lr * scale, int(opt.num_iter) * the)
    milestones = (opt.schedule if isinstance(opt.schedule, (list, tuple))
                  else opt.milestones)
    return multistep_schedule(opt.lr * scale, milestones, opt.lr_drop_rate,
                              int(opt.num_iter))


class Adam:
    """``clip_by_global_norm(max_norm)`` then ``adam(schedule)`` over a fixed
    list of float32 parameters."""

    def __init__(self, params: Sequence[torch.Tensor], schedule: Callable[[int], float],
                 max_norm: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params = list(params)
        self.schedule, self.max_norm = schedule, float(max_norm)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @staticmethod
    def _f32(x) -> float:
        return float(np.float32(x))

    def clip(self, grads: Sequence[torch.Tensor]):
        """Returns (clipped grads, global norm as a 0-d tensor)."""
        norm = torch.stack([torch.sum(g * g) for g in grads]).sum().sqrt()
        keep = norm < self.max_norm
        scaled = torch._foreach_div(list(grads), norm)
        torch._foreach_mul_(scaled, self.max_norm)
        return [torch.where(keep, g, s) for g, s in zip(grads, scaled)], norm

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
        grads, norm = self.clip(grads)
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)
        count = np.float32(self.count + 1)
        mu_hat = torch._foreach_div(self.mu, self._f32(1 - np.float32(b1) ** count))
        nu_hat = torch._foreach_div(self.nu, self._f32(1 - np.float32(b2) ** count))
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(mu_hat, denom)
        lr = self._f32(self.schedule(self.count))
        torch._foreach_mul_(updates, -lr)
        torch._foreach_add_(self.params, updates)
        self.count += 1
        return {"grad_norm": norm, "lr": lr}


def adam_state_to_optax(adam: Adam, names: Sequence[str]) -> Dict:
    """``adam``'s state as the optax state dict; ``names`` are the port
    names of ``adam.params``, in order."""
    count = np.asarray(adam.count, np.int32)
    moments = {key: flax_tree(zip(names, getattr(adam, key))) for key in ("mu", "nu")}
    return {"0": {"inner_state": {}},
            "1": {"0": {}, "1": {"0": dict(count=count, **moments),
                                 "1": {"count": count.copy()}}}}


def adam_state_from_optax(adam: Adam, names: Sequence[str], state: Mapping) -> None:
    """Loads an optax state dict (``adam_state_to_optax``'s layout) into
    ``adam`` in place; every one of ``names`` must have its moments."""
    inner = state["1"]["1"]
    for key in ("mu", "nu"):
        tensors = recognizer_state(inner["0"][key])
        if set(tensors) != set(names):
            raise ValueError(f"optimizer state {key}: parameters "
                             f"{sorted(set(tensors) ^ set(names))[:4]} differ")
        with torch.no_grad():
            for name, dst in zip(names, getattr(adam, key)):
                dst.copy_(tensors[name])
    adam.count = int(np.asarray(inner["0"]["count"]))


def build_optimizer(opt, schedule: Callable[[int], float],
                    params: Sequence[torch.Tensor]) -> Adam:
    if opt.optimizer != "adam":
        raise NotImplementedError(f"optimizer {opt.optimizer!r}: the port has "
                                  "Adam only so far (see ROADMAP.md)")
    return Adam(params, schedule, opt.grad_clip)
