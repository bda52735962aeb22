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
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np
import torch

from mrn_tpu_torch.ops.schedules import multistep_schedule, onecycle_schedule

__all__ = ["Adam", "build_optimizer", "build_schedule"]


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


def build_optimizer(opt, schedule: Callable[[int], float],
                    params: Sequence[torch.Tensor]) -> Adam:
    if opt.optimizer != "adam":
        raise NotImplementedError(f"optimizer {opt.optimizer!r}: the port has "
                                  "Adam only so far (see ROADMAP.md)")
    return Adam(params, schedule, opt.grad_clip)
