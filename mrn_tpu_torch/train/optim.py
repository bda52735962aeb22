"""Optimizers of the reference training envelope (mirrors
``mrn_tpu/train/optim.py``): global-norm gradient clipping at ``grad_clip``,
then Adam, SGD with decayed weights and momentum, or Adadelta, with the
learning rate from a schedule of the update count.

The arithmetic is optax's, not ``torch.optim``'s:

- clipping scales by ``max_norm / ||g||`` only when ``||g|| >= max_norm``
  (``clip_grad_norm_`` adds 1e-6 to the norm and always scales);
- Adam is ``scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-8, bias corrections
  in float32) then ``-lr(count)``, where ``count`` is 0 on the first update;
- SGD is ``add_decayed_weights(sgd_weight_decay)`` (``g + wd * p``) then
  ``trace(sgd_momentum)`` (``t = g + momentum * t``) then ``-lr(count)``;
- Adadelta is ``scale_by_adadelta(rho, eps)`` (``e_g`` updated first, the
  step ``sqrt(e_x + eps) / sqrt(e_g + eps) * g``, then ``e_x``) then
  ``-lr(count)`` (optax's zero weight decay before it changes nothing).

Frozen parameters are simply not handed to the optimizer: they get no
update, as the JAX package's zero-update mask gives them none, and their
(zero) gradients stay out of the global norm there too.  The update is in
place on the master parameters.

``opt_state_to_optax`` / ``opt_state_from_optax`` map the state to and from
the state dict of the JAX package's optimizer, ``chain(masked(set_to_zero),
chain(clip_by_global_norm, inner))``: ``{"0": {"inner_state": {}}, "1":
{"0": {}, "1": inner}}`` with ``inner`` Adam's ``{"0": {"count", "mu",
"nu"}, "1": {"count"}}``, SGD's ``{"0": {}, "1": {"0": {"trace"}, "1":
{"count"}}}`` or Adadelta's ``{"0": {}, "1": {"e_g", "e_x"}, "2":
{"count"}}``, the moments flax-layout trees of the trained parameters (a
full-state snapshot of MRN's router phase leaves the frozen experts'
moments out; ``frozen`` writes zero moments for parameters the optimizer
does not hold, as optax keeps them for DER's frozen extractors).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from mrn_tpu_torch.bridge import flax_tree, from_flax
from mrn_tpu_torch.ops.schedules import multistep_schedule, onecycle_schedule

__all__ = ["Adadelta", "Adam", "SGD", "build_optimizer", "build_schedule",
           "opt_state_from_optax", "opt_state_to_optax"]


def build_schedule(opt, scale: float = 1.0, the: int = 1) -> Callable[[int], float]:
    """'super' -> OneCycle over ``num_iter * the`` updates (MRN's router
    phase uses ``the=2``); otherwise milestone decay."""
    if "super" in str(opt.schedule):
        return onecycle_schedule(opt.lr * scale, int(opt.num_iter) * the)
    milestones = (opt.schedule if isinstance(opt.schedule, (list, tuple))
                  else opt.milestones)
    return multistep_schedule(opt.lr * scale, milestones, opt.lr_drop_rate,
                              int(opt.num_iter))


def _f32(x) -> float:
    return float(np.float32(x))


class _Clipped:
    """``clip_by_global_norm(max_norm)`` then the subclass's update over a
    fixed list of float32 parameters; ``MOMENTS`` names the per-parameter
    state lists."""

    MOMENTS: Sequence[str] = ()

    def __init__(self, params: Sequence[torch.Tensor], schedule: Callable[[int], float],
                 max_norm: float):
        self.params = list(params)
        self.schedule, self.max_norm = schedule, float(max_norm)
        for key in self.MOMENTS:
            setattr(self, key, [torch.zeros_like(p) for p in self.params])
        self.count = 0

    def clip(self, grads: Sequence[torch.Tensor]):
        """Returns (clipped grads, global norm as a 0-d tensor)."""
        norm = torch.stack([torch.sum(g * g) for g in grads]).sum().sqrt()
        keep = norm < self.max_norm
        scaled = torch._foreach_div(list(grads), norm)
        torch._foreach_mul_(scaled, self.max_norm)
        return [torch.where(keep, g, s) for g, s in zip(grads, scaled)], norm

    def _direction(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
        grads, norm = self.clip(grads)
        updates = self._direction(grads)
        lr = _f32(self.schedule(self.count))
        torch._foreach_mul_(updates, -lr)
        torch._foreach_add_(self.params, updates)
        self.count += 1
        return {"grad_norm": norm, "lr": lr}

    def _inner_state(self, count: np.ndarray, trees: Dict[str, Dict]) -> Dict:
        """The optax state of ``inner`` from the count and the moments'
        flax trees."""
        raise NotImplementedError

    def _moment_trees(self, inner: Mapping) -> Dict[str, Mapping]:
        raise NotImplementedError

    def _count(self, inner: Mapping) -> int:
        raise NotImplementedError


class Adam(_Clipped):
    MOMENTS = ("mu", "nu")

    def __init__(self, params: Sequence[torch.Tensor], schedule: Callable[[int], float],
                 max_norm: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, schedule, max_norm)
        self.b1, self.b2, self.eps = b1, b2, eps

    def _direction(self, grads):
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)
        count = np.float32(self.count + 1)
        mu_hat = torch._foreach_div(self.mu, _f32(1 - np.float32(b1) ** count))
        nu_hat = torch._foreach_div(self.nu, _f32(1 - np.float32(b2) ** count))
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, self.eps)
        return torch._foreach_div(mu_hat, denom)

    def _inner_state(self, count, trees):
        return {"0": dict(count=count, **trees), "1": {"count": count.copy()}}

    def _moment_trees(self, inner):
        return {key: inner["0"][key] for key in self.MOMENTS}

    def _count(self, inner):
        return int(np.asarray(inner["0"]["count"]))


class SGD(_Clipped):
    MOMENTS = ("trace",)

    def __init__(self, params: Sequence[torch.Tensor], schedule: Callable[[int], float],
                 max_norm: float, momentum: float, weight_decay: float):
        super().__init__(params, schedule, max_norm)
        self.momentum, self.weight_decay = float(momentum), float(weight_decay)

    def _direction(self, grads):
        grads = torch._foreach_add(grads, self.params, alpha=self.weight_decay)
        torch._foreach_mul_(self.trace, self.momentum)
        torch._foreach_add_(self.trace, grads)
        return [t.clone() for t in self.trace]

    def _inner_state(self, count, trees):
        return {"0": {}, "1": {"0": dict(trees), "1": {"count": count}}}

    def _moment_trees(self, inner):
        return {"trace": inner["1"]["0"]["trace"]}

    def _count(self, inner):
        return int(np.asarray(inner["1"]["1"]["count"]))


class Adadelta(_Clipped):
    MOMENTS = ("e_g", "e_x")

    def __init__(self, params: Sequence[torch.Tensor], schedule: Callable[[int], float],
                 max_norm: float, rho: float, eps: float):
        super().__init__(params, schedule, max_norm)
        self.rho, self.eps = float(rho), float(eps)

    def _direction(self, grads):
        rho = self.rho
        torch._foreach_mul_(self.e_g, rho)
        torch._foreach_addcmul_(self.e_g, grads, grads, value=1 - rho)
        num = torch._foreach_add(self.e_x, self.eps)
        torch._foreach_sqrt_(num)
        den = torch._foreach_add(self.e_g, self.eps)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(num, den)
        updates = torch._foreach_mul(num, grads)
        torch._foreach_mul_(self.e_x, rho)
        torch._foreach_addcmul_(self.e_x, updates, updates, value=1 - rho)
        return updates

    def _inner_state(self, count, trees):
        return {"0": {}, "1": dict(trees), "2": {"count": count}}

    def _moment_trees(self, inner):
        return {key: inner["1"][key] for key in self.MOMENTS}

    def _count(self, inner):
        return int(np.asarray(inner["2"]["count"]))


def opt_state_to_optax(opt: _Clipped, names: Sequence[str],
                       frozen: Optional[Mapping[str, torch.Tensor]] = None) -> Dict:
    """``opt``'s state as the optax state dict; ``names`` are the port
    names of ``opt.params``, in order; ``frozen`` (port name -> tensor)
    adds zero moments of that shape."""
    count = np.asarray(opt.count, np.int32)
    extra = list((frozen or {}).items())
    trees = {key: flax_tree(list(zip(names, getattr(opt, key)))
                            + [(k, torch.zeros_like(t)) for k, t in extra])
             for key in opt.MOMENTS}
    return {"0": {"inner_state": {}}, "1": {"0": {}, "1": opt._inner_state(count, trees)}}


def opt_state_from_optax(opt: _Clipped, names: Sequence[str], state: Mapping,
                         frozen: Sequence[str] = ()) -> None:
    """Loads an optax state dict (``opt_state_to_optax``'s layout) into
    ``opt`` in place; every one of ``names`` must have its moments, and
    only the ``frozen`` names may come besides them (and are skipped)."""
    inner = state["1"]["1"]
    for key, tree in opt._moment_trees(inner).items():
        tensors = from_flax(tree)
        extra = set(tensors) - set(names) - set(frozen)
        if not set(names) <= set(tensors) or extra:
            raise ValueError(f"optimizer state {key}: parameters "
                             f"{sorted((set(tensors) ^ set(names)) - set(frozen))[:4]} differ")
        with torch.no_grad():
            for name, dst in zip(names, getattr(opt, key)):
                dst.copy_(tensors[name])
    opt.count = opt._count(inner)


def build_optimizer(opt, schedule: Callable[[int], float],
                    params: Sequence[torch.Tensor]) -> _Clipped:
    """``opt.optimizer`` (adam, sgd or adadelta) over ``params``."""
    if opt.optimizer == "adam":
        return Adam(params, schedule, opt.grad_clip)
    if opt.optimizer == "sgd":
        return SGD(params, schedule, opt.grad_clip, opt.sgd_momentum, opt.sgd_weight_decay)
    if opt.optimizer == "adadelta":
        return Adadelta(params, schedule, opt.grad_clip, opt.rho, opt.eps)
    raise ValueError(f"unknown optimizer {opt.optimizer}")
