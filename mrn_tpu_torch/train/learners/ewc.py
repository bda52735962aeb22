"""EWC, Elastic Weight Consolidation (mirrors
``mrn_tpu/train/learners/ewc.py``): after each task, the diagonal Fisher
of the recognition loss over ``fisher_num_iter`` batches of the task's
stream (squared gradients, train mode with DropPath from the learner's
generator, the BatchNorm statistics left as they were, divided by the
batch count and clamped at 1e-4), blended ``0.5 * old + 0.5 * new`` over
the shared prefix of grown parameters, with the parameters at that point
as the mean; from task 1 on the loss is
``CLF + 1000 * sum F * (theta[:len theta*] - theta*)^2 / 2`` on the
float32 masters.  Fisher, mean and parameters pair by name; ``_head``
takes the leading part of every axis of a grown leaf (the output columns
of the ``[in, out]`` fc kernel, the bias's leading entries).  The Fisher
and mean enter the step flattened into one vector each, so the penalty is
a few launches a step rather than a few per parameter.  EWC keeps no old network.

Each task's Fisher and mean are written beside its best checkpoint
(``{lan}_{taski}_ewc.msgpack``: ``params`` the mean, ``fisher`` the
Fisher, flax layout), and a ``start_task`` replay loads them
(``_after_resume``), so a split run goes on with the unbroken run's
penalty.  Without that file (a checkpoint of the JAX learner) the replay
recomputes the Fisher from the best checkpoint on the task's stream, as
the JAX learner does; the unbroken run's Fisher came from the last
iterate and from the batches after the loop's, so that one differs.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from mrn_tpu_torch.bridge import flax_tree, from_flax
from mrn_tpu_torch.train.checkpoint import load_model, save_model
from mrn_tpu_torch.train.learners.base import BaseLearner
from mrn_tpu_torch.train.steps import recognition_loss

__all__ = ["EWC"]

LAMDA = 1000.0
FISHERMAX = 0.0001
ALPHA = 0.5
FISHER_NUM_ITER = 5000


def _head(ref: torch.Tensor) -> tuple:
    """The index of the leading part of ``ref``'s shape in a grown leaf
    (JAX's ``_slice_like``)."""
    return tuple(slice(0, n) for n in ref.shape)


class EWC(BaseLearner):

    def __init__(self, opt, device=None):
        super().__init__(opt, device)
        self.fisher: Optional[Dict[str, torch.Tensor]] = None
        self.mean: Optional[Dict[str, torch.Tensor]] = None

    def after_task(self):
        self._known_classes = self._total_classes

    def train_aux(self):
        """The Fisher and mean flattened into one vector each, in the
        mean's order: the penalty is then a few launches a step, not a
        few per parameter."""
        if self.fisher is None:
            return None
        heads = [(k, _head(m)) for k, m in self.mean.items()]
        return (heads, torch.cat([self.fisher[k].reshape(-1) for k, _ in heads]),
                torch.cat([self.mean[k].reshape(-1) for k, _ in heads]))

    def loss_fn(self, params, batch, aux=None):
        loss_clf = recognition_loss(self._apply_train(params, batch), batch)
        if aux is None:
            return loss_clf, {}
        heads, fisher, mean = aux
        theta = torch.cat([params[k][head].reshape(-1) for k, head in heads])
        penalty = torch.sum(fisher * (theta - mean) ** 2) / 2.0
        return loss_clf + LAMDA * penalty, {"ewc": penalty.detach()}

    def _train(self, taski, train_loader, valid_loader):
        super()._train(taski, train_loader, valid_loader)
        self._update_fisher(train_loader)

    def _fisher_path(self, taski: int) -> str:
        return self._best_path(taski).replace("_best_score.msgpack", "_ewc.msgpack")

    def _after_resume(self, taski, train_loader):
        path = self._fisher_path(taski)
        if os.path.exists(path):
            payload = load_model(path)
            self.mean = {k: v.to(self.device) for k, v in from_flax(payload["params"]).items()}
            self.fisher = {k: v.to(self.device) for k, v in from_flax(payload["fisher"]).items()}
            self.log.write(f"Task {taski} load EWC state from {path}.\n")
            return
        if taski == 0 and not getattr(train_loader, "loaders", None):
            train_loader.get_dataset(taski, memory=None)
        self._update_fisher(train_loader)

    def _update_fisher(self, train_loader) -> None:
        new = self.get_fisher_diagonal(train_loader)
        if self.fisher is not None:
            for k, old in self.fisher.items():
                new[k][_head(old)] = ALPHA * old + (1 - ALPHA) * new[k][_head(old)]
        self.fisher = new
        self.mean = {k: p.detach().clone() for k, p in self.model.named_parameters()}
        save_model(self._fisher_path(self._cur_task), flax_tree(self.mean.items()), {},
                   extra={"fisher": flax_tree(self.fisher.items())})

    def get_fisher_diagonal(self, train_loader) -> Dict[str, torch.Tensor]:
        """Mean squared gradients of the recognition loss over
        ``fisher_num_iter`` batches of ``train_loader``, clamped."""
        num_iter = int(self.opt.get("fisher_num_iter", FISHER_NUM_ITER))
        params = dict(self.model.named_parameters())
        fisher = {k: torch.zeros_like(p) for k, p in params.items()}
        stats = {k: b.clone() for k, b in self.model.named_buffers()}
        try:
            for _ in range(num_iter):
                images, labels = train_loader.get_batch()[:2]
                batch = self._encode_batch(images, labels)
                loss = recognition_loss(self._apply_train(params, batch), batch)
                grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                            materialize_grads=True)
                for f, g in zip(fisher.values(), grads):
                    f.add_(g * g)
        finally:
            # the JAX step's Fisher pass keeps no BatchNorm update
            with torch.no_grad():
                for k, b in self.model.named_buffers():
                    b.copy_(stats[k])
        return {k: torch.clamp(f / num_iter, max=FISHERMAX) for k, f in fisher.items()}
