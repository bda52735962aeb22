"""WA, Weight Aligning (mirrors ``mrn_tpu/train/learners/wa.py``): LwF's
distillation at weight 2, and the new classes' fc columns rescaled by
``gamma`` = the old columns' mean norm over the new columns'
(``models.surgery.weight_align``) on the float32 masters.

JAX's sequencing is kept: the align at the end of
``_update_representation`` is overwritten when ``test`` reloads the best
checkpoint, the campaign reads its matrix row from that reloaded
(unaligned) network, and ``after_task`` aligns the reloaded best, which
becomes the old network and the next task's start.  A ``start_task``
replay aligns in ``after_task`` too (the JAX learner does not, so a
replayed WA run there starts its next task unaligned).
"""

from __future__ import annotations

import torch

from mrn_tpu_torch.models.surgery import weight_align
from mrn_tpu_torch.train.learners.base import BaseLearner
from mrn_tpu_torch.train.learners.lwf import LwFMixin

__all__ = ["WA", "align_fc"]


def align_fc(learner, fc) -> float:
    """``weight_align`` of the Dense ``fc`` (a module of ``learner.model``)
    in place over the ``_total_classes - _known_classes`` new columns;
    logs and returns gamma."""
    tree = {"fc": {"kernel": fc.kernel.detach().cpu().numpy(),
                   "bias": fc.bias.detach().cpu().numpy()}}
    tree, gamma = weight_align(tree, learner._total_classes - learner._known_classes)
    with torch.no_grad():
        fc.kernel.copy_(torch.as_tensor(tree["fc"]["kernel"]))
    learner.log.write(f"alignweights,gamma={gamma}\n")
    return gamma


class WA(LwFMixin, BaseLearner):

    kd_weight = 2.0

    def __init__(self, opt, device=None):
        super().__init__(opt, device)
        self.taski = 0

    def _align(self) -> float:
        return align_fc(self, self.model.fc)

    def _update_representation(self, taski, train_loader, valid_loader):
        self.taski = taski
        super()._update_representation(taski, train_loader, valid_loader)
        self._align()

    def _after_resume(self, taski, train_loader):
        self.taski = taski

    def after_task(self):
        if self.taski > 0:
            self._align()
        super().after_task()
