"""LwF, Learning without Forgetting (mirrors
``mrn_tpu/train/learners/lwf.py``): from task 1 on, the loss adds the
distillation of the old network (the previous task's reloaded best,
``BaseLearner.after_task``) on the same batch, ``3 * KD(T=2) + CLF``.

The old network runs in eval mode (running BatchNorm statistics; the fused
inference Block on the card) without gradients, its parameters cast to
bfloat16 under the bf16 policy and its statistics float32; its output is
taken to float32.  KD covers the old classes ``[:, 0:known]`` of the
``[B * T, C]`` logits (start index 0 for CTC); the old network keeps its
own class count.
"""

from __future__ import annotations

from mrn_tpu_torch.ops.losses import kd_loss
from mrn_tpu_torch.train.learners.base import BaseLearner
from mrn_tpu_torch.train.steps import recognition_loss

__all__ = ["LwF", "LwFMixin", "T"]

T = 2.0
LAMDA = 3.0


class LwFMixin:
    """KD on the old network, shared by LwF and WA."""

    kd_weight = LAMDA

    def train_aux(self):
        if self._cur_task == 0 or self._old_model is None:
            return None
        return self._old_model

    def _old_forward(self, batch, old):
        return self._eval_forward(old, batch["image"])["predict"].float()

    def loss_fn(self, params, batch, aux=None):
        preds = self._apply_train(params, batch)
        loss_clf = recognition_loss(preds, batch)
        if aux is None:
            return loss_clf, {}
        old = self._old_forward(batch, aux)
        known = self._known_classes
        loss_kd = kd_loss(preds.reshape(-1, preds.shape[-1])[:, :known],
                          old.reshape(-1, old.shape[-1])[:, :known], T)
        return self.kd_weight * loss_kd + loss_clf, {"kd": loss_kd.detach()}


class LwF(LwFMixin, BaseLearner):
    pass
