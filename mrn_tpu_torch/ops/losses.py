"""Classification losses (mirrors ``mrn_tpu/ops/losses.py``):

- ``cross_entropy_dense``: plain mean CE over int targets (the MRN router's
  ``taski_criterion``);
- ``cross_entropy_ignore``: ``CrossEntropyLoss(ignore_index=[PAD])`` for the
  Attn head: the sum over kept positions over their count;
- ``kd_loss``: LwF's and WA's distillation loss, soft-target cross entropy
  at a temperature, summed over classes and averaged over rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["cross_entropy_dense", "cross_entropy_ignore", "kd_loss"]


def cross_entropy_dense(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """logits [B, C]; targets [B] int.  Mean CE over all rows."""
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(1, targets.long()[:, None])[:, 0].mean()


def cross_entropy_ignore(logits: torch.Tensor, targets: torch.Tensor,
                         ignore_index: int) -> torch.Tensor:
    """logits [..., C]; targets [...] int.  Mean CE over the positions whose
    target is not ``ignore_index`` (0 when there are none)."""
    logp = F.log_softmax(logits.reshape(-1, logits.shape[-1]), dim=-1)
    targets = targets.reshape(-1).long()
    picked = logp.gather(1, targets[:, None])[:, 0]
    keep = (targets != ignore_index).to(logp.dtype)
    return -(picked * keep).sum() / keep.sum().clamp(min=1.0)


def kd_loss(pred_logits: torch.Tensor, soft_logits: torch.Tensor,
            temperature: float = 2.0) -> torch.Tensor:
    """``-(softmax(soft / T) * log_softmax(pred / T)).sum() / rows`` over
    [rows, classes] logits (the caller picks the known classes)."""
    pred = F.log_softmax(pred_logits / temperature, dim=1)
    soft = F.softmax(soft_logits / temperature, dim=1)
    return -(soft * pred).sum() / pred.shape[0]
