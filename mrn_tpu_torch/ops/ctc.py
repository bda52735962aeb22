"""CTC loss with the reference's ``torch.nn.CTCLoss`` semantics (mirrors
``mrn_tpu/ops/ctc.py``):

- blank id 0 (the converter pins [CTCblank] at index 0);
- 'mean' reduction: the mean over the batch of (per-sample loss / target
  length), the length floored at 1;
- zero_infinity: an infeasible alignment (T < length + repeats) contributes
  0 loss and 0 gradient.

The JAX package computes CTC in XLA; here it is ``F.ctc_loss`` on the
float32 ``log_softmax`` of the logits, laid out ``[T, B, C]``.

``ctc_loss_per_sample`` is the evaluation's form: each sample's negative
log-likelihood, ``inf`` for an infeasible alignment.  (The JAX package's
optax CTC gives a large finite value there, about 1e5, which its
validation then averages in; the port's validation zeroes it.  SVTR at
imgW 256 has T = 64 > 2 * batch_max_length, so no label is infeasible.)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["ctc_loss", "ctc_loss_per_sample"]


def ctc_loss_per_sample(logits: torch.Tensor, labels: torch.Tensor,
                        label_lengths: torch.Tensor, blank_id: int = 0) -> torch.Tensor:
    """logits [B, T, C] unnormalised (every step valid); labels [B, N];
    label_lengths [B].  Per-sample negative log-likelihood [B], float32."""
    b, t, _ = logits.shape
    log_probs = F.log_softmax(logits.float(), dim=-1).transpose(0, 1)
    input_lengths = torch.full((b,), t, dtype=torch.long, device=logits.device)
    return F.ctc_loss(log_probs, labels.long(), input_lengths, label_lengths.long(),
                      blank=blank_id, reduction="none", zero_infinity=False)


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor,
             label_lengths: torch.Tensor, blank_id: int = 0) -> torch.Tensor:
    """logits [B, T, C] unnormalised (every step valid); labels [B, N]
    (padded past each length with any id); label_lengths [B].  Scalar."""
    b, t, _ = logits.shape
    log_probs = F.log_softmax(logits.float(), dim=-1).transpose(0, 1)
    input_lengths = torch.full((b,), t, dtype=torch.long, device=logits.device)
    lengths = label_lengths.long()
    per_sample = F.ctc_loss(log_probs, labels.long(), input_lengths, lengths,
                            blank=blank_id, reduction="none", zero_infinity=True)
    return (per_sample / lengths.clamp(min=1).float()).mean()
