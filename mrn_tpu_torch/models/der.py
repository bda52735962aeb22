"""DERNet: dynamically expandable representation (mirrors
``mrn_tpu/models/der.py``): ``n_experts`` extractors whose features
concatenate to ``[B, T, n * hidden]``, and two heads:

- CTC: a main ``fc`` over the concatenation and an ``aux_fc`` over the
  newest extractor's features;
- Attn: ``prediction``, a decoder over the concatenation (input ``n *
  hidden``) whose generator is ``fc`` (``[hidden, C]``), and
  ``aux_prediction``, a decoder over the newest features whose generator
  is ``aux_fc``; teacher-forced on ``text`` under ``is_train`` (which
  defaults to ``train``), else greedy from its [SOS] column.

The extractors are an ``nn.ModuleList`` of the port's ``Extractor`` run
one after another (the JAX package stacks them on a leading axis under
``vmap``; ``bridge.der_state`` and ``bridge.to_flax`` map the two
layouts).  In the DER learner's training step the frozen extractors run
in eval mode without gradients and only the newest trains: their features
come in as ``frozen`` and ``forward`` runs the newest alone.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from mrn_tpu_torch.models.attention import AttentionDecoder
from mrn_tpu_torch.models.common import Dense
from mrn_tpu_torch.models.composer import Extractor

__all__ = ["DERNet"]


class DERNet(nn.Module):

    def __init__(self, n_experts: int, num_classes: int, prediction: str = "CTC",
                 transformation: str = "None", feature_extraction: str = "SVTR",
                 sequence_modeling: str = "None", input_channel: int = 4,
                 output_channel: int = 512, hidden_size: int = 256,
                 img_size: Tuple[int, int] = (32, 256), svtr: Optional[Mapping] = None,
                 num_fiducial: int = 20, batch_max_length: int = 25):
        super().__init__()
        self.n_experts = n_experts
        self.extractors = nn.ModuleList(
            Extractor(transformation, feature_extraction, sequence_modeling, input_channel,
                      output_channel, hidden_size, img_size, svtr,
                      num_fiducial=num_fiducial)
            for _ in range(n_experts))
        self.attn = prediction == "Attn"
        if self.attn:
            self.fc = Dense(hidden_size, num_classes)
            self.prediction = AttentionDecoder(n_experts * hidden_size, hidden_size,
                                               num_classes, batch_max_length)
            self.aux_prediction = AttentionDecoder(hidden_size, hidden_size, num_classes,
                                                   batch_max_length)
        else:
            self.fc = Dense(n_experts * hidden_size, num_classes)
        self.aux_fc = Dense(hidden_size, num_classes)

    def forward(self, image: torch.Tensor, text: Optional[torch.Tensor] = None,
                train: bool = False, is_train: Optional[bool] = None,
                frozen: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """``{"logits", "aux_logits", "features"}``; every extractor runs in
        mode ``train``, or, given the first ``n - 1`` extractors' features
        ``frozen`` [n - 1, B, T, H], the newest alone.  ``text`` (Attn): as
        ``Recognizer.forward``'s."""
        if frozen is None:
            feats = torch.stack([e(image, train) for e in self.extractors])
        else:
            feats = torch.cat([frozen.to(image.dtype),
                               self.extractors[-1](image, train)[None]])
        return self.heads(feats, text, train if is_train is None else is_train)

    def heads(self, feats: torch.Tensor, text: Optional[torch.Tensor] = None,
              is_train: bool = False) -> Dict[str, torch.Tensor]:
        """Main and aux predictions from stacked features [I, B, T, H]."""
        i, b, t, h = feats.shape
        concat = feats.permute(1, 2, 0, 3).reshape(b, t, i * h)
        if not self.attn:
            return {"logits": self.fc(concat), "aux_logits": self.aux_fc(feats[-1]),
                    "features": concat}
        if text is None:
            raise ValueError("the Attn decoders need text: [SOS] and, teacher-forced, the "
                             "characters")
        return {"logits": self.prediction(concat, text, self.fc, is_train=is_train),
                "aux_logits": self.aux_prediction(feats[-1], text, self.aux_fc,
                                                  is_train=is_train),
                "features": concat}
