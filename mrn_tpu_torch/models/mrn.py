"""MRNNet: per-task expert recognizers + DM-Router (mirrors
``mrn_tpu/models/mrn.py``), with the hard per-sample expert pick for serving
(``is_train=False``) and the soft combination for router training
(``is_train=True``).

The experts are an ``nn.ModuleList`` run one after another (the JAX package
stacks them on a leading axis under ``vmap``).  An SVTR expert's Blocks are
one fused-Block launch each, so a request costs ``n_experts * 12`` Block
launches; a TRBA expert warps once (one grid_sample launch) and decodes
greedily with its own ``class_counts[i]`` (JAX ``vmap``s the count), its
logits ``[B, batch_max_length + 1, C]``.  Load-bearing details kept from
the reference:

- old experts' logits are padded to the current class count WITH ONES
  (columns ``c >= class_counts[i]`` become 1.0), not zeros;
- each sample takes the expert with the largest route score (argmax, first
  index on ties);
- in router training the combination is ``index = softmax(scores)`` (the
  reference's ``beta`` is 1) and the returned ``index`` IS that softmax
  (the learner's router CE is taken on it); the logits are
  ``einsum("ibtc,bi->btc")`` in float32 over the ones-padded expert logits.

The experts always run in eval mode and without gradients: every expert is
frozen while the router trains.  Router training over Attn experts (their
teacher-forced decoders) is not ported.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from mrn_tpu_torch.models.common import Dense
from mrn_tpu_torch.models.composer import Recognizer, sequence_length
from mrn_tpu_torch.models.router import DMRouter

__all__ = ["MRNNet"]


class MRNNet(nn.Module):
    """Routed ensemble; ``class_counts[i]`` is expert i's true vocabulary
    size within the padded ``num_classes`` space."""

    def __init__(self, n_experts: int, num_classes: int,
                 class_counts: Sequence[int], prediction: str = "CTC",
                 transformation: str = "None", feature_extraction: str = "SVTR",
                 sequence_modeling: str = "None", input_channel: int = 4,
                 output_channel: int = 512, hidden_size: int = 256,
                 img_size: Tuple[int, int] = (32, 256),
                 svtr: Optional[Mapping] = None, num_fiducial: int = 20,
                 batch_max_length: int = 25):
        super().__init__()
        if len(class_counts) != n_experts:
            raise ValueError(f"{len(class_counts)} class counts for {n_experts} experts")
        self.n_experts, self.num_classes = n_experts, num_classes
        self.class_counts = tuple(int(c) for c in class_counts)
        self.hidden_size = hidden_size
        self.experts = nn.ModuleList(
            Recognizer(num_classes, prediction, transformation,
                       feature_extraction, sequence_modeling, input_channel,
                       output_channel, hidden_size, img_size, svtr,
                       num_fiducial=num_fiducial, batch_max_length=batch_max_length)
            for _ in range(n_experts))
        self.attn = prediction == "Attn"
        self.patch = sequence_length(feature_extraction, img_size[1])
        self.dm_router = DMRouter(hidden_size, hidden_size * 2, self.patch,
                                  n_experts)
        self.channel_route = Dense(n_experts * hidden_size, n_experts)
        self.route = Dense(self.patch, 1)

    def _route_scores(self, features: torch.Tensor) -> torch.Tensor:
        """features [I, B, T, H] -> scores [B, I]."""
        route_info = self.dm_router(features.transpose(0, 1))   # [B, I, T, H]
        b = route_info.shape[0]
        # rearrange 'b i t h -> b t (i h)'
        route_info = route_info.transpose(1, 2).reshape(
            b, self.patch, self.n_experts * self.hidden_size)
        route_info = self.channel_route(route_info).transpose(1, 2)  # [B, I, T]
        return self.route(route_info)[..., 0]

    def _ones_pad(self, logits: torch.Tensor) -> torch.Tensor:
        """logits [I, B, T, C]: column c >= class_counts[i] becomes 1.0."""
        counts = torch.tensor(self.class_counts, device=logits.device)
        col = torch.arange(self.num_classes, device=logits.device)
        keep = (col[None, :] < counts[:, None])[:, None, None, :]
        return torch.where(keep, logits, torch.ones((), dtype=logits.dtype,
                                                    device=logits.device))

    def forward(self, image: torch.Tensor, text: Optional[torch.Tensor] = None,
                is_train: bool = False) -> Dict[str, torch.Tensor]:
        """Returns {"logits" [B, T, C], "index", "aux_logits": None}: the
        expert pick [B] (``is_train=False``) or the routing weights [B, I]
        (``is_train=True``).  ``text`` (Attn experts): the [SOS] column."""
        if self.attn and is_train:
            raise NotImplementedError("router training over Attn experts (teacher-forced "
                                      "decoders) is not ported")
        with torch.no_grad():  # frozen experts: the JAX learner's stop_gradient
            outs = [expert(image, text, class_count=count)
                    for expert, count in zip(self.experts, self.class_counts)]
            preds = torch.stack([o["predict"] for o in outs])      # [I, B, T, C]
            features = torch.stack([o["feature"] for o in outs])   # [I, B, T, H]
        scores = self._route_scores(features)
        padded = self._ones_pad(preds)
        if is_train:
            index = torch.softmax(scores, dim=-1)  # [B, I]
            logits = torch.einsum("ibtc,bi->btc", padded.float(), index.float())
            return {"logits": logits, "index": index, "aux_logits": None}
        index = torch.argmax(scores, dim=-1)
        logits = padded[index, torch.arange(image.shape[0], device=index.device)]
        return {"logits": logits, "index": index, "aux_logits": None}
