"""Additive-attention LSTM decoder, the Attn prediction head (mirrors
``mrn_tpu/models/attention.py``), greedy decoding only.

The decoder runs ``batch_max_length + 1`` steps.  Each step embeds the
previous pick (``char_embeddings``, OOV ids clamped to 0), attends over the
feature sequence, steps the LSTM cell and classifies with the ``generator``:
the parent Recognizer's growable ``fc``, passed to ``forward`` so that its
weights stay one leaf (``fc``) as in JAX.  ``class_count`` (an expert's true
vocabulary inside a padded class space) restricts both the OOV clamp and
the greedy argmax, so a padded expert decodes as its original-size self.

Greedy feedback amplifies a near-tie: a top-2 logit pair within float noise
can flip one pick, and every later step of that crop then differs.
Comparisons between two implementations therefore read a crop's steps up to
its first near-tie.  The teacher-forced path belongs to TRBA training,
which is not ported.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mrn_tpu_torch.models.common import Dense
from mrn_tpu_torch.models.lstm import lstm_cell_step

__all__ = ["AttentionCell", "AttentionDecoder"]


class AttentionCell(nn.Module):
    """i2h/h2h additive score, softmax over T, context + embedding -> LSTM
    cell."""

    def __init__(self, input_size: int, hidden: int, num_embeddings: int = 256):
        super().__init__()
        self.i2h = Dense(input_size, hidden, bias=False)
        self.h2h = Dense(hidden, hidden)
        self.score = Dense(hidden, 1, bias=False)
        self.w_ih = nn.Parameter(torch.zeros(4 * hidden, input_size + num_embeddings))
        self.w_hh = nn.Parameter(torch.zeros(4 * hidden, hidden))
        self.b_ih = nn.Parameter(torch.zeros(4 * hidden))
        self.b_hh = nn.Parameter(torch.zeros(4 * hidden))

    def forward(self, prev_h, prev_c, batch_H, batch_H_proj, char_emb):
        e = self.score(torch.tanh(batch_H_proj + self.h2h(prev_h)[:, None, :]))  # [B, T, 1]
        alpha = torch.softmax(e, dim=1)
        context = (alpha * batch_H).sum(dim=1)
        gates_x = torch.cat([context, char_emb], dim=1) @ self.w_ih.T + self.b_ih + self.b_hh
        return lstm_cell_step(gates_x, prev_h, prev_c, self.w_hh)


class AttentionDecoder(nn.Module):
    def __init__(self, input_size: int, hidden: int, num_classes: int,
                 batch_max_length: int = 25, num_char_embeddings: int = 256):
        super().__init__()
        self.hidden, self.num_classes = hidden, num_classes
        self.num_steps = batch_max_length + 1
        self.attention_cell = AttentionCell(input_size, hidden, num_char_embeddings)
        self.char_embeddings = nn.Parameter(torch.zeros(num_classes, num_char_embeddings))

    def forward(self, batch_H: torch.Tensor, text: torch.Tensor, generator: nn.Module,
                class_count: Optional[int] = None) -> torch.Tensor:
        """batch_H [B, T, input_size]; ``text`` [B, 1] or [B] whose first
        entry is the [SOS] id (the whole batch starts from it, as in JAX);
        returns the logits [B, num_steps, num_classes]."""
        if class_count is None:
            class_count = self.num_classes
        b = batch_H.shape[0]
        proj = self.attention_cell.i2h(batch_H)
        target = text.reshape(-1)[:1].to(torch.int64).expand(b)
        h = c = batch_H.new_zeros(b, self.hidden)
        outside = torch.arange(self.num_classes, device=batch_H.device) >= class_count
        steps = []
        for _ in range(self.num_steps):
            emb = self.char_embeddings[torch.where(target >= class_count, 0, target)]
            h, c = self.attention_cell(h, c, batch_H, proj, emb)
            logits = generator(h)
            target = logits.masked_fill(outside, float("-inf")).argmax(dim=1)
            steps.append(logits)
        return torch.stack(steps, dim=1)
