"""LSTM sequence modelling in the JAX package's form (mirrors
``mrn_tpu/models/lstm.py``), not ``nn.LSTM``: the rounding points are the
JAX package's, and no cuDNN RNN path runs in bfloat16.

- The input projections of all timesteps are one product
  (``[2, B, T, in] x [2, 4H, in]``), both biases added.
- One T-step loop runs both directions together: the carries are
  ``[2, B, H]`` and each step's recurrence is one batched product.
- Gate order i, f, g, o (torch's); each direction's weights are named
  ``fwd``/``bwd`` -> ``w_ih [4H, in]``, ``w_hh [4H, H]``, ``b_ih``,
  ``b_hh``, already in torch's layout, so they bridge by name.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from mrn_tpu_torch.models.common import Dense

__all__ = ["BidirectionalLSTM", "TorchLSTM", "lstm_cell_step"]


def _gates(gates: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-activations [..., 4H] (order i, f, g, o) and the cell -> (h, c)."""
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def lstm_cell_step(gates_x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                   w_hh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step: ``gates_x`` [B, 4H] is the input projection with both
    biases, ``w_hh`` [4H, H] in torch's layout."""
    return _gates(gates_x + h @ w_hh.T, c)


class _LSTMParams(nn.Module):
    """One direction's weights in torch's layout."""

    def __init__(self, in_size: int, hidden: int):
        super().__init__()
        self.w_ih = nn.Parameter(torch.zeros(4 * hidden, in_size))
        self.w_hh = nn.Parameter(torch.zeros(4 * hidden, hidden))
        self.b_ih = nn.Parameter(torch.zeros(4 * hidden))
        self.b_hh = nn.Parameter(torch.zeros(4 * hidden))


class TorchLSTM(nn.Module):
    """``nn.LSTM(bidirectional=True, batch_first=True)``: [B, T, in] ->
    [B, T, 2H] (forward, then backward, halves)."""

    def __init__(self, in_size: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.fwd = _LSTMParams(in_size, hidden)
        self.bwd = _LSTMParams(in_size, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        w_ih = torch.stack([self.fwd.w_ih, self.bwd.w_ih])               # [2, 4H, in]
        w_hh_t = torch.stack([self.fwd.w_hh, self.bwd.w_hh]).transpose(1, 2)  # [2, H, 4H]
        bias = torch.stack([self.fwd.b_ih + self.fwd.b_hh,
                            self.bwd.b_ih + self.bwd.b_hh])              # [2, 4H]
        x2 = torch.stack([x, torch.flip(x, dims=(1,))])                  # [2, B, T, in]
        gates_x = torch.einsum("dbti,dgi->tdbg", x2, w_ih) + bias[:, None, :]
        h = c = x.new_zeros(2, b, self.hidden)
        outs = []
        for step in range(t):
            h, c = _gates(gates_x[step] + torch.bmm(h, w_hh_t), c)
            outs.append(h)
        out = torch.stack(outs, dim=2)                                   # [2, B, T, H]
        return torch.cat([out[0], torch.flip(out[1], dims=(1,))], dim=-1)


class BidirectionalLSTM(nn.Module):
    """BiLSTM + ``linear`` (2H -> out)."""

    def __init__(self, in_size: int, hidden: int, out_size: int):
        super().__init__()
        self.rnn = TorchLSTM(in_size, hidden)
        self.linear = Dense(2 * hidden, out_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(self.rnn(x))
