"""DM-Router: dual-domain (spatial + channel) gating over stacked expert
features (mirrors ``mrn_tpu/models/router.py``).

Input [B, I, T, C] (I experts, T patches, C channels)::

  shortcut = x
  x = LN_C(x); x = proj_1 (C -> 2C); GELU
  x = reshape [B, I*T, 2C]; spatial gating: split (u, v); v = LN_C(v);
      v = Linear_{I*T}(v^T)^T; x = u * v
  x = proj_2 (C -> C); reshape back; x += shortcut
  x = reshape [B, I*C, T]; channel gating: v = LN_T(x);
      v = Linear_{I*C}(v^T)^T; x = x * v
  x = reshape back; proj_3 (C -> C); return x + shortcut

The three LayerNorms use eps 1e-5 (torch's default in the reference) and
the GELU is the exact erf.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mrn_tpu_torch.models.common import Dense, LayerNorm

__all__ = ["DMRouter"]


class DMRouter(nn.Module):
    def __init__(self, channel: int, d_ffn: int, patch: int, domain: int):
        super().__init__()
        self.channel, self.d_ffn, self.patch, self.domain = channel, d_ffn, patch, domain
        self.norm = LayerNorm(channel, eps=1e-5)
        self.proj_1 = Dense(channel, d_ffn)
        self.spatial_norm = LayerNorm(d_ffn // 2, eps=1e-5)
        self.spatial_proj = Dense(domain * patch, domain * patch)
        self.proj_2 = Dense(d_ffn // 2, channel)
        self.channel_norm = LayerNorm(patch, eps=1e-5)
        self.channel_proj = Dense(domain * channel, domain * channel)
        self.proj_3 = Dense(channel, channel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, i, t, c = x.shape
        if (i, t, c) != (self.domain, self.patch, self.channel):
            raise ValueError(f"DMRouter built for {(self.domain, self.patch, self.channel)}"
                             f", got {(i, t, c)}")
        shortcut = x
        h = F.gelu(self.proj_1(self.norm(x)))
        h = h.reshape(b, i * t, self.d_ffn)
        u, v = h.chunk(2, dim=-1)
        v = self.spatial_proj(self.spatial_norm(v).transpose(1, 2)).transpose(1, 2)
        h = self.proj_2(u * v).reshape(b, i, t, c) + shortcut
        g = h.reshape(b, i * c, t)
        v = self.channel_proj(self.channel_norm(g).transpose(1, 2)).transpose(1, 2)
        h = (g * v).reshape(b, i, t, c)
        return self.proj_3(h) + shortcut
