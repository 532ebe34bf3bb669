"""The precision a plain reference computes in: every weight is rounded once
to the configuration's compute dtype, and every product rounds its inputs to
it and accumulates in float32."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class Precision:
    """`dtype`: the compute dtype weights and product inputs round to."""

    dtype: torch.dtype = torch.float32

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        return w.float().to(self.dtype).float()

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype).float() if self.dtype != torch.float32 else x.float()
