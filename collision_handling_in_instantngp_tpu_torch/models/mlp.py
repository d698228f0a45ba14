"""Linear-ReLU stacks (the HPD index network and the colour decoder).

Weights keep the JAX package's (in, out) layout, so a layer is
``x @ w + b`` and the kernels read the HPD head as (H, T). Initialization
matches torch ``nn.Linear`` in distribution: weights and biases
~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from ..ops.precision import pdot


class MLP(nn.Module):
    def __init__(
        self,
        widths: Sequence[int],
        *,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        self.weights = nn.ParameterList()
        self.biases = nn.ParameterList()
        for fan_in, fan_out in zip(widths[:-1], widths[1:]):
            bound = 1.0 / math.sqrt(fan_in)
            # drawn on the CPU so a seed gives the same weights on any device
            w = torch.empty(fan_in, fan_out).uniform_(-bound, bound, generator=generator)
            b = torch.empty(fan_out).uniform_(-bound, bound, generator=generator)
            self.weights.append(nn.Parameter(w.to(device)))
            self.biases.append(nn.Parameter(b.to(device)))

    def layers(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        return list(zip(self.weights, self.biases))

    def forward(
        self,
        x: torch.Tensor,
        hidden_activation: str = "relu",
        final_activation: str = "none",
        precision: str = "highest",
    ) -> torch.Tensor:
        n = len(self.weights)
        for i, (w, b) in enumerate(self.layers()):
            x = pdot(x, w, precision) + b
            if i < n - 1:
                if hidden_activation == "relu":
                    x = F.relu(x)
                elif hidden_activation == "leaky_relu":
                    x = F.leaky_relu(x, negative_slope=0.01)
                else:
                    raise ValueError(hidden_activation)
        if final_activation == "softmax":
            return torch.softmax(x, dim=-1)
        if final_activation == "sigmoid":
            return torch.sigmoid(x)
        if final_activation != "none":
            raise ValueError(final_activation)
        return x
