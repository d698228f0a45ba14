"""Linear-ReLU stacks (the HPD index network and the colour decoder).

Weights keep the JAX package's (in, out) layout, so a layer is
``x @ w + b`` and the kernels read the HPD head as (H, T). Initialization
matches torch ``nn.Linear`` in distribution: weights and biases
~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)), which :func:`init_layers` draws from a
key as the JAX package's ``init_mlp`` does, bit for bit.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from ..ops.precision import pdot
from ..utils import prng


def init_layers(key: np.ndarray, widths: Sequence[int]) -> List[Tuple[np.ndarray, np.ndarray]]:
    """[(w (in, out), b (out,))] of float32 numpy arrays, drawn as the JAX
    package's ``init_mlp(key, widths)``: each layer splits (key, wk, bk) and
    takes U(-bound, bound) with ``bound = 1 / sqrt(fan_in)`` in float32."""
    layers = []
    for fan_in, fan_out in zip(widths[:-1], widths[1:]):
        key, wk, bk = prng.split(key, 3)
        bound = np.float32(1.0) / np.sqrt(np.float32(fan_in))
        layers.append((prng.uniform(wk, (fan_in, fan_out), -bound, bound),
                       prng.uniform(bk, (fan_out,), -bound, bound)))
    return layers


class MLP(nn.Module):
    def __init__(self, layers: Sequence[Tuple[Any, Any]], device=None):
        """``layers``: [(w (in, out), b (out,))] float32 numpy arrays, as
        :func:`init_layers` draws them; copied onto ``device``."""
        super().__init__()
        self.weights = nn.ParameterList()
        self.biases = nn.ParameterList()
        for w, b in layers:
            self.weights.append(nn.Parameter(torch.from_numpy(np.array(w, np.float32)).to(device)))
            self.biases.append(nn.Parameter(torch.from_numpy(np.array(b, np.float32)).to(device)))

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
