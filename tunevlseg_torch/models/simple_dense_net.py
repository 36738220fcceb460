"""SimpleDenseNet, the template's MNIST MLP, in the port.

Counterpart of `tunevlseg_tpu/models/simple_dense_net.py` (reference
src/models/components/simple_dense_net.py: Linear -> BatchNorm1d -> ReLU
three times, then a linear head), trained by `scripts/torch_train_mnist.py`.

The BatchNorm follows the JAX net's flax `nn.BatchNorm(momentum=0.9,
epsilon=1e-5)`, not torch's `BatchNorm1d`: in train mode it normalises with
the batch mean and the biased batch variance, and moves the running mean
and the running variance 0.1 of the way towards those same two, where
torch's moves the running variance towards the unbiased one. Parameters
and buffers convert from the JAX variables with
`convert.from_jax.simple_dense_net_state_dict`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tunevlseg_torch.nn.layers import Dense


# flax's momentum (the share of the old running value kept at each
# train-mode call) and epsilon, the JAX net's (torch BatchNorm1d's defaults)
MOMENTUM, EPS = 0.9, 1e-5


class FlaxBatchNorm1d(nn.Module):
    """flax `nn.BatchNorm(momentum=0.9, epsilon=1e-5)` over the feature axis
    of (B, C): weight / bias (flax `scale` / `bias`), buffers `running_mean`
    / `running_var` (flax `batch_stats` `mean` / `var`)."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            mean = x.mean(0)
            var = (x - mean).square().mean(0)            # biased, as flax's
            with torch.no_grad():
                self.running_mean.mul_(MOMENTUM).add_((1 - MOMENTUM) * mean)
                self.running_var.mul_(MOMENTUM).add_((1 - MOMENTUM) * var)
        return (x - mean) * torch.rsqrt(var + EPS) * self.weight + self.bias


class SimpleDenseNet(nn.Module):
    """(B, ...) inputs flattened to (B, input_size) -> (B, output_size)
    logits. `model.train()` normalises with batch statistics and updates
    the running ones in place; `model.eval()` uses the running ones."""

    def __init__(self, input_size: int = 784, lin1_size: int = 256,
                 lin2_size: int = 256, lin3_size: int = 256,
                 output_size: int = 10):
        super().__init__()
        widths = (input_size, lin1_size, lin2_size, lin3_size)
        for i in range(1, 4):
            setattr(self, f"lin{i}", Dense(widths[i - 1], widths[i]))
            setattr(self, f"bn{i}", FlaxBatchNorm1d(widths[i]))
        self.head = Dense(lin3_size, output_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for i in range(1, 4):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"lin{i}")(x)))
        return self.head(x)
